"""The port's Godunov SPH and ADKE equations (``sph/gas_dynamics/gsph.py``,
``sph/gas_dynamics/basic.py``) and ``GSPHScheme`` / ``ADKEScheme``
against pysph_tpu's, float64 on the CPU, inputs seeded with numpy.

- ``GSPHGradients`` then ``GSPHAcceleration`` (one evaluation through
  the port's and the JAX ``SPHEvaluator`` at 1e-10 of ``max|ref|``, at t
  = 0.3 and dt = 1e-3) on a jittered box periodic in x and y and on a
  jittered 1D tube whose spacing jumps by 8, h varied per particle, for
  every Riemann solver (``rsolver`` 0-10) and every branch: monotonicity
  0, 1 and 2, interpolation 0, 1 and 2, ``interface_zero`` off, the
  hybrid blend and the thermal conduction; on the kernel engine (on the
  CPU ``gsph_pair``'s plain version) and on the torch engine;
- ``SummationDensityADKE`` with its ``reduce`` and ``ADKEAccelerations``
  the same way, and each scheme's whole evaluation (``GSPHScheme``'s two
  ``update_nnps`` groups, ``ADKEScheme``'s density, its ``reduce`` and
  the plain summation density re-binned after);
- ADKE's density groups against an all-pairs sum of their formulas (h
  reset to h0, then h = k (g / rho)^eps h0 read by the plain summation
  density), for the port and for the JAX package, on the tube and on
  the box;
- the planner: both GSPH sets onto ``gsph_pair`` (taking t and dt), the
  ADKE sets onto ``gasd_pair`` and the plain density onto
  ``wcsph_pair``; a mixed set refused (logged); a 1D kernel and an
  unknown ``rsolver`` raising; the schemes' signatures and options as
  the JAX package's, and a JAX state carried across by ``from_numpy``
  (the 12 gradient props, ``logrho``, ``h0``, ``orig_idx``).

``tests/test_torch_gas_scheme_runs.py`` holds the examples' runs to the
JAX apps; ``tests/test_torch_gsph_cuda.py`` the kernels to their plain
versions on the card.
"""

import inspect
import logging

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import Gaussian as JaxGaussian
from pysph_tpu.base.utils import get_particle_array_gasd as jax_gasd_array
from pysph_tpu.sph import scheme as jax_scheme
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.gas_dynamics import basic as jax_basic
from pysph_tpu.sph.gas_dynamics import gsph as jax_gsph
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import (Gaussian, WendlandQuinticC2_1D)
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.sph import scheme
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.basic_equations import SummationDensity
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics import basic, gsph
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
CPU = dict(device='cpu', dtype=torch.float64)
T, DT = 0.3, 1e-3
GRADS = ('px', 'py', 'pz', 'ux', 'uy', 'uz', 'vx', 'vy', 'vz', 'wx', 'wy',
         'wz')


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _seeded(n, rng, dim):
    """Seeded gas props of n particles (those of the evaluations'
    reads)."""
    out = dict(rho=1.0 + 0.3 * rng.random(n), e=1.0 + rng.random(n),
               cs=0.5 + rng.random(n), div=0.5 * rng.normal(size=n),
               u=0.3 * rng.normal(size=n), m=None)
    out['p'] = 0.4 * out['rho'] * out['e']
    for c in 'xyz'[:dim]:
        out['grho' + c] = rng.normal(size=n)
    if dim > 1:
        out['v'] = 0.3 * rng.normal(size=n)
    for g in GRADS:
        if g[1] in 'xyz'[:dim] and g[0] in 'puvw'[:1 + dim]:
            out[g] = rng.normal(size=n)
    return out


def _fill(pa, props):
    """Add the 12 gradient props (0 where not seeded) and set the seeded
    props."""
    for k in GRADS + ("logrho",) + tuple(props):
        if k not in pa.properties:
            pa.add_property(k)
    for k, v in props.items():
        pa.properties[k][:] = v
    return pa


def box(make, nx=16, seed=5):
    """A lattice filling [-0.5, 0.5]^2 (periodic in x and y) jittered by a
    tenth of dx, h = 1.5 dx varied by 10% (h0 the same), seeded props."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / nx
    g = -0.5 + (np.arange(nx) + 0.5) * dx
    x, y = (c.ravel() for c in np.meshgrid(g, g))
    n = x.size
    h = 1.5 * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    props = _seeded(n, rng, 2)
    props['m'] = dx * dx * props['rho']
    pa = make(name='fluid', x=x + 0.1 * dx * rng.uniform(-1, 1, n),
              y=y + 0.1 * dx * rng.uniform(-1, 1, n), h=h, h0=h.copy(),
              **{k: v for k, v in props.items() if k in ('rho', 'p', 'e',
                                                         'cs', 'u', 'v',
                                                         'm', 'div')})
    return _fill(pa, props)


def tube(make, nl=40, seed=7):
    """Sod's tube (nl particles left of x = 0, nl / 8 right, h = 2.4 dx)
    jittered by a tenth of its spacing, with seeded props."""
    rng = np.random.default_rng(seed)
    dxl, dxr = 0.5 / nl, 0.5 / (nl // 8)
    x = np.concatenate([np.arange(-0.5 + 0.5 * dxl, 0.0, dxl),
                        np.arange(0.5 * dxr, 0.5, dxr)])
    n = x.size
    dx = np.where(x < 0, dxl, dxr)
    h = 2.4 * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    props = _seeded(n, rng, 1)
    props['rho'] = np.where(x < 0, 1.0, 0.125) * props['rho']
    props['m'] = dx * props['rho']
    pa = make(name='fluid', x=x + 0.1 * dx * rng.uniform(-1, 1, n), h=h,
              h0=h.copy(), **{k: v for k, v in props.items()
                              if k in ('rho', 'p', 'e', 'cs', 'u', 'm',
                                       'div')})
    return _fill(pa, props)


def _box_domain(cls):
    return cls(xmin=-0.5, xmax=0.5, ymin=-0.5, ymax=0.5, periodic_in_x=True,
               periodic_in_y=True)


#: {lattice: (make, dim, domain)}
LATTICES = {'box': (box, 2, _box_domain), 'tube': (tube, 1, None)}
#: GSPHAcceleration's keywords of each case: rsolver 0-10 and every branch
GSPH_CASES = {
    'box r0 first-order delta': ('box', dict(rsolver=0, monotonicity=0,
                                             interpolation=0)),
    'box r1 i02 linear': ('box', dict(rsolver=1, monotonicity=1,
                                      interpolation=1)),
    'box r2 iwin cubic': ('box', dict(rsolver=2, monotonicity=2,
                                      interpolation=2)),
    'box r3 linear interface': ('box', dict(rsolver=3, monotonicity=1,
                                            interpolation=1,
                                            interface_zero=False)),
    'box r4 iwin cubic interface': ('box', dict(
        rsolver=4, monotonicity=2, interpolation=2, interface_zero=False)),
    'box r5 hybrid': ('box', dict(rsolver=5, monotonicity=1, hybrid=True,
                                  blend_alpha=2.0)),
    'box r6 conduction': ('box', dict(rsolver=6, monotonicity=1, g1=0.25,
                                      g2=0.5)),
    'box r7': ('box', dict(rsolver=7, monotonicity=1, niter=40)),
    'box r8 iwin': ('box', dict(rsolver=8, monotonicity=2)),
    'box r9 cubic': ('box', dict(rsolver=9, monotonicity=1,
                                 interpolation=2)),
    'box r10 hybrid conduction': ('box', dict(
        rsolver=10, monotonicity=0, hybrid=True, g1=0.1, g2=0.2)),
    'tube r2 conduction': ('tube', dict(rsolver=2, monotonicity=1, g1=0.25,
                                        g2=0.5)),
    'tube r7 iwin cubic interface': ('tube', dict(
        rsolver=7, monotonicity=2, interpolation=2, interface_zero=False)),
}
ADKE_KW = dict(alpha=1.0, beta=1.0, g1=0.2, g2=0.4, k=0.3, eps=0.5)


def _gsph_groups(mod, kw):
    """``GSPHGradients`` then ``GSPHAcceleration`` of ``kw``."""
    g = jax_gsph if mod == 'jax' else gsph
    grp = JaxGroup if mod == 'jax' else Group
    return [grp([g.GSPHGradients('fluid', ['fluid'])]),
            grp([g.GSPHAcceleration('fluid', ['fluid'], gamma=1.4, **kw)])]


def _adke_groups(mod):
    b = jax_basic if mod == 'jax' else basic
    grp = JaxGroup if mod == 'jax' else Group
    k = {n: ADKE_KW[n] for n in ('k', 'eps')}
    return [grp([b.SummationDensityADKE('fluid', ['fluid'], **k)]),
            grp([b.ADKEAccelerations('fluid', ['fluid'], **ADKE_KW)])]


def _scheme_groups(mod, which, dim):
    s = jax_scheme if mod == 'jax' else scheme
    if which == 'gsph':
        sch = s.GSPHScheme(['fluid'], [], dim=dim, gamma=1.4,
                           kernel_factor=1.0, g1=0.25, g2=0.5, rsolver=2,
                           monotonicity=1, interpolation=1)
    else:
        sch = s.ADKEScheme(['fluid'], [], dim=dim, gamma=1.4, **ADKE_KW)
    return sch.get_equations()


def _evaluate(mod, lattice, groups, engine='kernel'):
    make, dim, domain = LATTICES[lattice]
    if mod == 'jax':
        pa = make(jax_gasd_array)
        ev = JaxEvaluator([pa], groups, dim=dim, kernel=JaxGaussian(dim=dim),
                          domain_manager=None if domain is None
                          else domain(JaxDomain))
    else:
        pa = make(get_particle_array_gasd)
        ev = SPHEvaluator([pa], groups, dim=dim, kernel=Gaussian(dim=dim),
                          domain_manager=None if domain is None
                          else domain(DomainManager),
                          config=Config(engine=engine, **CPU))
    ev.evaluate(t=T, dt=DT)
    return ev, {p: np.asarray(pa.properties[p], dtype=float).copy()
                for p in pa.properties
                if np.asarray(pa.properties[p]).dtype.kind == 'f'}


_JAX = {}


def _jax(case):
    if case not in _JAX:
        _JAX[case] = _evaluate('jax', *case[:1], case[1]('jax'))[1]
    return _JAX[case]


def _check(got, want, label, at_least):
    checked = 0
    for p, w in want.items():
        g = got[p]
        if np.abs(w).max() == 0.0:
            assert np.abs(g).max() == 0.0, (label, p)
            continue
        err = _scaled_err(g, w)
        assert err <= TOL, '%s %s: %.3g' % (label, p, err)
        checked += 1
    assert checked >= at_least, (label, checked)


OUT_GSPH = GRADS + ('au', 'av', 'aw', 'ae')


@pytest.mark.parametrize('case', list(GSPH_CASES))
def test_gsph_equations_match_jax(case):
    lattice, kw = GSPH_CASES[case]
    want = _jax((lattice, lambda mod: _gsph_groups(mod, kw), case))
    engines = ['kernel', 'torch'] if case.startswith('tube') or \
        'r2' in case else ['kernel']
    for engine in engines:
        ev, got = _evaluate('torch', lattice, _gsph_groups('torch', kw),
                            engine)
        a_eval = ev.func_eval
        assert set(a_eval.engine_choices.values()) == {engine}
        planned = {p.op for p in a_eval._plans.values() if p is not None}
        assert planned == ({gs.gsph_pair} if engine == 'kernel' else set())
        _check(got, {p: want[p] for p in OUT_GSPH if p in got},
               '%s %s' % (case, engine), 4 if lattice == 'tube' else 8)


@pytest.mark.parametrize('lattice', list(LATTICES))
def test_adke_equations_match_jax(lattice):
    want = _jax((lattice, _adke_groups, 'adke'))
    for engine in ('kernel', 'torch'):
        ev, got = _evaluate('torch', lattice, _adke_groups('torch'), engine)
        assert set(ev.func_eval.engine_choices.values()) == {engine}
        _check(got, {p: want[p] for p in ('rho', 'arho', 'div', 'logrho',
                                          'h', 'au', 'av', 'aw', 'ae')},
               'adke %s %s' % (lattice, engine), 6)


@pytest.mark.parametrize('which', ['gsph', 'adke'])
@pytest.mark.parametrize('lattice', list(LATTICES))
def test_scheme_evaluation_matches_jax(which, lattice):
    dim = LATTICES[lattice][1]
    want = _jax((lattice, lambda mod: _scheme_groups(mod, which, dim),
                 which + ' scheme'))
    ev, got = _evaluate('torch', lattice, _scheme_groups('torch', which,
                                                        dim))
    a_eval = ev.func_eval
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    ops = [p.op for p in a_eval._plans.values() if p is not None]
    if which == 'gsph':
        assert ops == [gd.gasd_pair] * 2 + [gs.gsph_pair] * 2
        # a re-binning after each h update; on the box the doubled h
        # outgrows the periodic cells, and the evaluation runs again on a
        # grid re-sized for it
        grown = lattice == 'box'
        assert a_eval.grid.grows == grown
        assert a_eval.binnings == (4 if grown else 2)
    else:
        assert ops == [gd.gasd_pair, wp.wcsph_pair, gd.gasd_pair]
        # the reuse test after the density's initialize, and the
        # re-binning after the plain density
        assert a_eval.binnings == 2
    props = ('rho', 'h', 'p', 'cs', 'au', 'av', 'ae', 'div') + (
        GRADS if which == 'gsph' else ('logrho', 'arho'))
    _check(got, {p: want[p] for p in props if p in got},
           '%s %s' % (which, lattice), 7)


def _all_pairs_density(P, dim, k, eps, periodic):
    """ADKE's two density groups summed over all pairs (float64 numpy,
    the Gaussian): rho at h0 with WIJ at the mean h, h = k (g / rho)^eps
    h0, then the plain summation density at that h; pairs with r < 3
    max(hi, hj)."""
    fac = Gaussian(dim=dim).fac
    xyz = np.stack([P[c] for c in 'xyz'[:dim]])
    d = xyz[:, :, None] - xyz[:, None]
    if periodic:
        d -= np.rint(d)
    r = np.sqrt((d ** 2).sum(0))

    def rho_of(h):
        hij = 0.5 * (h[:, None] + h[None])
        q = r / hij
        w = np.where(q < 3, np.exp(-q * q), 0.0) * fac / hij ** dim
        sup = r < 3.0 * np.maximum(h[:, None], h[None])
        return (np.where(sup, w, 0.0) * P['m'][None]).sum(1)

    rho0 = rho_of(P['h0'])
    g = np.exp(np.log(rho0).mean())
    h = k * (g / rho0) ** eps * P['h0']
    return rho0, h, rho_of(h)


#: ADKE's k and eps on each lattice: the accuracy test's (h = 1.5 h0)
#: and the shock tube's
ADKE_H = {'box': (1.5, 0.0), 'tube': (0.3, 0.5)}


@pytest.mark.parametrize('lattice', list(LATTICES))
def test_adke_density_groups_see_every_pair(lattice):
    """The ADKE density's ``initialize`` resets h to h0 on a binning made
    with the h of the last ``reduce`` (here h0 / 4: cells sized for it),
    and its ``reduce`` sets h past that: the ADKE sum, the h it sets and
    the plain summation density after it are the all-pairs sums of their
    formulas."""
    make, dim, domain = LATTICES[lattice]
    k, eps = ADKE_H[lattice]
    b = basic
    groups = [Group([b.SummationDensityADKE('fluid', ['fluid'], k=k,
                                            eps=eps)]),
              Group([SummationDensity('fluid', ['fluid'])],
                    update_nnps=True)]
    pa = make(get_particle_array_gasd)
    P = {p: np.asarray(pa.properties[p], dtype=float).copy()
         for p in ('x', 'y', 'z', 'm', 'h0')}
    pa.properties['h'][:] = 0.25 * P['h0']
    ev = SPHEvaluator([pa], groups, dim=dim, kernel=Gaussian(dim=dim),
                      domain_manager=None if domain is None
                      else domain(DomainManager), config=Config(**CPU))
    assert ev.func_eval.grid.cell < 3.0 * P["h0"].max()
    ev.evaluate(t=T, dt=DT)
    rho0, h, rho = _all_pairs_density(P, dim, k, eps, domain is not None)
    assert h.max() > 0.25 * P['h0'].max()
    got = {p: np.asarray(pa.properties[p], dtype=float)
           for p in ('h', 'rho', 'logrho')}
    assert _scaled_err(got['logrho'], np.log(rho0)) <= 1e-12
    assert _scaled_err(got['h'], h) <= 1e-12
    assert _scaled_err(got['rho'], rho) <= 1e-12


# -- the planner and the classes ----------------------------------------------
def _planned(equations, kernel, caplog, lattice='box'):
    make, dim, _ = LATTICES[lattice]
    arr = make(get_particle_array_gasd)
    grid = CellGrid.from_particles([arr], dim=dim, radius_scale=3.0)
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        return AccelerationEval([arr], equations, kernel,
                                Config(engine='kernel', **CPU), grid)


def test_planner_takes_the_new_sets(caplog):
    a_eval = _planned(_gsph_groups('torch', dict(rsolver=7)),
                      Gaussian(dim=2), caplog)
    plans = [a_eval._plans[id(g), 'fluid'] for g in a_eval.leaf_groups()]
    assert [p.op for p in plans] == [gs.gsph_pair] * 2
    assert [p.sources[0].terms for p in plans] == [gs.GRAD, gs.ACC]
    assert [p.outputs for p in plans] == [gs.OUTPUTS[:12], gs.OUTPUTS[12:]]
    assert all(p.takes_time for p in plans)
    assert plans[1].sources[0].params == gs.GsphParams(rsolver=7)
    a_eval = _planned(_adke_groups('torch'), Gaussian(dim=2), caplog)
    plans = [a_eval._plans[id(g), 'fluid'] for g in a_eval.leaf_groups()]
    assert [p.sources[0].terms for p in plans] == [gd.ADEN, gd.ADKE]
    assert [p.outputs for p in plans] == [('rho', 'arho'),
                                          ('au', 'av', 'aw', 'ae')]
    # ADKEAccelerations' g2 is its g1, as the reference's
    assert plans[1].sources[0][4:] == (1.0, 0.2, 0.2)


def test_planner_refuses_a_mixed_set_and_raises_for_1d_kernels(caplog):
    mixed = [Group([gsph.GSPHGradients('fluid', ['fluid']),
                    gsph.GSPHAcceleration('fluid', ['fluid'])])]
    caplog.clear()
    a_eval = _planned(mixed, Gaussian(dim=2), caplog)
    assert set(a_eval.engine_choices.values()) == {'torch'}
    assert 'gsph: GSPHAcceleration reads' in caplog.text
    mixed = [Group([basic.SummationDensityADKE('fluid', ['fluid']),
                    basic.ADKEAccelerations('fluid', ['fluid'], **ADKE_KW)])]
    caplog.clear()
    a_eval = _planned(mixed, Gaussian(dim=2), caplog)
    assert set(a_eval.engine_choices.values()) == {'torch'}
    assert 'gasd: ' in caplog.text
    for groups in (_gsph_groups('torch', {}), _adke_groups('torch')):
        with pytest.raises(NotImplementedError, match='item 28'):
            _planned(groups, WendlandQuinticC2_1D(dim=1), caplog, 'tube')
    with pytest.raises(ValueError, match='no Riemann solver 11'):
        _planned(_gsph_groups('torch', dict(rsolver=11)), Gaussian(dim=2),
                 caplog)


@pytest.mark.parametrize('kw,item', [(dict(solids=['wall']), 'item 28'),
                                     (dict(has_ghosts=True), 'item 27')])
@pytest.mark.parametrize('which', ['GSPHScheme', 'ADKEScheme'])
def test_schemes_refuse_walls_and_ghosts(which, kw, item):
    args = dict(fluids=['fluid'], solids=[], dim=2, gamma=1.4)
    if which == 'GSPHScheme':
        args['kernel_factor'] = 1.0
    args.update(kw)
    s = getattr(scheme, which)(**args)
    for call in (s.get_equations, s.configure_solver,
                 lambda: s.setup_properties([])):
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_schemes_take_the_reference_options():
    """``GSPHScheme`` and ``ADKEScheme`` have the JAX schemes' methods with
    the same arguments and the same command-line options;
    ``monotonicity_min`` is the JAX function (its equations' classes:
    ``tests/test_torch_gas_dynamics.py::test_every_gas_class_is_ported``)."""
    pairs = [(getattr(scheme, n), getattr(jax_scheme, n))
             for n in ('GSPHScheme', 'ADKEScheme')]
    for mine, theirs in pairs:
        for m in ('__init__', 'add_user_options', 'consume_user_options',
                  'get_equations', 'configure_solver', 'setup_properties'):
            a, b = getattr(mine, m, None), getattr(theirs, m, None)
            assert (a is None) == (b is None), (mine.__name__, m)
            if a is not None:
                assert inspect.signature(a) == inspect.signature(b), (
                    mine.__name__, m)
    for a, b in ((gsph.monotonicity_min, jax_gsph.monotonicity_min),):
        assert inspect.signature(a) == inspect.signature(b)
    x = np.array([-1.0, 0.0, 2.0, 3.0, -0.5])
    got = gsph.monotonicity_min(*[torch.as_tensor(v) for v in (
        x, np.roll(x, 1), np.roll(x, 2))]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_gsph.monotonicity_min(
        x, np.roll(x, 1), np.roll(x, 2))))
    # the options of the command line
    import argparse
    for name in ('GSPHScheme', 'ADKEScheme'):
        opts = []
        for mod in (scheme, jax_scheme):
            kw = dict(fluids=['f'], solids=[], dim=2, gamma=1.4)
            if name == 'GSPHScheme':
                kw['kernel_factor'] = 1.0
            parser = argparse.ArgumentParser()
            getattr(mod, name)(**kw).add_user_options(parser)
            opts.append(sorted(a.dest for a in parser._actions))
        assert opts[0] == opts[1], name


def test_from_numpy_carries_a_gsph_state():
    pa = box(jax_gasd_array)
    jax_scheme.GSPHScheme(['fluid'], [], dim=2, gamma=1.4,
                          kernel_factor=1.0).setup_properties([pa],
                                                              clean=False)
    pa.add_property('logrho')
    pa.properties['logrho'][:] = np.log(np.asarray(pa.properties['rho']))
    props = {k: np.asarray(v).copy() for k, v in pa.properties.items()}
    mine = ParticleArray.from_numpy('fluid', props)
    for p in GRADS + ('logrho', 'h0', 'orig_idx', 'grhox', 'div'):
        np.testing.assert_array_equal(np.asarray(mine.properties[p]),
                                      props[p])
    assert np.asarray(mine.properties['orig_idx']).dtype.kind == 'i'
    np.testing.assert_array_equal(mine.orig_idx, np.arange(256))
