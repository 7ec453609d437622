"""The port's TSPH equations and ``TSPHScheme`` (``sph/gas_dynamics/
tsph.py``) and its pair kernel's plain versions (``ops/tsph_pair.py``)
against pysph_tpu's, float64 on the CPU, inputs seeded with numpy.

- One evaluation of each TSPH group through the port's and the JAX
  ``SPHEvaluator`` at 1e-10 of ``max|ref|``: the number density's sums
  and one Newton sweep (``SummationDensity`` with
  ``density_iterations``, some particles converged before it, some that
  converge in it and some that do not), ``VelocityGradDivC1`` with
  ``BalsaraSwitch`` (a singular ``invtt`` among the particles), and
  ``MomentumAndEnergy`` on approaching and receding pairs, each on a
  jittered 2D lattice of 16^2 periodic in x and y and open, and a
  jittered 1D line periodic and open, h varied per particle, on the
  kernel engine (on the CPU ``tsph_pair``'s plain version) and the torch
  engine; and ``TSPHScheme``'s whole evaluation (its iterated group
  planned onto ``tsph_sweep``, linked to the velocity gradient and the
  momentum).
- ``tsph_sweep_reference`` gated (``run``) and ungated against the
  equation's evaluation, ``mom_terms_reference`` against
  ``MomentumAndEnergy``'s expressions, the closed-form inverse against
  numpy's in 1, 2 and 3 dimensions with singular matrices.
- The planner: the three sets onto ``tsph_pair``, the sweep plan, its
  link (the velocity gradient between, the momentum consuming), the
  refusals (a mixed set, a 1D kernel, walls and ghosts).
"""

import inspect
import logging

import numpy as np
import pytest
import torch

from jax_gasd_figures import ROOMY
from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import Gaussian as JaxGaussian
from pysph_tpu.base.utils import get_particle_array as jax_gpa
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.gas_dynamics import tsph as jax_tsph
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import Gaussian, WendlandQuinticC2_1D
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics import tsph
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
CPU = dict(device='cpu', dtype=torch.float64)
T, DT = 0.3, 1e-3
HFACT, HTOL = 1.2, 0.03
GAMMA = 1.4


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def lattice(name, tiny=False, seed=5):
    """Positions, h and seeded props of a lattice: ``box`` / ``open2d``
    16^2 on [-0.5, 0.5]^2, ``line`` / ``open1d`` 48 on [-0.5, 0.5],
    jittered by a tenth of dx, h = HFACT dx varied by 10%; ``open2d``
    adds three particles on a line far from the rest (their ``invtt`` is
    singular), and with ``tiny`` one particle's h is 1e-3 dx (its
    ``invtt`` 0).  Returns (dim, periodic, props)."""
    rng = np.random.default_rng(seed)
    dim = 2 if name in ('box', 'open2d') else 1
    nx = 16 if dim == 2 else 48
    dx = 1.0 / nx
    g = -0.5 + (np.arange(nx) + 0.5) * dx
    pos = [c.ravel() for c in np.meshgrid(g, g)] if dim == 2 else [g]
    if name == 'open2d':
        pos = [np.concatenate([pos[0], 2.0 + dx * np.array([-1., 0., 1.])]),
               np.concatenate([pos[1], np.full(3, 2.0)])]
    n = pos[0].size
    pos = [c + 0.1 * dx * rng.uniform(-1, 1, n) for c in pos]
    if name == 'open2d':
        pos[1][-3:] = 2.0
    h = HFACT * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    if tiny:
        h[n // 3] = 1e-3 * dx
    rho = 1.0 + 0.3 * rng.random(n)
    e = 1.0 + rng.random(n)
    P = dict(x=pos[0], h=h, h0=h * (1.0 + 0.05 * rng.uniform(-1, 1, n)),
             rho=rho, e=e, p=(GAMMA - 1.0) * rho * e, cs=0.5 + rng.random(n),
             m=dx ** dim * rho, u=0.3 * rng.normal(size=n),
             alpha=rng.random(n), ah=rng.normal(size=n),
             converged=np.where(rng.random(n) < 0.2, 1.0, 0.0))
    if dim == 2:
        P['y'] = pos[1]
        P['v'] = 0.3 * rng.normal(size=n)
    P['n'] = dx ** -dim * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    P['dndh'] = -dim * P['n'] / h * (1.0 + 0.2 * rng.uniform(-1, 1, n))
    P['drhosumdh'] = -dim * rho / h * (1.0 + 0.2 * rng.uniform(-1, 1, n))
    for p in ('prevn', 'prevdndh', 'prevdrhosumdh'):
        P[p] = P[p[4:]] * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    return dim, name in ('box', 'line'), P


def _domain(cls, dim):
    kw = dict(xmin=-0.5, xmax=0.5, periodic_in_x=True)
    if dim == 2:
        kw.update(ymin=-0.5, ymax=0.5, periodic_in_y=True)
    return cls(**kw)


def _array(mod, dim, P):
    gpa = jax_gpa if mod == 'jax' else get_particle_array
    sch = (jax_tsph if mod == 'jax' else tsph).TSPHScheme(
        ['fluid'], [], dim=dim, gamma=GAMMA, hfact=HFACT)
    pa = gpa(name='fluid', **{k: P[k] for k in ('x', 'y', 'h', 'rho', 'm')
                              if k in P})
    sch.setup_properties([pa])
    for k, v in P.items():
        pa.properties[k][:] = v
    return pa


def _groups(mod, which, dim):
    t = jax_tsph if mod == 'jax' else tsph
    grp = JaxGroup if mod == 'jax' else Group
    if which == 'density':
        return [grp([t.SummationDensity('fluid', ['fluid'], dim=dim,
                                        density_iterations=True,
                                        hfact=HFACT, htol=HTOL)])]
    if which == 'gradient':
        return [grp([t.VelocityGradDivC1('fluid', ['fluid'], dim=dim),
                     t.BalsaraSwitch('fluid', None, alphaav=1.0,
                                     fkern=1.0)])]
    if which == 'momentum':
        return [grp([t.MomentumAndEnergy('fluid', ['fluid'], dim=dim,
                                         fkern=1.0, beta=2.0)])]
    return t.TSPHScheme(['fluid'], [], dim=dim, gamma=GAMMA, hfact=HFACT,
                        density_iteration_tolerance=1e-6).get_equations()


def _evaluate(mod, name, which, engine='kernel', tiny=False):
    dim, periodic, P = lattice(name, tiny)
    pa = _array(mod, dim, P)
    if mod == 'jax':
        ev = JaxEvaluator([pa], _groups('jax', which, dim), dim=dim,
                          kernel=JaxGaussian(dim=dim),
                          domain_manager=_domain(JaxDomain, dim)
                          if periodic else None)
    else:
        ev = SPHEvaluator([pa], _groups('torch', which, dim), dim=dim,
                          kernel=Gaussian(dim=dim),
                          domain_manager=_domain(DomainManager, dim)
                          if periodic else None,
                          config=Config(engine=engine, **CPU))
    ev.evaluate(t=T, dt=DT)
    return ev, {p: np.asarray(pa.properties[p], dtype=float).copy()
                for p in pa.properties
                if np.asarray(pa.properties[p]).dtype.kind == 'f'}


_JAX = {}


def _jax(name, which, tiny=False):
    key = (name, which, tiny)
    if key not in _JAX:
        with pytest.MonkeyPatch.context() as mp:
            # the whole scheme's later groups read the binning of before
            # the iteration in the JAX package (ROADMAP Queue 3): its
            # cells are made roomy, as tests/jax_gasd_figures.py's
            make = GridSpec.from_particles.__func__

            def roomy(cls, *args, **kw):
                for k, v in ROOMY.items():
                    kw.setdefault(k, v)
                return make(cls, *args, **kw)
            mp.setattr(GridSpec, 'from_particles', classmethod(roomy))
            _JAX[key] = _evaluate('jax', name, which, tiny=tiny)[1]
    return _JAX[key]


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


LATTICES = ('box', 'open2d', 'line', 'open1d')
OUT = {'density': ('rho', 'arho', 'drhosumdh', 'n', 'an', 'dndh', 'prevn',
                   'prevdndh', 'prevdrhosumdh', 'h', 'ah', 'converged'),
       'gradient': ('invtt', 'gradv', 'divv', 'alpha'),
       'momentum': ('au', 'av', 'aw', 'ae'),
       'scheme': ('rho', 'arho', 'n', 'an', 'dndh', 'drhosumdh', 'h', 'ah',
                  'converged', 'p', 'cs', 'invtt', 'gradv', 'divv', 'alpha',
                  'au', 'av', 'ae')}


@pytest.mark.parametrize('which', ['density', 'gradient', 'momentum'])
@pytest.mark.parametrize('name', LATTICES)
def test_groups_match_jax(name, which):
    tiny = which == 'gradient' and name != 'open2d'
    want = _jax(name, which, tiny)
    for engine in ('kernel', 'torch'):
        ev, got = _evaluate('torch', name, which, engine, tiny)
        a_eval = ev.func_eval
        assert set(a_eval.engine_choices.values()) == {engine}
        planned = {p.op for p in a_eval._plans.values() if p is not None}
        assert planned == ({ts.tsph_pair} if engine == 'kernel' else set())
        _check(got, {p: want[p] for p in OUT[which]},
               '%s %s %s' % (name, which, engine), len(OUT[which]) - 3)
    if which == 'density':
        # converged before the sweep, converged in it, and not
        was = lattice(name)[2]['converged'] == 1.0
        now = got['converged'] == 1.0
        assert was.any() and (now & ~was).any() and (~now).any(), name
        np.testing.assert_array_equal(got['h'][was],
                                      lattice(name)[2]['h'][was])
    if which == 'gradient':
        inv, det = tsph.inverse_block(torch.as_tensor(got['invtt'].reshape(
            -1, 9)), 1 if name in ('line', 'open1d') else 2)
        assert (det.abs() <= tsph.DET_MIN).sum() >= 1, name
    if which == 'momentum':
        dim, _, P = lattice(name)
        x = np.stack([P[c] for c in 'xy'[:dim]])
        v = np.stack([P[c] for c in 'uv'[:dim]])
        dots = ((v[:, :, None] - v[:, None]) *
                (x[:, :, None] - x[:, None])).sum(0)
        assert (dots < 0).any() and (dots > 0).any()


@pytest.mark.parametrize('name', ['box', 'line'])
def test_scheme_evaluation_matches_jax(name):
    want = _jax(name, 'scheme')
    ev, got = _evaluate('torch', name, 'scheme')
    a_eval = ev.func_eval
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    [sweep] = a_eval.sweep_plans()
    assert sweep.op is ts.tsph_sweep and sweep.link is not None
    assert [p.sources[0].terms for p in sweep.link.middle] == [ts.GRADV]
    assert sweep.link.consumer.sources[0].terms == ts.MOM
    assert not a_eval.host_iterated
    assert a_eval.sweeps[-1] > 1
    _check(got, {p: want[p] for p in OUT['scheme']}, name + ' scheme', 14)


# -- the plain versions -------------------------------------------------------
@pytest.mark.parametrize('name', LATTICES)
def test_sweep_reference_is_the_equation(name):
    """``tsph_sweep_reference`` ungated is one evaluation of the density
    group; gated off it gives the props as they were and a count of 0;
    its count is the particles not converged after it."""
    dim, periodic, P = lattice(name)
    _, want = _evaluate('torch', name, 'density')
    pa = _array('torch', dim, P)
    ev = SPHEvaluator([pa], _groups('torch', 'density', dim), dim=dim,
                      kernel=Gaussian(dim=dim),
                      domain_manager=_domain(DomainManager, dim)
                      if periodic else None, config=Config(**CPU))
    grid = ev.func_eval.grid
    states = {'fluid': pa.to_device(ev.config)}
    cells = grid.bin_all(states)
    [plan] = [p for p in ev.func_eval._plans.values() if p is not None]
    st = states['fluid']
    args = (st, cells['fluid'], None, [(st, cells['fluid'],
                                        plan.sources[0])], grid,
            plan.kernel, ts.sweep_spec(plan.sources[0].equations[0]))
    out, unconv = ts.tsph_sweep_reference(*args)
    for p in ts.SWEEP_OUTPUTS:
        assert _scaled_err(out[p].numpy(), want[p]) <= 1e-13, p
    assert int(unconv) == int((out['converged'] != 1.0).sum()) > 0
    out, unconv = ts.tsph_sweep(*args, run=torch.zeros((), dtype=torch.bool))
    assert int(unconv) == 0
    for p in ts.SWEEP_OUTPUTS:
        assert torch.equal(out[p], st[p]), p


def test_mom_terms_are_the_equation_s():
    _, _, P = lattice('box')
    st = {k: torch.as_tensor(v) for k, v in P.items()}
    got = ts.mom_terms_reference(st, 2).numpy()
    h, n = P['h'], P['n']
    np.testing.assert_array_equal(got[:, 0], P['p'] / (P['rho'] * P['rho']))
    np.testing.assert_array_equal(got[:, 1], P['drhosumdh'] * (h / (n * 2)))
    np.testing.assert_array_equal(got[:, 2], 1 + P['dndh'] * (h / (n * 2)))
    assert not got[:, 3].any()


@pytest.mark.parametrize('dim', [1, 2, 3])
def test_inverse_block_is_numpy_s(dim):
    rng = np.random.default_rng(dim)
    n = 64
    tt = np.zeros((n, 9))
    block = rng.normal(size=(n, dim, dim)) + 3 * np.eye(dim)
    block[:4] = 0.0                      # singular: 0
    block[4, :, 0] = 0.0                 # singular: a zero column
    if dim > 1:
        block[5, 1] = 2.0 * block[5, 0]  # singular: dependent rows
    for r in range(dim):
        tt[:, 3 * r:3 * r + dim] = block[:, r]
    inv, det = tsph.inverse_block(torch.as_tensor(tt), dim)
    det = det.numpy()
    good = np.abs(np.linalg.det(block)) > tsph.DET_MIN
    np.testing.assert_array_equal(np.abs(det) > tsph.DET_MIN, good)
    assert (~good).sum() >= (3 if dim > 1 else 2) + 2
    want = np.where(good[:, None, None],
                    np.linalg.inv(np.where(good[:, None, None], block,
                                           np.eye(dim))), np.eye(dim))
    for (r, c), v in inv.items():
        np.testing.assert_allclose(v.numpy(), want[:, r, c], rtol=1e-12,
                                   atol=1e-12)


# -- the planner and the scheme -----------------------------------------------
def _planned(equations, kernel, caplog, name='box'):
    dim, _, P = lattice(name)
    arr = _array('torch', dim, P)
    grid = CellGrid.from_particles([arr], dim=dim, radius_scale=3.0)
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        return AccelerationEval([arr], equations, kernel,
                                Config(engine='kernel', **CPU), grid)


def test_planner_takes_the_three_sets_and_links_the_sweep(caplog):
    a_eval = _planned(_groups('torch', 'scheme', 2), Gaussian(dim=2), caplog)
    plans = [a_eval._plans.get((id(g), 'fluid'))
             for g in a_eval.leaf_groups()]
    assert [p and p.op for p in plans] == [ts.tsph_pair, None, ts.tsph_pair,
                                           ts.tsph_pair]
    assert [p.sources[0].terms for p in plans if p] == [ts.SDEN, ts.GRADV,
                                                         ts.MOM]
    assert [p.outputs for p in plans if p] == [
        ts.OUTPUTS[:6], ('invtt', 'gradv'), ('au', 'av', 'aw', 'ae')]
    assert plans[3].sources[0][3:] == (2.0, 1.0)
    [sweep] = a_eval.sweep_plans()
    assert sweep.op is ts.tsph_sweep and sweep.plan is plans[0]
    assert sweep.spec[1:] == (HFACT, 1e-6, False, True)
    link = sweep.link
    assert link.middle == (plans[2],) and link.consumer is plans[3]
    assert plans[2].link is link and plans[3].link is link


def test_planner_refuses_a_mixed_set_and_a_1d_kernel(caplog):
    mixed = [Group([tsph.VelocityGradDivC1('fluid', ['fluid'], dim=2),
                    tsph.MomentumAndEnergy('fluid', ['fluid'], dim=2,
                                           fkern=1.0)])]
    caplog.clear()
    a_eval = _planned(mixed, Gaussian(dim=2), caplog)
    assert set(a_eval.engine_choices.values()) == {'torch'}
    assert 'tsph: ' in caplog.text
    with pytest.raises(NotImplementedError, match='item 28'):
        _planned(_groups('torch', 'momentum', 1), WendlandQuinticC2_1D(dim=1),
                 caplog, 'line')
    # the sweep's link refused where a group between re-bins
    groups = _groups('torch', 'scheme', 2)
    groups[1].update_nnps = True
    caplog.clear()
    a_eval = _planned(groups, Gaussian(dim=2), caplog)
    assert a_eval.sweep_plans()[0].link is None
    assert 'tsph_pair sweep for fluid: no link' in caplog.text


@pytest.mark.parametrize('kw,item', [(dict(solids=['wall']), 'item 28'),
                                     (dict(has_ghosts=True), 'item 27')])
def test_scheme_refuses_walls_and_ghosts(kw, item):
    s = tsph.TSPHScheme(fluids=['fluid'], dim=2, gamma=1.4, hfact=1.2,
                        **dict(dict(solids=[]), **kw))
    for call in (s.get_equations, s.configure_solver,
                 lambda: s.setup_properties([])):
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_scheme_takes_the_reference_options():
    for m in ('__init__', 'add_user_options', 'consume_user_options',
              'get_equations', 'configure_solver', 'setup_properties'):
        a, b = getattr(tsph.TSPHScheme, m), getattr(jax_tsph.TSPHScheme, m)
        assert inspect.signature(a) == inspect.signature(b), m
    for name in ('SummationDensity', 'IdealGasEOS', 'VelocityGradDivC1',
                 'BalsaraSwitch', 'MomentumAndEnergy', 'PECStep'):
        for m in ('__init__', 'initialize', 'loop', 'post_loop', 'stage1',
                  'stage2'):
            a = getattr(getattr(tsph, name), m, None)
            b = getattr(getattr(jax_tsph, name), m, None)
            assert (a is None) == (b is None), (name, m)
            if a is not None:
                assert inspect.signature(a) == inspect.signature(b), (name,
                                                                      m)
    import argparse
    opts = []
    for mod in (tsph, jax_tsph):
        parser = argparse.ArgumentParser()
        mod.TSPHScheme(['f'], [], dim=2, gamma=1.4,
                       hfact=1.2).add_user_options(parser)
        opts.append(sorted(a.dest for a in parser._actions))
    assert opts[0] == opts[1]
