"""The port's compressible gas dynamics (``sph/gas_dynamics/basic.py``,
``GasDScheme``, ``examples/gas_dynamics/``) and the evaluator's
``update_nnps`` groups against pysph_tpu's, float64 on the CPU, inputs
seeded with numpy.

- ``GasDScheme``'s equations in its phase sets, one evaluation through
  the port's and the JAX ``SPHEvaluator`` at 1e-10 of ``max|ref|``: the
  ``mpm`` adaptive-h scheme (the grad-h density iteration, an iterated
  group re-binned every sweep, then ``IdealGasEOS`` and
  ``MPMAccelerations`` with both switches) on a jittered Sedov lattice
  (nx=21, h varied by 10%) and on the shock tube (nl=40, h jumping by the
  density ratio at the diaphragm: the example's initial evaluation), with
  the JAX sweep count (host callbacks in its traced ``post_loop``), the
  same per-particle ``converged`` and h; the ``gsph`` scheme (plain
  ``update_nnps`` groups
  that scale h and set it from the volume, each re-binned after) on the
  Sedov lattice; on the kernel engine (on the CPU ``gasd_pair``'s plain
  version) and the torch engine.  The Sedov lattice fills a box periodic
  in x and y: the JAX package's groups after an iterated ``update_nnps``
  group read the binning from before it, whose cells miss pairs where h
  grew past the cell slack (at a lattice's free edges h grows by up to
  half); the port's read the last sweep's binning, and its momentum phase
  at the free edges is held to an all-pairs sum of its formula instead.
- The initial evaluation of each example, ``shocktube --nl 40`` (its
  start jittered, velocities seeded; both engines) and ``sedov --nx 21``
  (h0 set to h), against the JAX app's at 1e-10; three steps at 1e-9 on
  the kernel engine, the sweeps of every evaluation equal to the JAX
  app's.
- ``gasd_pair_reference`` against the torch engine at capacities on both
  sets, the 1D diaphragm included, and its pair counts against a brute
  force count; the planner's two sets and its refusals (logged);
  ``Group(update_nnps=True)`` taken and the other features refused;
  ``GasDScheme`` refusing walls and ghosts; ``ReduceView.active`` against
  the JAX evaluator's ``active``; a NaN h not binned, and the grid's
  flag that the solver reads.

``tests/test_torch_gasd_cuda.py`` holds the kernel to its plain version
on the card.
"""

import importlib
import importlib.util
import inspect
import logging
import pathlib
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import Gaussian as JaxGaussian
from pysph_tpu.base.utils import get_particle_array_gasd as jax_gasd_array
from pysph_tpu.sph import scheme as jax_scheme
from pysph_tpu.sph.acceleration_eval import _active_mask as jax_active
from pysph_tpu.sph.gas_dynamics import basic as jax_basic
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.cell_grid import CellGrid, PairCapacity
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import (CubicSpline, Gaussian,
                                          WendlandQuinticC2_1D, kernel_kind)
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.sph import scheme
from pysph_tpu_torch.sph.acceleration_eval import (
    AccelerationEval, ReduceView, run_pair_phase)
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics import basic
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import gasd_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
STEP_TOL = 1e-9
CPU = dict(device='cpu', dtype=torch.float64)
ENGINES = ['kernel', 'torch']
DT = 1e-4
#: the JAX grid's cell capacity over its setup's occupancy (its default
#: 1.3 overflows as the density iteration moves h, and an evaluation that
#: overflowed runs again, without jit: most of this file's time); the
#: capacity holds the slots of a cell, not which pairs are in support
JAX_CAPACITY_SLACK = 2.0
_FROM_PARTICLES = GridSpec.from_particles.__func__


def _roomy_cells(cls, *args, **kw):
    kw.setdefault('capacity_slack', JAX_CAPACITY_SLACK)
    return _FROM_PARTICLES(cls, *args, **kw)


def _roomier_cells(cls, *args, **kw):
    """The JAX grid of ``tests/jax_gasd_figures.py``'s ``ROOMY``: the
    ``gsph`` adaptive h doubles h past the periodic cells that the JAX
    package sizes at setup, where its sums miss pairs (ROADMAP Queue 3);
    the port re-sizes its grid for the doubled h, and these cells give the
    JAX package every pair too."""
    import jax_gasd_figures
    for k, v in jax_gasd_figures.ROOMY.items():
        kw.setdefault(k, v)
    return _FROM_PARTICLES(cls, *args, **kw)


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


# -- the equations -----------------------------------------------------------
def _sedov(make, nx=21, seed=5, periodic=False):
    """Sedov's lattice at nx (on [-0.5, 0.5]^2 with free edges, or filling
    that box where ``periodic``) jittered by a tenth of dx, h varied by
    10% (h0 the same), with seeded velocities, densities, energies and
    switches."""
    rng = np.random.default_rng(seed)
    if periodic:
        dx = 1.0 / nx
        g = -0.5 + (np.arange(nx) + 0.5) * dx
    else:
        dx = 1.0 / (nx - 1)
        g = np.linspace(-0.5, 0.5, nx)
    x, y = (c.ravel() for c in np.meshgrid(g, g))
    n = x.size
    h = 1.2 * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    return make(name='fluid', x=x + 0.1 * dx * rng.uniform(-1, 1, n),
                y=y + 0.1 * dx * rng.uniform(-1, 1, n),
                u=0.3 * rng.normal(size=n), v=0.3 * rng.normal(size=n),
                m=dx * dx, rho=1.0 + 0.05 * rng.normal(size=n), h=h,
                h0=h.copy(), e=1.0 + rng.random(n),
                alpha1=rng.random(n), alpha2=rng.random(n), omega=1.0)


def _periodic_sedov(make):
    return _sedov(make, periodic=True)


def _box(cls):
    return cls(xmin=-0.5, xmax=0.5, ymin=-0.5, ymax=0.5, periodic_in_x=True,
               periodic_in_y=True)


#: {case: (lattice, dim, gamma, scheme's keywords, domain)}
CASES = {
    'mpm sedov': (_periodic_sedov, 2, 5.0 / 3.0, dict(
        alpha1=10.0, alpha2=1.0, update_alpha1=True, update_alpha2=True),
        _box),
    'gsph sedov': (_periodic_sedov, 2, 5.0 / 3.0, dict(
        adaptive_h_scheme='gsph', update_alpha1=True, update_alpha2=True),
        _box),
}
#: the props each evaluation writes
OUT = ('rho', 'arho', 'grhox', 'grhoy', 'dwdh', 'omega', 'h', 'converged',
       'div', 'ah', 'p', 'cs', 'au', 'av', 'ae', 'del2e', 'dt_cfl',
       'aalpha1', 'aalpha2')


def _scheme(mod, case):
    _, dim, gamma, kw, _ = CASES[case]
    return mod.GasDScheme(['fluid'], [], dim=dim, gamma=gamma,
                          kernel_factor=1.2, **kw)


#: the JAX evaluations' sweeps: host callbacks in the traced
#: SummationDensity.post_loop (1, one a sweep) and IdealGasEOS.loop
#: ('eval', one an evaluation, after the sweeps)
_LOG = []
_JAX_POST_LOOP = jax_basic.SummationDensity.post_loop
_JAX_EOS = jax_basic.IdealGasEOS.loop


def _counting_post_loop(self, d_idx, d_arho, d_rho, d_div, d_omega, d_dwdh,
                        d_h0, d_h, d_m, d_ah, d_converged):
    if self.density_iterations:
        jax.debug.callback(lambda: _LOG.append(1), ordered=True)
    _JAX_POST_LOOP(self, d_idx, d_arho, d_rho, d_div, d_omega, d_dwdh,
                   d_h0, d_h, d_m, d_ah, d_converged)


def _counting_eos(self, d_idx, d_p, d_rho, d_e, d_cs):
    jax.debug.callback(lambda: _LOG.append('eval'), ordered=True)
    _JAX_EOS(self, d_idx, d_p, d_rho, d_e, d_cs)


def _sweeps(log):
    """The sweeps of each evaluation in a callback log (an evaluation
    that overflowed the JAX grid runs again: both are listed)."""
    out, n = [], 0
    for entry in log:
        if entry == 'eval':
            out.append(n)
            n = 0
        else:
            n += 1
    return out


_JAX = {}


def _jax_setup(monkeypatch):
    """The JAX side of a comparison: its sweeps counted, its cells'
    capacity ``JAX_CAPACITY_SLACK``."""
    monkeypatch.setattr(jax_basic.SummationDensity, 'post_loop',
                        _counting_post_loop)
    monkeypatch.setattr(jax_basic.IdealGasEOS, 'loop', _counting_eos)
    monkeypatch.setattr(GridSpec, 'from_particles',
                        classmethod(_roomy_cells))


def _domain(case, cls):
    box = CASES[case][4]
    return None if box is None else box(cls)


def _jax_case(case, monkeypatch):
    """The JAX evaluation of ``case``: (outputs, its sweeps)."""
    if case not in _JAX:
        _jax_setup(monkeypatch)
        if case.startswith('gsph'):
            monkeypatch.setattr(GridSpec, 'from_particles',
                                classmethod(_roomier_cells))
        make, dim = CASES[case][:2]
        arr = make(jax_gasd_array)
        _LOG.clear()
        ev = JaxEvaluator([arr], _scheme(jax_scheme, case).get_equations(),
                          dim=dim, kernel=JaxGaussian(dim=dim),
                          domain_manager=_domain(case, JaxDomain))
        ev.evaluate(t=0.0, dt=DT)
        jax.effects_barrier()
        _JAX[case] = ({p: np.asarray(arr.properties[p]).copy()
                       for p in OUT}, _sweeps(_LOG)[-1])
    return _JAX[case]


@pytest.fixture(scope='module')
def jax_cases():
    with pytest.MonkeyPatch.context() as mp:
        for case in CASES:
            _jax_case(case, mp)
    return _JAX


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('case', list(CASES))
def test_gas_equations_match_jax(case, engine, jax_cases):
    want, jax_sweeps = jax_cases[case]
    make, dim = CASES[case][:2]
    arr = make(get_particle_array_gasd)
    ev = SPHEvaluator([arr], _scheme(scheme, case).get_equations(), dim=dim,
                      kernel=Gaussian(dim=dim),
                      domain_manager=_domain(case, DomainManager),
                      config=Config(engine=engine, **CPU))
    a_eval = ev.func_eval
    assert set(a_eval.engine_choices.values()) == {engine}
    planned = {p.op for p in a_eval._plans.values() if p is not None}
    assert planned == ({gd.gasd_pair} if engine == 'kernel' else set())
    ev.evaluate(t=0.0, dt=DT)
    checked = 0
    for p, w in want.items():
        got = np.asarray(arr.properties[p])
        if np.abs(w).max() == 0.0:
            assert np.abs(got).max() == 0.0, (case, p)
            continue
        err = _scaled_err(got, w)
        assert err <= TOL, '%s %s: %.3g' % (case, p, err)
        checked += 1
    assert checked >= 15
    if case.startswith('mpm'):
        # the torch engine runs again until its lists' capacities hold,
        # and the JAX evaluation where its grid overflowed: the last ones
        assert a_eval.sweeps[-1] == jax_sweeps > 1
        np.testing.assert_array_equal(arr.converged, want['converged'])
        if engine == 'kernel':
            # one re-binning a sweep
            assert a_eval.binnings == sum(a_eval.sweeps)
    else:
        # two update_nnps groups, a re-binning after each, in each of the
        # two runs: the doubled h outgrows the periodic cells, and the
        # evaluation runs again on a grid re-sized for it
        assert not a_eval.has_iterated and jax_sweeps == 0
        assert a_eval.grid.grows == 1
        if engine == 'kernel':
            assert a_eval.binnings == 4


def _mpm_all_pairs(P, beta=2.0):
    """MPMAccelerations' au, av, ae and del2e of a 2D state (numpy
    arrays ``P``), summed over every pair with r < 3 max(hi, hj)."""
    fac = Gaussian(dim=2).fac
    x, y, h = P['x'], P['y'], P['h']
    xij, yij = x[:, None] - x[None], y[:, None] - y[None]
    r = np.sqrt(xij ** 2 + yij ** 2)
    near = r < 1e-8
    safe = np.where(r > 0, r, 1.0)

    def grad(hh):
        q = r / hh
        dw = np.where(q < 3, -2 * q * np.exp(-q * q), 0.0)
        t = np.where(r > 1e-12, dw * fac / hh ** 3 / safe, 0.0)
        return t * xij, t * yij

    hi, hj = np.broadcast_to(h[:, None], r.shape), np.broadcast_to(
        h[None], r.shape)
    dwi, dwj, dwij = grad(hi), grad(hj), grad(0.5 * (hi + hj))
    m, rho, p, cs, e, om = (P[k] for k in ('m', 'rho', 'p', 'cs', 'e',
                                           'omega'))
    pib = p / rho ** 2
    uij, vij = P['u'][:, None] - P['u'][None], P['v'][:, None] - P['v'][None]
    xn, yn = (np.where(near, 0.0, c / np.where(near, 1.0, r))
              for c in (xij, yij))
    dot = uij * xn + vij * yn
    fij = xn * dwij[0] + yn * dwij[1]
    cij = 0.5 * (cs[:, None] + cs[None])
    rhoij = 0.5 * (rho[:, None] + rho[None])
    vsig1 = 0.5 * np.maximum(2 * cij - beta * dot, 0.0)
    vsig2 = np.sqrt(np.abs(p[:, None] - p[None]) / rhoij)
    a1 = 0.5 * (P['alpha1'][:, None] + P['alpha1'][None])
    a2 = 0.5 * (P['alpha2'][:, None] + P['alpha2'][None])
    mj = m[None]
    visc = np.where(dot <= 0, mj / rhoij * a1 * vsig1 * dot, 0.0)
    eij = e[:, None] - e[None]
    out = {}
    for k, c in (('au', 0), ('av', 1)):
        out[k] = visc * dwij[c] - mj * (pib[:, None] * om[:, None] * dwi[c] +
                                        pib[None] * om[None] * dwj[c])
    out['ae'] = (np.where(dot <= 0, -0.5 * mj / rhoij * a1 * vsig1 * dot *
                          dot * fij, 0.0) +
                 mj * pib[:, None] * om[:, None] *
                 (uij * dwi[0] + vij * dwi[1]) +
                 mj / rhoij * a2 * vsig2 * eij * fij)
    eps = 0.01 * (0.5 * (hi + hj)) ** 2
    out['del2e'] = mj / rho[None] * eij / (r + eps) * fij
    support = r < 3.0 * np.maximum(hi, hj)
    return {k: np.where(support, v, 0.0).sum(axis=1) for k, v in out.items()}


def test_mpm_reads_the_last_sweeps_binning():
    """At the Sedov lattice's free edges the density iteration grows h
    by up to half: the momentum phase, on the binning of the iteration's
    last sweep, sums every pair in support (an all-pairs sum of its
    formula), which a binning from before the iteration would miss."""
    eqs = _scheme(scheme, 'mpm sedov').get_equations()
    pre = _sedov(get_particle_array_gasd)
    h0 = pre.h.copy()
    SPHEvaluator([pre], eqs[:2], dim=2, kernel=Gaussian(dim=2),
                 config=Config(**CPU)).evaluate(t=0.0, dt=DT)
    assert pre.h.max() > 1.3 * h0.max()
    arr = _sedov(get_particle_array_gasd)
    SPHEvaluator([arr], eqs, dim=2, kernel=Gaussian(dim=2),
                 config=Config(**CPU)).evaluate(t=0.0, dt=DT)
    want = _mpm_all_pairs({k: np.asarray(v, dtype=float)
                           for k, v in pre.properties.items()})
    for p, w in want.items():
        assert _scaled_err(np.asarray(arr.properties[p]), w) <= 1e-12, p


def test_every_gas_class_is_ported():
    """The port's classes of ``GasDScheme``, ``ADKEScheme`` and
    ``GSPHScheme`` have the JAX classes' methods with the same arguments;
    the particle arrays the same props and output arrays."""
    from pysph_tpu.sph.gas_dynamics import gsph as jax_gsph
    from pysph_tpu_torch.sph.gas_dynamics import gsph
    classes = [(basic, jax_basic, name) for name in (
        'ScaleSmoothingLength', 'UpdateSmoothingLengthFromVolume',
        'SummationDensity', 'IdealGasEOS', 'MPMAccelerations',
        'SummationDensityADKE', 'ADKEAccelerations', 'ADKEUpdateGhostProps')]
    classes += [(gsph, jax_gsph, name) for name in (
        'GSPHGradients', 'GSPHUpdateGhostProps', 'GSPHAcceleration')]
    for mod, jax_mod, name in classes:
        mine, theirs = getattr(mod, name), getattr(jax_mod, name)
        for m in ('__init__', 'initialize', 'loop', 'post_loop',
                  'converged', 'reduce', 'interpolate'):
            a, b = getattr(mine, m, None), getattr(theirs, m, None)
            assert (a is None) == (b is None), (name, m)
            if a is not None:
                assert inspect.signature(a) == inspect.signature(b), (name,
                                                                      m)
    a, b = get_particle_array_gasd(), jax_gasd_array()
    assert set(a.properties) == set(b.properties)
    assert a.output_property_arrays == b.output_property_arrays


# -- the runs ------------------------------------------------------------------
#: {run: (module, class, arguments)}
RUNS = {
    'shocktube': ('gas_dynamics.shocktube', 'ShockTube', ['--nl', '40']),
    'sedov': ('gas_dynamics.sedov', 'SedovPointExplosion', ['--nx', '21']),
}
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'e', 'h', 'omega', 'alpha1',
              'alpha2', 'converged')


def _cls(package, run):
    mod, name, _ = RUNS[run]
    return getattr(importlib.import_module('%s.examples.%s' % (package, mod)),
                   name)


def _argv(run, extra=()):
    return ['--disable-output', '-q', '--max-steps', '3', '--dt',
            repr(DT)] + RUNS[run][2] + list(extra)


_RUNS = {}


def _seed(run, particles):
    """The shock tube's start moved by up to a tenth of its spacing, with
    seeded velocities; the Sedov blast's h0 set to its h, so that its
    initial evaluation converges (the example's h0 is 0, so that it
    sweeps max_iterations, 250 times: ``chip_smoke.py`` runs that start
    on the card)."""
    props = particles[0].properties
    n = particles[0].get_number_of_particles()
    if run == 'sedov':
        props['h0'][:] = props['h']
        return
    rng = np.random.default_rng(9)
    dx = props['m'] / props['rho']
    props['x'][:n] += 0.1 * dx[:n] * rng.uniform(-1, 1, n)
    props['u'][:n] += 0.1 * rng.normal(size=n)


def _jax_run(run, monkeypatch):
    """The JAX app's one evaluation and three steps of its start: (the
    evaluation's outputs and sweeps, step outputs, t, inputs, the sweeps
    of each evaluation of the run)."""
    if run in _RUNS:
        return _RUNS[run]
    _jax_setup(monkeypatch)
    tmp = tempfile.mkdtemp()
    try:
        app = _cls('pysph_tpu', run)()
        app.setup(['-d', tmp] + _argv(run))
        _seed(run, app.particles)
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()},
                            dict(pa.stride)) for pa in app.particles}
        s = app.solver
        # the per-step loop, as the port's on the card: the JAX chunk
        # carries t and dt in float32 (ROADMAP Queue 3)
        s.chunk_steps = 1
        s._sync_to_device()
        _LOG.clear()
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
        n = app.particles[0].get_number_of_particles()
        evals = {p: np.asarray(states['fluid'][p])[:n].copy() for p in OUT}
        jax.effects_barrier()
        one = _sweeps(_LOG)[-1]
        _LOG.clear()
        app.solve()
        jax.effects_barrier()
        pa = app.particles[0]
        steps = {p: np.asarray(pa.properties[p])[:n].copy()
                 for p in STEP_PROPS}
        assert s.count == 3
        _RUNS[run] = ((evals, one), steps, s.t, inputs, _sweeps(_LOG))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _RUNS[run]


@pytest.fixture(scope='module')
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        for run in RUNS:
            _jax_run(run, mp)
    return _RUNS


def _port_start(run, engine='kernel'):
    """The port's app on the JAX app's start, in the per-step loop, as on
    the card (a CPU chunk sweeps its inactive steps too)."""
    inputs = _RUNS[run][3]
    app = _cls('pysph_tpu_torch', run)()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine] +
              _argv(run))
    s = app.solver
    s.chunk_steps = 1
    s.particles = app.particles = [ParticleArray.from_numpy(name, *args)
                                   for name, args in inputs.items()]
    s._sync_to_device()
    assert set(s.acceleration_evals[0].engine_choices.values()) == {engine}
    return app


def _check(got, want, tol, label):
    checked = 0
    for p, w in want.items():
        g = got(p)
        if np.abs(w).max() == 0.0:
            assert np.abs(g).max() == 0.0, (label, p)
            continue
        err = _scaled_err(g, w)
        assert err <= tol, '%s %s: %.3g' % (label, p, err)
        checked += 1
    return checked


@pytest.mark.parametrize('run,engine', [
    ('shocktube', 'kernel'), ('shocktube', 'torch'), ('sedov', 'kernel')])
def test_one_eval_matches_jax(run, engine, jax_runs):
    """The example's initial evaluation (the shock tube's h jumping at its
    diaphragm); the Sedov lattice's free edges on the kernel engine (the
    torch engine: ``test_gas_equations_match_jax``)."""
    (evals, sweeps), _, _, _, _ = jax_runs[run]
    app = _port_start(run, engine)
    s = app.solver
    a_eval = s.acceleration_evals[0]
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    # the torch engine runs again until its lists' capacities hold
    assert a_eval.sweeps[-1] == sweeps
    st = s.states['fluid']
    assert _check(lambda p: st[p].numpy(), evals, TOL, run) >= 12


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run, jax_runs):
    _, steps, t, _, sweeps = jax_runs[run]
    app = _port_start(run)
    s = app.solver
    a_eval = s.acceleration_evals[0]
    app.solve()
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    # the initial evaluation's and each step's (the JAX app runs an
    # evaluation again where its grid overflowed)
    assert a_eval.sweeps == sweeps[-4:]
    pa = app.particles[0]
    assert _check(lambda p: np.asarray(pa.properties[p]), steps, STEP_TOL,
                  run) >= 8


# -- the plain version and the planner ---------------------------------------
def _torch_engine(plan, args):
    """The call's outputs from the torch pair engine at capacities that
    hold every candidate (the evaluator's path)."""
    dest, dest_cells, wm, pre, sources, grid, kernel = args
    store = dict(dest)
    store.update(pre)
    n = dest['x'].shape[0]
    for src, cells, gs in sources:
        cap = PairCapacity('cpu')
        cap.candidates = cap.pairs = n * src['x'].shape[0]
        run_pair_phase(list(gs.equations), store, src, dest_cells, cells,
                       grid, kernel, wm, 0.0, 0.0, cap=cap)
    return {p: store[p] for p in pre}


@pytest.mark.parametrize('run,size', [('shocktube', 40), ('sedov', 11)])
def test_plain_version_matches_the_torch_engine(run, size):
    calls, _, _ = gasd_check.calls(run, size, torch.float64, device='cpu')
    assert [c[2].sources[0].terms for c in calls] == [gd.SDEN, gd.MPM]
    for _, _, plan, args in calls:
        ref = gd.gasd_pair_reference(*args, counts=True)
        eng = _torch_engine(plan, args)
        for p in plan.outputs:
            assert _scaled_err(ref[p].numpy(), eng[p].numpy()) <= 1e-13, p
        # each dest's pairs in support, counted by brute force
        dest = args[0]
        xyz = torch.stack([dest[c] for c in 'xyz'], 1).numpy()
        h = dest['h'].numpy()
        r = np.linalg.norm(xyz[:, None] - xyz[None], axis=2)
        sup = 3.0 * np.maximum(h[:, None], h[None])
        np.testing.assert_array_equal(ref['nnbr'].numpy(),
                                      (r < sup).sum(axis=1))
    # the tool's check of the kernel (here its plain version) passes
    assert gasd_check.check(calls, run, TOL)['pairs'] > 0


def test_ghi_plain_matches_gradient_h():
    for dim in (1, 2):
        assert gasd_check.gradient_h(dim, torch.float64, 'cpu') <= 1e-14


def _planned(equations, kernel, caplog):
    arr = _sedov(get_particle_array_gasd)
    grid = CellGrid.from_particles([arr], dim=2, radius_scale=3.0)
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        a_eval = AccelerationEval([arr], equations, kernel,
                                  Config(engine='kernel', **CPU), grid)
    return a_eval


def test_planner_takes_the_two_sets_and_refuses_others(caplog):
    a_eval = _planned(_scheme(scheme, 'mpm sedov').get_equations(),
                      Gaussian(dim=2), caplog)
    plans = [a_eval._plans.get((id(g), 'fluid'))
             for g in a_eval.leaf_groups()]
    assert [p.sources[0].terms for p in plans if p is not None] == [
        gd.SDEN, gd.MPM]
    assert [p.outputs for p in plans if p is not None] == [
        gd.OUTPUTS[:6], gd.OUTPUTS[6:]]
    # a mixed group on the torch engine, refused and logged
    mixed = [Group([basic.SummationDensity('fluid', ['fluid'], dim=2),
                    basic.MPMAccelerations('fluid', ['fluid'])])]
    caplog.clear()
    a_eval = _planned(mixed, Gaussian(dim=2), caplog)
    assert set(a_eval.engine_choices.values()) == {'torch'}
    assert "gasd: MPMAccelerations reads 'rho'" in caplog.text
    # another kind planned onto gasd_pair as well; a 1D kernel, which has
    # no shape function in the pair kernels, raises rather than run the
    # sets on the torch engine
    a_eval = _planned(_scheme(scheme, 'mpm sedov').get_equations(),
                      CubicSpline(dim=2), caplog)
    assert [p.op for p in a_eval._plans.values() if p is not None] == [
        gd.gasd_pair] * 2
    with pytest.raises(NotImplementedError, match='item 28'):
        _planned(_scheme(scheme, 'mpm sedov').get_equations(),
                 WendlandQuinticC2_1D(dim=1), caplog)


def test_another_kind_is_planned_onto_gasd_pair():
    """The shock tube under ``--kernel QuinticSpline`` (kind 3, a 1D
    shape): both sets planned onto ``gasd_pair``, and the tool's check of
    the kernel (here its plain version) passes."""
    calls, _, _ = gasd_check.calls('shocktube', 40, torch.float64,
                                   device='cpu',
                                   extra=('--kernel', 'QuinticSpline'))
    assert [c[2].op for c in calls] == [gd.gasd_pair] * 2
    assert {kernel_kind(c[3][6]) for c in calls} == {3}
    assert gasd_check.check(calls, 'QuinticSpline', TOL)['pairs'] > 0


def test_update_nnps_groups_are_taken():
    assert Group([], update_nnps=True).update_nnps
    assert Group([], update_nnps=True, iterate=True,
                 max_iterations=5).update_nnps
    assert not Group([]).update_nnps
    with pytest.raises(NotImplementedError, match='item 21'):
        Group([], update_nnps=True, condition=lambda t, dt: True)


@pytest.mark.parametrize('kw,item', [(dict(solids=['wall']), 'item 28'),
                                     (dict(has_ghosts=True), 'item 27')])
def test_gasd_scheme_refuses_walls_and_ghosts(kw, item):
    args = dict(fluids=['fluid'], solids=[], dim=2, gamma=1.4,
                kernel_factor=1.2)
    args.update(kw)
    s = scheme.GasDScheme(**args)
    for call in (s.get_equations, s.configure_solver,
                 lambda: s.setup_properties([])):
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_reduce_view_active_matches_jax():
    """Every row of a state, ghosts (tag != 0) too: the JAX evaluator's
    ``active`` is its rows below ``n_act`` (its padding aside), and the
    port's states hold no padding."""
    tag = np.zeros(37, dtype=int)
    tag[::5] = 2
    jarr = jax_gasd_array(name='fluid', x=np.arange(37.0), tag=tag)
    state, _ = jarr.to_device()
    want = np.asarray(jax_active(state))
    assert want.sum() == 37 and not want[37:].any()
    arr = get_particle_array_gasd(name='fluid', x=np.arange(37.0), tag=tag)
    view = ReduceView(arr.to_device(Config(**CPU)), None)
    np.testing.assert_array_equal(view.active.numpy(), want[:37])


def test_plain_binning_takes_nan():
    """A NaN h is not binned: the re-binning of an ``update_nnps`` group
    reads nothing, and where a position or h is not finite the binning
    keeps the handle as it was (such an h would pile every particle into
    one cell) and sets the grid's ``nonfinite`` flag, which
    ``check_finite`` (the solver's read) turns into
    ``FloatingPointError``; a torch engine list that dropped pairs no
    longer stops it (the solver reads ``pair_overflow`` and redoes)."""
    arr = _sedov(get_particle_array_gasd, nx=7)
    grid = CellGrid.from_particles([arr], dim=2, radius_scale=3.0)
    a_eval = AccelerationEval([arr], _scheme(scheme, 'mpm sedov')
                              .get_equations(), Gaussian(dim=2),
                              Config(engine='kernel', **CPU), grid)
    states = {'fluid': arr.to_device(Config(**CPU))}
    cells = a_eval._rebin_into(states, a_eval.groups[0]).lists
    assert a_eval.binnings == 1 and int(cells['fluid'].end.max()) > 0
    assert int(a_eval.rebuilds) == 1
    kept = [t.clone() for t in cells['fluid']]
    grid.check_finite()
    st = states['fluid']
    st['h'] = st['h'].clone()
    st['h'][3] = float('nan')
    cells = a_eval._rebin_into(states, a_eval.groups[0]).lists
    assert all(torch.equal(a, b) for a, b in zip(cells['fluid'], kept))
    assert bool(grid.nonfinite) and int(a_eval.rebuilds) == 1
    with pytest.raises(FloatingPointError, match='not finite'):
        grid.check_finite()
    assert not bool(grid.nonfinite)
    st['h'][3] = st['h'][2]
    grid.pair_overflow = torch.ones((), dtype=torch.bool)
    a_eval._rebin_into(states, a_eval.groups[0])
    grid.pair_overflow = None
    grid.check_finite()
    assert a_eval.binnings == 3 and int(a_eval.rebuilds) == 2


def test_a_link_does_not_span_a_rebinning(caplog):
    """A linked pair reads its emitter's neighbour list: where a group
    from the emitter's to the consumer's re-bins (``update_nnps``), the
    planner does not link them (the Taylor-Green vortex's TVF pair, its
    density group marked)."""
    from pysph_tpu_torch.examples.taylor_green import TaylorGreen
    app = TaylorGreen()
    app.setup(['--device', 'cpu', '--use-double', '--nx', '10',
               '--disable-output', '-q'])
    s = app.solver
    a_eval, = s.acceleration_evals
    assert any(p is not None and p.link is not None
               for p in a_eval._plans.values())
    groups = app.scheme.get_equations()
    groups[0].update_nnps = True
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        other = AccelerationEval(app.particles, groups, s.kernel, s.config,
                                 s.grid)
    assert all(p is None or p.link is None for p in other._plans.values())
    assert 'a group between them re-bins (update_nnps)' in caplog.text


def test_chip_smoke_holds_the_frozen_jax_figures():
    """``chip_smoke.py``'s gas gates hold the port to what
    ``tests/jax_gasd_figures.py`` printed: the shock tube and the Sedov
    blast under ``mpm``, and the accuracy test, the hydrostatic box and
    the shock tube under the new schemes."""
    import jax_gasd_figures
    path = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.JAX_SHOCKTUBE == jax_gasd_figures.FROZEN['shocktube']
    assert chip_smoke.JAX_SEDOV == jax_gasd_figures.FROZEN['sedov']
    frozen = jax_gasd_figures.FROZEN
    assert chip_smoke.JAX_ACCURACY == frozen['accuracy_test_2d']
    assert chip_smoke.JAX_HYDROSTATIC == frozen['hydrostatic_box']
    assert chip_smoke.JAX_SHOCKTUBE_SCHEMES == frozen['shocktube schemes']
    assert set(chip_smoke.JAX_ACCURACY) == set(
        chip_smoke.JAX_HYDROSTATIC) == {'gsph', 'mpm', 'adke'}
    assert set(chip_smoke.JAX_SHOCKTUBE_SCHEMES) == {'gsph', 'adke'}
