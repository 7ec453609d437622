"""The examples' ``tsph`` runs, and Cheng-Shu's ``gsph``, against the JAX
apps, float64 on the CPU: ``accuracy_test_2d --scheme tsph`` (16^2) and
``hydrostatic_box --scheme tsph`` (nx = 16), periodic in x and y, and
``cheng_shu_1d`` (100 particles, 1D, periodic in x) under ``--scheme
tsph`` and ``--scheme gsph``: the initial evaluation of the example's
start (its positions moved by up to a tenth of its spacing, its
velocities seeded) at 1e-10 of ``max|ref|`` and three steps of the
solver's per-step loop at 1e-9, every pair phase on the kernel engine (on
the CPU the kernels' plain versions: ``tsph_pair``'s and
``tsph_sweep``'s; ``gsph_pair``'s and ``gasd_pair``'s); six steps in
chunks of four equal to the per-step loop bit for bit, the iterated
density group swept on its ``SweepPlan`` (no host loop: a chunk on the
card is eligible); and the frozen JAX figures of ``chip_smoke.py``'s
gates (``tests/jax_gasd_figures.py``) are its ``FROZEN`` entries.  The
JAX apps run per step on ``ROOMY`` cells (``GSPHScheme``'s first
evaluation doubles h past the periodic cells that the JAX package keeps,
ROADMAP Queue 3).
"""

import importlib
import shutil
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
import jax_gasd_figures
from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
STEP_TOL = 1e-9
#: {run: (module under examples/gas_dynamics, class, arguments)}
RUNS = {
    'accuracy tsph': ('accuracy_test_2d', 'AccuracyTest2D',
                      ['--nparticles', '16', '--scheme', 'tsph']),
    'hydrostatic tsph': ('hydrostatic_box', 'HydrostaticBox',
                         ['--nx', '16', '--scheme', 'tsph']),
    'cheng_shu tsph': ('cheng_shu_1d', 'ChengShu',
                       ['--n-particles', '100', '--scheme', 'tsph']),
    'cheng_shu gsph': ('cheng_shu_1d', 'ChengShu',
                       ['--n-particles', '100', '--scheme', 'gsph']),
}
#: what the evaluations write
OUT = ('rho', 'h', 'p', 'cs', 'au', 'av', 'ae', 'arho', 'n', 'an', 'dndh',
       'drhosumdh', 'ah', 'divv', 'alpha', 'gradv', 'invtt', 'converged',
       'px', 'ux', 'grhox')
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'e', 'h', 'n')
_FROM_PARTICLES = GridSpec.from_particles.__func__


def _roomy(cls, *args, **kw):
    for k, v in jax_gasd_figures.ROOMY.items():
        kw.setdefault(k, v)
    return _FROM_PARTICLES(cls, *args, **kw)


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _cls(package, run):
    mod, name = RUNS[run][:2]
    return getattr(importlib.import_module(
        '%s.examples.gas_dynamics.%s' % (package, mod)), name)


def _argv(run, steps=3):
    return ['--disable-output', '-q', '--max-steps', str(steps)] + \
        RUNS[run][2]


def _seed(particles):
    """Seeded velocities, and positions moved by up to a tenth of the
    spacing (m / rho)^(1 / dim)."""
    props = particles[0].properties
    n = particles[0].get_number_of_particles()
    rng = np.random.default_rng(13)
    dim = 1 if np.ptp(props['y'][:n]) == 0.0 else 2
    for c in 'uv'[:dim]:
        props[c][:n] += 0.1 * rng.normal(size=n)
    dx = (props['m'][:n] / props['rho'][:n]) ** (1.0 / dim)
    for c in 'xy'[:dim]:
        props[c][:n] += 0.1 * dx * rng.uniform(-1, 1, n)


_RUNS = {}


def _jax_run(run, monkeypatch):
    """The JAX app's initial evaluation and three steps of its seeded
    start: (evaluation outputs, step outputs, t, inputs)."""
    if run in _RUNS:
        return _RUNS[run]
    monkeypatch.setattr(GridSpec, 'from_particles', classmethod(_roomy))
    tmp = tempfile.mkdtemp()
    try:
        app = _cls('pysph_tpu', run)()
        app.setup(['-d', tmp] + _argv(run))
        _seed(app.particles)
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()},
                            dict(pa.stride)) for pa in app.particles}
        s = app.solver
        s.chunk_steps = 1
        s._sync_to_device()
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
        n = app.particles[0].get_number_of_particles()
        evals = {p: np.asarray(states['fluid'][p])[:n].ravel().copy()
                 for p in OUT if p in states['fluid']}
        app.solve()
        pa = app.particles[0]
        steps = {p: np.asarray(pa.properties[p])[:n].copy()
                 for p in STEP_PROPS if p in pa.properties}
        assert s.count == 3
        _RUNS[run] = (evals, steps, s.t, inputs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        monkeypatch.undo()
    return _RUNS[run]


@pytest.fixture(scope='module')
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        for run in RUNS:
            _jax_run(run, mp)
    return _RUNS


def _port_start(run, steps=3, chunk_steps=1):
    """The port's app on the JAX app's start."""
    inputs = _RUNS[run][3]
    app = _cls('pysph_tpu_torch', run)()
    app.setup(['--use-double', '--device', 'cpu'] + _argv(run, steps))
    s = app.solver
    s.chunk_steps = chunk_steps
    s.particles = app.particles = [ParticleArray.from_numpy(name, *args)
                                   for name, args in inputs.items()]
    s._sync_to_device()
    a_eval = s.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    if run.endswith('tsph'):
        [sweep] = a_eval.sweep_plans()
        assert sweep.op is ts.tsph_sweep and sweep.link is not None
        assert not a_eval.host_iterated
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


@pytest.mark.parametrize('run', list(RUNS))
def test_one_eval_matches_jax(run, jax_runs):
    evals = jax_runs[run][0]
    app = _port_start(run)
    s = app.solver
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    st = s.states['fluid']
    assert _check(lambda p: st[p].numpy().ravel(), evals, TOL, run) >= 6


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run, jax_runs):
    _, steps, t, _ = jax_runs[run]
    app = _port_start(run)
    s = app.solver
    app.solve()
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    pa = app.particles[0]
    assert _check(lambda p: np.asarray(pa.properties[p]), steps, STEP_TOL,
                  run) >= 5


@pytest.mark.parametrize('run', [r for r in RUNS if r.endswith('tsph')])
def test_chunks_equal_the_per_step_loop(run, jax_runs):
    states, sweeps = [], []
    for chunk_steps in (1, 4):
        app = _port_start(run, steps=6, chunk_steps=chunk_steps)
        s = app.solver
        assert s._chunk_eligible() == (chunk_steps > 1)
        app.solve()
        assert s.count == 6
        states.append({p: v.clone() for p, v in s.states['fluid'].items()})
        sweeps.append(list(s.acceleration_evals[0].sweeps))
    for p, v in states[0].items():
        assert torch.equal(v, states[1][p]), (run, p)
    assert sweeps[0] == sweeps[1] and len(sweeps[0]) == 7, run


def test_frozen_figures_are_chip_smoke_s():
    """The figures ``chip_smoke.py`` holds the card's TSPH runs and
    Cheng-Shu's gsph run to are the JAX package's as
    ``tests/jax_gasd_figures.py`` printed them."""
    frozen = jax_gasd_figures.FROZEN
    assert chip_smoke.JAX_TSPH['accuracy'] == (
        32, frozen['tsph']['accuracy_test_2d 32'])
    for k in ('hydrostatic_box', 'sedov', 'cheng_shu_1d'):
        key = 'hydrostatic' if k == 'hydrostatic_box' else k
        assert chip_smoke.JAX_TSPH[key] == frozen['tsph'][k], k
    assert chip_smoke.JAX_CHENG_SHU_GSPH == frozen['cheng_shu_1d gsph']
