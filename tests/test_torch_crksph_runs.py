"""The examples' ``crksph`` runs against the JAX apps, float64 on the CPU:
``accuracy_test_2d --scheme crksph`` (16^2), ``hydrostatic_box`` (its
default scheme, nx = 16) and ``taylor_green --scheme crksph`` (nx = 16,
``LaminarViscosity``), all periodic in x and y: the initial evaluation of
the example's start (its positions moved by up to a tenth of its
spacing, its velocities seeded) at 1e-10 of ``max|ref|`` and three steps
of the solver's per-step loop at 1e-9, every pair phase of both
evaluators on the kernel engine (on the CPU ``crksph_pair``'s plain
version); and six steps in chunks of four equal to the per-step loop
bit for bit.  The JAX apps run per step (``chunk_steps = 1``: the JAX
chunk carries a fixed dt as float32, ROADMAP Queue 3).
"""

import importlib
import shutil
import tempfile

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
STEP_TOL = 1e-9
#: {run: (module under examples/, class, arguments)}
RUNS = {
    'accuracy': ('gas_dynamics.accuracy_test_2d', 'AccuracyTest2D',
                 ['--nparticles', '16', '--scheme', 'crksph']),
    'hydrostatic': ('gas_dynamics.hydrostatic_box', 'HydrostaticBox',
                    ['--nx', '16']),
    'taylor_green': ('taylor_green', 'TaylorGreen',
                     ['--nx', '16', '--scheme', 'crksph']),
}
#: what the evaluations write
OUT = ('V', 'ai', 'bi', 'gradai', 'gradbi', 'rho', 'rhofac', 'p', 'cs',
       'gradv', 'au', 'av', 'ae', 'crk_m2', 'crk_gm2')
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'e', 'ae', 'au', 'av')


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _cls(package, run):
    mod, name = RUNS[run][:2]
    return getattr(importlib.import_module(
        '%s.examples.%s' % (package, mod)), name)


def _argv(run, steps=3):
    return ['--disable-output', '-q', '--max-steps', str(steps)] + \
        RUNS[run][2]


def _seed(particles):
    """Seeded velocities, and positions moved by up to a tenth of the
    spacing (m / rho)^(1 / 2); where the example leaves e at 0 (the
    Taylor-Green vortex, whose pressure is then 0 and whose e the
    seeded velocities' energy equation would take below 0, where cs is
    NaN), a seeded e near 1."""
    props = particles[0].properties
    n = particles[0].get_number_of_particles()
    rng = np.random.default_rng(11)
    for c in ('u', 'v'):
        props[c][:n] += 0.1 * rng.normal(size=n)
    if not props['e'][:n].any():
        props['e'][:n] = 1.0 + 0.1 * rng.random(n)
    dx = np.sqrt(props['m'][:n] / props['rho'][:n])
    for c in 'xy':
        props[c][:n] += 0.1 * dx * rng.uniform(-1, 1, n)


_RUNS = {}


def _jax_run(run):
    """The JAX app's initial evaluation and three steps of its seeded
    start: (evaluation outputs, step outputs, t, inputs)."""
    if run in _RUNS:
        return _RUNS[run]
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
            # the jittered start overfills a cell of the setup's capacity
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
        n = app.particles[0].get_number_of_particles()
        evals = {p: np.asarray(states['fluid'][p])[:n].ravel().copy()
                 for p in OUT}
        app.solve()
        pa = app.particles[0]
        steps = {p: np.asarray(pa.properties[p]).copy() for p in STEP_PROPS}
        assert s.count == 3
        _RUNS[run] = (evals, steps, s.t, inputs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _RUNS[run]


@pytest.fixture(scope='module')
def jax_runs():
    for run in RUNS:
        _jax_run(run)
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
    for a_eval in s.acceleration_evals:
        assert set(a_eval.engine_choices.values()) == {'kernel'}
    assert len(s.acceleration_evals) == 2
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
    assert _check(lambda p: st[p].numpy().ravel(), evals, TOL, run) >= 10


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run, jax_runs):
    _, steps, t, _ = jax_runs[run]
    app = _port_start(run)
    s = app.solver
    app.solve()
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    pa = app.particles[0]
    assert _check(lambda p: np.asarray(pa.properties[p]), steps, STEP_TOL,
                  run) >= 8


@pytest.mark.parametrize('run', list(RUNS))
def test_chunks_equal_the_per_step_loop(run, jax_runs):
    states = []
    for chunk_steps in (1, 4):
        app = _port_start(run, steps=6, chunk_steps=chunk_steps)
        app.solve()
        s = app.solver
        assert s.count == 6
        states.append({p: v.clone() for p, v in s.states['fluid'].items()})
    for p, v in states[0].items():
        assert torch.equal(v, states[1][p]), (run, p)
