"""``WCSPHScheme``'s remaining options against pysph_tpu, float64 on the
CPU: ``--tensile-correction``, ``--summation-density``, ``--delta-sph``
on the periodic box and the kernels ``WendlandQuinticC4``,
``WendlandQuinticC6`` and ``SuperGaussian``, each on the Taylor-Green
vortex's ``--scheme wcsph`` at nx=20 from ``--perturb 0.1`` and a seeded
density jitter (``test_torch_tg_schemes.py``'s start).

- One evaluation to 1e-10 of ``max|ref|`` against the JAX XLA engine,
  every pair phase on the kernel engine (``wcsph_pair``, and for
  ``--delta-sph`` the linked ``delta_pair`` pair on the periodic grid;
  their plain versions here).
- Three steps to 1e-9 in x y u v p rho.
- The chunks against the per-step loop (``time_chunks.gate``, the gates
  the card runs: 30 steps at nx=40 with particles wrapping).
- The plain kernels (the term masks' equations) against the torch
  engine running the scheme's own groups.
- One evaluation of ``dam_break_3d --tensile-correction`` at dx=0.12
  (the size of the other dam_break_3d parity tests: at dx=0.04 the JAX
  XLA engine asks for ~114 GB) against JAX: 3D, three sources and the
  Hughes-Graham walls' pressure in the correction's ``R_j``.
"""

import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu.config import get_config
from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401
from test_torch_tg_schemes import (
    ARGV, STEP_PROPS, _jax_app, _jitter, _port_app, _scaled_err, _snapshot)

OPTIONS = time_chunks.WCSPH_OPTIONS
#: what one evaluation writes
EVAL_OUT = ('p', 'cs', 'arho', 'au', 'av', 'ax', 'ay', 'dt_cfl')
#: the kernel ops each option's pair phases take, and the bit of the
#: term masks that shows its terms
OPS = {'delta': {wp.wcsph_pair, dl.delta_pair}}
TERM = {'delta': wp.DCONT | wp.DMOM | wp.LVD, 'summation': wp.SDEN,
        'tensile': wp.TENS}
EVAL_TOL = 1e-10
STEP_TOL = 1e-9


def _argv(name):
    return ARGV + list(OPTIONS[name])


def _outputs(name):
    return EVAL_OUT + (('rho',) if name == 'summation' else ())


def _jax_first_eval(app, arrays, outputs):
    """The solver's initial evaluation of a set-up pysph_tpu app in its
    XLA engine (with the grid's overflow redo that ``solve`` does):
    {array: {prop: ndarray}}."""
    s = app.solver
    s._sync_to_device()
    states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
    if s._check_overflow(diag):
        s._handle_overflow(diag)
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
    assert not s._check_overflow(diag)
    states = s._mat_fn(states, carry)
    sizes = {pa.name: pa.get_number_of_particles() for pa in app.particles}
    return {a: {p: np.asarray(states[a][p])[:sizes[a]] for p in outputs}
            for a in arrays}


@pytest.fixture(scope='module')
def jax_evals():
    """{option: ({prop: ndarray}, the input snapshot)}."""
    cfg = get_config()
    old = cfg._use_pallas
    out = {}
    try:
        cfg.use_pallas = False
        for name in OPTIONS:
            tmp = tempfile.mkdtemp()
            try:
                app = _jax_app(tmp, 'wcsph', _argv(name))
                _jitter(app.particles)
                inputs = _snapshot(app.particles)
                ref = _jax_first_eval(app, ('fluid',), _outputs(name))
                out[name] = ref['fluid'], inputs
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        cfg._use_pallas = old
    return out


def _port_eval(name, engine, inputs):
    s = _port_app('wcsph', engine, _argv(name), inputs).solver
    a_eval = s.acceleration_evals[0]
    a_eval.update_and_compute(0.0, s.dt, s.states)
    return s, a_eval


@pytest.mark.parametrize('name', list(OPTIONS))
def test_one_eval_matches_jax(name, jax_evals):
    ref, inputs = jax_evals[name]
    s, a_eval = _port_eval(name, 'kernel', inputs)
    assert s.grid.is_periodic
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = [p for p in a_eval._plans.values() if p is not None]
    assert {p.op for p in plans} == OPS.get(name, {wp.wcsph_pair})
    terms = 0
    for p in plans:
        for ps in p.sources:
            terms |= ps.terms
    assert terms & TERM.get(name, 0) == TERM.get(name, 0)
    for p, want in ref.items():
        err = _scaled_err(s.states['fluid'][p].numpy(), want)
        assert err <= EVAL_TOL, '%s %s: scaled error %.3g' % (name, p, err)


@pytest.mark.parametrize('name', list(OPTIONS))
def test_three_steps_match_jax(name):
    argv = _argv(name) + ['--max-steps', '3']
    tmp = tempfile.mkdtemp()
    try:
        ref = _jax_app(tmp, 'wcsph', argv)
        _jitter(ref.particles)
        ref.solver._sync_to_device()
        inputs = _snapshot(ref.particles)
        ref.solve()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = _port_app('wcsph', 'kernel', argv, inputs)
    port.solve()
    s = port.solver
    assert s.count == ref.solver.count == 3
    assert abs(s.t - ref.solver.t) <= STEP_TOL * ref.solver.t
    got, want = port.particles[0], ref.particles[0]
    for p in STEP_PROPS:
        err = _scaled_err(getattr(got, p), np.asarray(getattr(want, p)))
        assert err <= STEP_TOL, '%s %s after 3 steps: %.3g' % (name, p, err)


@pytest.mark.parametrize('name', list(OPTIONS))
def test_chunks_match_the_per_step_loop(name):
    held = time_chunks.gate('taylor_green wcsph %s nx=40' % name, 'cpu')
    assert held['steps'] == time_chunks.GATE_STEPS
    assert held['max_scaled_err'] <= time_chunks.TOL
    assert held['rebuilds'] >= 2


@pytest.mark.parametrize('name', list(OPTIONS))
def test_plain_kernels_equal_the_torch_engine(name, jax_evals):
    """The kernels' plain versions (the torch pair engine running the
    equations that the plans' term masks stand for) against the torch
    engine running the scheme's own groups."""
    _, inputs = jax_evals[name]
    got, _ = _port_eval(name, 'kernel', inputs)
    want, a_eval = _port_eval(name, 'torch', inputs)
    assert set(a_eval.engine_choices.values()) == {'torch'}
    for p in _outputs(name):
        err = _scaled_err(got.states['fluid'][p].numpy(),
                          want.states['fluid'][p].numpy())
        assert err <= 1e-13, '%s %s: %.3g' % (name, p, err)


def test_dam_break_3d_tensile_eval_matches_jax():
    """dam_break_3d ``--tensile-correction`` at dx=0.12: the fluid's call
    over its three sources takes ``TENS``, whose ``R_j`` reads the
    boundary's Hughes-Graham pressure."""
    argv = ['--dx', '0.12', '--disable-output', '-q',
            '--tensile-correction']
    arrays = ('fluid', 'boundary')
    outputs = ('p', 'arho', 'au', 'av', 'aw', 'dt_cfl')
    cfg = get_config()
    old = cfg._use_pallas
    tmp = tempfile.mkdtemp()
    try:
        cfg.use_pallas = False
        app = JaxDamBreak3D()
        app.setup(['-d', tmp] + argv)
        inputs = _snapshot(app.particles)
        ref = _jax_first_eval(app, arrays, outputs)
    finally:
        cfg._use_pallas = old
        shutil.rmtree(tmp, ignore_errors=True)
    port = DamBreak3D()
    port.setup(['--use-double', '--device', 'cpu'] + argv)
    s = port.solver
    s.particles = port.particles = [
        ParticleArray.from_numpy(name, *args)
        for name, args in inputs.items()]
    s._sync_to_device()
    a_eval = s.acceleration_evals[0]
    a_eval.update_and_compute(0.0, s.dt, s.states)
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    tensile = [ps for p in a_eval._plans.values() if p is not None
               for ps in p.sources if ps.terms & wp.TENS]
    assert len(tensile) == 3
    for a in arrays:
        for p, want in ref[a].items():
            err = _scaled_err(s.states[a][p].numpy(), want)
            assert err <= EVAL_TOL, '%s.%s: scaled error %.3g' % (a, p, err)
