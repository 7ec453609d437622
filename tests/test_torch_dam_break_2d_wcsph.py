"""dam_break_2d ``--scheme wcsph`` (the reference's default) against
pysph_tpu, float64 on the CPU, dx=0.1 (231 fluid and 532 wall
particles): ``PECIntegrator``, ``WendlandQuintic(dim=2)``, adaptive dt,
the Hughes-Graham corrected walls.

- One evaluation of a state with seeded velocities and a density jitter
  (numpy ``default_rng``) to 1e-10 of ``max|ref|`` per property, the JAX
  eval redone where its grid overflowed (as its ``solve`` does), on the
  port's kernel engine (on the CPU the plain version of ``wcsph_pair``)
  and on its torch engine.
- Three steps (damped, adaptive dt) to 1e-9: from rest, and from the
  perturbed state under PEC and under ``TVDRK3Integrator``
  (``WCSPHTVDRK3Step``, three evaluations a step).  TVDRK3 is held from
  the perturbed state: from rest, ``u`` (max 1.4e-9 m/s) and ``p`` (max
  3.6e-3 Pa, the Tait equation's difference of two numbers near 1) are
  cancellations, and one-ulp differences of ``rho`` between the two
  packages' summation orders (1e-13 of ``arho``, whose terms cancel at
  rest too) become 2e-8 of ``u`` and 5e-7 of ``p`` there; from the
  perturbed state every prop agrees to 2e-14.
"""

import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu.examples.dam_break_2d import DamBreak2D as JaxDamBreak2D
from pysph_tpu.sph.integrator import TVDRK3Integrator as JaxTVDRK3
from pysph_tpu_torch.base.kernels import WendlandQuintic
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.sph.integrator import PECIntegrator, TVDRK3Integrator
from pysph_tpu_torch.sph.integrator_step import WCSPHStep, WCSPHTVDRK3Step
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

ARGV = ['--dx', '0.1', '--disable-output', '-q']
EVAL_OUT = ('p', 'cs', 'arho', 'au', 'av', 'ax', 'ay')
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'arho', 'au', 'av')
EVAL_TOL = 1e-10
STEP_TOL = 1e-9


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _perturb(particles):
    rng = np.random.default_rng(23)
    for pa in particles:
        n = pa.get_number_of_particles()
        for p in ('u', 'v'):
            pa.properties[p][:] = rng.normal(0.0, 0.5, n)
        pa.properties['rho'][:] = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))


def _jax_eval(out_dir):
    """One evaluation of the perturbed state in pysph_tpu; returns
    ({array: {prop: ndarray}}, the inputs, dt)."""
    app = JaxDamBreak2D()
    app.setup(['-d', str(out_dir)] + ARGV)
    _perturb(app.particles)
    inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                        {k: v.copy() for k, v in pa.constants.items()},
                        dict(pa.stride)) for pa in app.particles}
    s = app.solver
    s._sync_to_device()
    # as the JAX solve() does: a cell fuller than the grid's capacity
    # drops particles until the grid is grown
    states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
    if s._check_overflow(diag):
        s._handle_overflow(diag)
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
    assert not s._check_overflow(diag)
    states = s._mat_fn(states, carry)
    out = {}
    for pa in app.particles:
        n = pa.get_number_of_particles()
        out[pa.name] = {p: np.asarray(states[pa.name][p])[:n]
                        for p in EVAL_OUT if p in states[pa.name]}
    return out, inputs, s.dt


def _port_app(engine, argv=ARGV, cls=DamBreak2D):
    app = cls()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine] +
              argv)
    return app


@pytest.fixture(scope='module')
def jax_eval():
    tmp = tempfile.mkdtemp()
    try:
        return _jax_eval(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_scheme_is_the_reference_default():
    """PEC, WendlandQuintic in 2D, adaptive dt, 50 damped steps; every
    pair phase on ``wcsph_pair`` under the kernel engine."""
    s = _port_app('kernel').solver
    assert type(s.integrator) is PECIntegrator
    assert all(type(st) is WCSPHStep for st in s.integrator.steppers.values())
    assert type(s.kernel) is WendlandQuintic and s.kernel.dim == 2
    assert s.adaptive_timestep and s.n_damp == 50
    a_eval = s.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    assert {p.op for p in a_eval._plans.values() if p is not None} == \
        {wp.wcsph_pair}


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_one_eval_matches_jax(engine, jax_eval):
    ref, inputs, dt = jax_eval
    s = _port_app(engine).solver
    s.particles = [ParticleArray.from_numpy(name, *args)
                   for name, args in inputs.items()]
    s._sync_to_device()
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    assert set(s.acceleration_evals[0].engine_choices.values()) == {engine}
    checked = 0
    for name, props in ref.items():
        for p, want in props.items():
            got = s.states[name][p].numpy()
            assert got.shape == want.shape, (name, p)
            if np.abs(want).max() == 0.0:
                assert np.abs(got).max() == 0.0, (name, p)
                continue
            err = _scaled_err(got, want)
            assert err <= EVAL_TOL, '%s.%s: scaled error %.3g' % (name, p,
                                                                  err)
            checked += 1
    assert checked >= 10


class _JaxTVDRK3(JaxDamBreak2D):
    def configure_scheme(self):
        super().configure_scheme()
        from pysph_tpu.base.kernels import WendlandQuintic as JaxWQ
        self.scheme.configure_solver(
            integrator_cls=JaxTVDRK3, kernel=JaxWQ(dim=2),
            adaptive_timestep=True, n_damp=50, fixed_h=False,
            dt=0.125 * self.h / 10.0 / np.sqrt(2 * 9.81 * 2.0), tf=2.5,
            output_at_times=[0.4, 0.6, 0.8, 1.0])


class _TVDRK3(DamBreak2D):
    def configure_scheme(self):
        super().configure_scheme()
        self.scheme.configure_solver(
            integrator_cls=TVDRK3Integrator, kernel=WendlandQuintic(dim=2),
            adaptive_timestep=True, n_damp=50, fixed_h=False,
            dt=0.125 * self.h / 10.0 / np.sqrt(2 * 9.81 * 2.0), tf=2.5,
            output_at_times=[0.4, 0.6, 0.8, 1.0])


@pytest.mark.parametrize('case', ['pec', 'pec perturbed',
                                  'tvdrk3 perturbed'])
def test_three_steps_match_jax(case):
    integrator, *start = case.split()
    jax_cls, cls = {'pec': (JaxDamBreak2D, DamBreak2D),
                    'tvdrk3': (_JaxTVDRK3, _TVDRK3)}[integrator]
    argv = ARGV + ['--max-steps', '3']
    tmp = tempfile.mkdtemp()
    try:
        ref = jax_cls()
        ref.setup(['-d', tmp] + argv)
        if start:
            _perturb(ref.particles)
            ref.solver._sync_to_device()
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()},
                            dict(pa.stride)) for pa in ref.particles}
        ref.solve()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = _port_app('kernel', argv, cls)
    s = port.solver
    if start:
        s.particles = port.particles = [
            ParticleArray.from_numpy(name, *args)
            for name, args in inputs.items()]
        s._sync_to_device()
    port.solve()
    if integrator == 'tvdrk3':
        assert type(s.integrator) is TVDRK3Integrator
        assert all(type(st) is WCSPHTVDRK3Step
                   for st in s.integrator.steppers.values())
        assert type(ref.solver.integrator) is JaxTVDRK3
    assert s.count == ref.solver.count == 3
    assert abs(s.t - ref.solver.t) <= STEP_TOL * ref.solver.t
    assert abs(s.dt - ref.solver.dt) <= STEP_TOL * ref.solver.dt
    ref_arrays = {pa.name: pa for pa in ref.particles}
    for pa in port.particles:
        rpa = ref_arrays[pa.name]
        n = rpa.get_number_of_particles()
        assert pa.get_number_of_particles() == n
        for p in STEP_PROPS:
            want = rpa.properties[p][:n]
            if np.abs(want).max() == 0.0:
                continue
            err = _scaled_err(pa.properties[p], want)
            assert err <= STEP_TOL, '%s.%s: scaled error %.3g' % (
                pa.name, p, err)
