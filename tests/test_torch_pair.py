"""The port's pair module against pysph_tpu on one acceleration eval.

Input: the dam_break_3d geometry at dx=0.12 (1,960 particles) with
seeded velocities and a density jitter.  The same particles go through

- pysph_tpu on its XLA engine, and on its Pallas resident engine
  (``_pair_kernel_resident`` in interpret mode, the kernel that
  ``csrc/wcsph_pair.cu`` replaces);
- the port with the kernel engine (on the CPU: ``wcsph_pair_reference``)
  and with the generic torch engine.

Outputs agree to 1e-10 of ``max|ref|`` per property (float64; the two
sides sum the same terms in different orders).
"""

import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu.config import get_config
from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

PAIR_OUT = ('arho', 'au', 'av', 'aw', 'ax', 'ay', 'az', 'dt_cfl',
            'dt_force', 'p', 'cs', 'rho')
ARGV = ['--dx', '0.12']
TOL = 1e-10


def _jax_eval(use_pallas):
    """One initial-acceleration eval of the perturbed dam break in
    pysph_tpu; returns ({array: {prop: ndarray}}, engine_choices,
    {array: (props, constants)} of the input)."""
    cfg = get_config()
    old = cfg._use_pallas
    tmp = tempfile.mkdtemp()
    try:
        cfg.use_pallas = use_pallas
        app = JaxDamBreak3D()
        app.setup(['-d', tmp, '-q', '--disable-output'] + ARGV)
        rng = np.random.default_rng(7)
        for pa in app.particles:
            n = pa.get_number_of_particles()
            pa.u = rng.normal(0.0, 0.5, n)
            pa.v = rng.normal(0.0, 0.5, n)
            pa.w = rng.normal(0.0, 0.5, n)
            pa.rho = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()})
                  for pa in app.particles}
        s = app.solver
        s._sync_to_device()
        states, _diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
        choices = dict(s.integrator.acceleration_evals[0].engine_choices)
        out = {}
        for pa in app.particles:
            n = pa.get_number_of_particles()
            out[pa.name] = {p: np.asarray(states[pa.name][p])[:n]
                            for p in PAIR_OUT}
        return out, choices, inputs, s.dt
    finally:
        cfg._use_pallas = old
        shutil.rmtree(tmp, ignore_errors=True)


def _port_app(engine, inputs=None):
    app = DamBreak3D()
    app.setup(['-q', '--disable-output', '--use-double', '--device', 'cpu',
               '--engine', engine] + ARGV)
    if inputs is not None:
        app.solver.particles = [
            ParticleArray.from_numpy(name, props, consts)
            for name, (props, consts) in inputs.items()]
        app.solver._sync_to_device()
    return app


def _port_eval(engine, inputs, dt):
    app = _port_app(engine, inputs)
    s = app.solver
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    return {name: {p: s.states[name][p].numpy() for p in PAIR_OUT}
            for name in s.states}


def _compare(port, ref):
    assert set(port) == set(ref)
    for name in ref:
        for p in PAIR_OUT:
            a, b = port[name][p], ref[name][p]
            assert a.shape == b.shape, (name, p)
            scale = max(np.abs(b).max(), np.finfo(float).tiny)
            err = np.abs(a - b).max() / scale
            assert err <= TOL, '%s.%s: scaled error %.3g' % (name, p, err)


@pytest.fixture(scope='module')
def jax_xla():
    return _jax_eval(use_pallas=False)


def test_port_plans_kernel_for_every_dest():
    choices = _port_app('kernel').solver.acceleration_evals[0]\
        .engine_choices
    assert choices == {('boundary', ('fluid',)): 'kernel',
                       ('obstacle', ('fluid',)): 'kernel',
                       ('fluid', ('fluid', 'boundary', 'obstacle')):
                           'kernel'}
    choices = _port_app('torch').solver.acceleration_evals[0]\
        .engine_choices
    assert set(choices.values()) == {'torch'}


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_pair_eval_matches_jax_xla(jax_xla, engine):
    ref, choices, inputs, dt = jax_xla
    assert set(choices.values()) == {'xla'}
    assert np.abs(ref['fluid']['au']).max() > 1.0   # the input is not at rest
    launches = wp.wcsph_pair.launches
    _compare(_port_eval(engine, inputs, dt), ref)
    # CPU tensors take the plain version: nothing was launched
    assert wp.wcsph_pair.launches == launches


def test_pair_eval_matches_jax_pallas_resident():
    """The Pallas kernel that the CUDA kernel replaces, in interpret
    mode; dam_break_3d engages the resident engine."""
    ref, choices, inputs, dt = _jax_eval(use_pallas=True)
    assert choices.get('__mode__') == 'resident'
    _compare(_port_eval('kernel', inputs, dt), ref)


def test_plan_refuses_other_equations():
    from pysph_tpu_torch.base.kernels import WendlandQuintic
    from pysph_tpu_torch.ops.pair_engine import (
        PairIneligible, plan_pair_phases)
    from pysph_tpu_torch.sph.basic_equations import ContinuityEquation
    from pysph_tpu_torch.sph.equation import Equation

    class Other(Equation):
        def loop(self, d_idx, d_arho, s_idx, s_m, WIJ):
            d_arho[d_idx] += s_m[s_idx] * WIJ

    k = WendlandQuintic(dim=3)
    plan = plan_pair_phases('f', {'f': [ContinuityEquation('f', ['f'])]}, k)
    assert plan.outputs == ('arho',)
    with pytest.raises(PairIneligible):
        plan_pair_phases('f', {'f': [Other('f', ['f'])]}, k)
    with pytest.raises(PairIneligible):
        plan_pair_phases('f', {'f': [ContinuityEquation('f', ['f']),
                                     ContinuityEquation('f', ['f'])]}, k)
