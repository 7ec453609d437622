"""The port's GTVF dam break against pysph_tpu (float64, on the CPU).

Input: ``examples/dam_break_2d.py --scheme gtvf --dx 0.1`` (231 fluid and
532 wall particles) with seeded velocities, transport velocities, a
density jitter and a wall acceleration (numpy ``default_rng``).  The
same particles go through

- pysph_tpu on its XLA engine, and on its Pallas engine, where every
  pair phase of both evaluators takes ``pallas-compact``
  (``_pair_kernel_compact`` in interpret mode, the kernel that
  ``csrc/gtvf_pair.cu`` replaces);
- the port with the kernel engine (on the CPU: ``gtvf_pair_reference``)
  and with the generic torch engine.

One evaluation agrees to 1e-10 of ``max|ref|`` per property over the
finite entries, whose positions match; ``rhodiv`` is +inf next to the
walls (their ``rho0`` is 0) on both sides.  Three steps agree to 1e-9.
"""

import numpy as np
import pytest
import torch

from pysph_tpu.config import get_config
from pysph_tpu.examples.dam_break_2d import DamBreak2D as JaxDamBreak2D
from pysph_tpu.sph.wc.gtvf import (
    get_particle_array_gtvf as jax_gtvf_array)
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.sph.acceleration_eval import _bind_particle_phase
from pysph_tpu_torch.sph.wc.gtvf import (
    GTVFIntegrator, GTVFScheme, GTVFStep, get_particle_array_gtvf)
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

# the chunked JAX time loop hands dt over as float32, so the tests give
# both packages a dt that float32 holds exactly (~0.125 h / c0 at dx=0.1)
DT = float(np.float32(0.125 * 0.13 / (10.0 * np.sqrt(2 * 9.81 * 2.0))))
ARGV = ['--scheme', 'gtvf', '--dx', '0.1', '--dt', repr(DT),
        '--disable-output', '-q']
EVAL_OUT = (
    ('uf', 'vf', 'wf', 'ug', 'vg', 'wij', 'arho'),
    ('rho', 'rho0', 'rhodiv', 'p', 'p0', 'V', 'wij', 'au', 'av', 'auhat',
     'avhat'))
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'sigma', 'rhodiv')
TOL = 1e-10


def _perturb(particles):
    rng = np.random.default_rng(11)
    for pa in particles:
        n = pa.get_number_of_particles()
        for p in ('u', 'v', 'uhat', 'vhat'):
            pa.properties[p][:] = rng.normal(0.0, 0.5, n)
        pa.properties['rho'][:] = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))
        if pa.name == 'boundary':
            pa.properties['au'][:] = rng.normal(0.0, 1.0, n)
            pa.properties['av'][:] = rng.normal(0.0, 1.0, n)


def _snapshot(particles):
    return {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                      {k: v.copy() for k, v in pa.constants.items()},
                      dict(pa.stride)) for pa in particles}


def _jax_app(use_pallas, out_dir, argv=ARGV):
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = use_pallas
        app = JaxDamBreak2D()
        app.setup(['-d', str(out_dir)] + argv)
        return app
    finally:
        cfg._use_pallas = old


def _jax_eval(use_pallas, index, out_dir):
    """Evaluator ``index`` once on the perturbed state in pysph_tpu;
    returns ({array: {prop: ndarray}}, engine_choices, input snapshot)."""
    import jax
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = use_pallas
        app = _jax_app(use_pallas, out_dir)
        _perturb(app.particles)
        inputs = _snapshot(app.particles)
        s = app.solver
        s._sync_to_device()
        integ = s.integrator

        def run(states):
            integ._states = dict(states)
            integ._t, integ._dt = 0.0, s.dt
            integ._lists, integ._carry_in, integ._carry_out = {}, None, {}
            integ._pm_cache = integ._res_stores = None
            integ._diag = integ._fresh_diag()
            integ.compute_accelerations(index)
            return integ._states

        states = jax.jit(run)(s.states)
        a_eval = integ.acceleration_evals[index]
        out = {}
        for pa in app.particles:
            n = pa.get_number_of_particles()
            out[pa.name] = {p: np.asarray(states[pa.name][p])[:n]
                            for p in EVAL_OUT[index]
                            if p in states[pa.name]}
        return out, dict(a_eval.engine_choices), inputs
    finally:
        cfg._use_pallas = old


def _port_app(engine, inputs=None, argv=ARGV):
    app = DamBreak2D()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine] +
              argv)
    if inputs is not None:
        app.solver.particles = [
            ParticleArray.from_numpy(name, props, consts, stride)
            for name, (props, consts, stride) in inputs.items()]
        app.solver._sync_to_device()
    return app


def _port_eval(engine, index, inputs):
    s = _port_app(engine, inputs).solver
    s.acceleration_evals[index].update_and_compute(0.0, s.dt, s.states)
    return {name: {p: st[p].numpy() for p in EVAL_OUT[index] if p in st}
            for name, st in s.states.items()}


def _compare(port, ref, tol):
    """Scaled error over the finite entries of ``ref``; the non-finite
    entries must be the same on both sides."""
    assert set(port) == set(ref)
    for name in ref:
        assert set(port[name]) == set(ref[name]), name
        for p, b in ref[name].items():
            a = port[name][p]
            assert a.shape == b.shape, (name, p, a.shape, b.shape)
            fin = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), fin), (name, p)
            assert np.array_equal(a[~fin], b[~fin]), (name, p)
            scale = max(np.abs(b[fin]).max(initial=0.0),
                        np.finfo(float).tiny)
            err = np.abs(a[fin] - b[fin]).max(initial=0.0) / scale
            assert err <= tol, '%s.%s: scaled error %.3g' % (name, p, err)


@pytest.fixture(scope='module')
def jax_xla(tmp_path_factory):
    return {k: _jax_eval(False, k, tmp_path_factory.mktemp('xla'))
            for k in (0, 1)}


@pytest.fixture(scope='module')
def jax_pallas(tmp_path_factory):
    return {k: _jax_eval(True, k, tmp_path_factory.mktemp('pallas'))
            for k in (0, 1)}


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
@pytest.mark.parametrize('index', [0, 1])
def test_eval_matches_jax_xla(jax_xla, index, engine):
    ref, choices, inputs = jax_xla[index]
    assert set(choices.values()) == {'xla'}
    launches = gp.gtvf_pair.launches
    _compare(_port_eval(engine, index, inputs), ref, TOL)
    # CPU tensors take the plain version: nothing was launched
    assert gp.gtvf_pair.launches == launches


@pytest.mark.parametrize('index', [0, 1])
def test_eval_matches_jax_pallas_compact(jax_pallas, index):
    """The Pallas kernel that the CUDA kernel replaces, in interpret mode:
    every pair phase of both evaluators takes it."""
    ref, choices, inputs = jax_pallas[index]
    assert len(choices) == 2
    assert set(choices.values()) == {'pallas-compact'}
    _compare(_port_eval('kernel', index, inputs), ref, TOL)
    if index == 1:
        # the walls' rho0 is 0: rhodiv is +inf next to them, in both
        assert np.isposinf(ref['fluid']['rhodiv']).any()


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_three_steps_match_jax(engine, tmp_path):
    ref = _jax_app(False, tmp_path, ARGV + ['--max-steps', '3'])
    _perturb(ref.particles)
    inputs = _snapshot(ref.particles)
    ref.solver._sync_to_device()
    ref.solve()
    port = _port_app(engine, inputs, ARGV + ['--max-steps', '3'])
    port.solve()
    assert port.solver.count == ref.solver.count == 3
    assert abs(port.solver.t - ref.solver.t) <= 1e-9 * ref.solver.t
    ref_arrays = {pa.name: pa for pa in ref.particles}
    for pa in port.solver.particles:
        rpa = ref_arrays[pa.name]
        n = rpa.get_number_of_particles()
        assert pa.get_number_of_particles() == n
        got = {p: pa.properties[p] for p in STEP_PROPS}
        want = {p: rpa.properties[p][:n * rpa.stride.get(p, 1)]
                for p in STEP_PROPS}
        _compare({pa.name: got}, {pa.name: want}, 1e-9)


def test_strided_props_round_trip_and_stepper():
    rng = np.random.default_rng(3)
    n = 13
    ref = jax_gtvf_array(name='fluid', x=rng.uniform(size=n), h=0.1)
    ref.sigma[:] = rng.normal(size=9 * n)
    ref.asigma[:] = rng.normal(size=9 * n)
    mine = get_particle_array_gtvf(name='fluid', x=[0.0, 1.0])
    assert sorted(mine.properties) == sorted(
        jax_gtvf_array(name='fluid', x=[0.0, 1.0]).properties)
    assert {k: v for k, v in mine.stride.items() if v > 1} == \
        {'gradvhat': 9, 'sigma': 9, 'asigma': 9}

    pa = ParticleArray.from_numpy('fluid', dict(ref.properties),
                                  dict(ref.constants), dict(ref.stride))
    assert pa.get_number_of_particles() == n
    props, _ = pa.to_numpy()
    for k, v in ref.properties.items():
        np.testing.assert_array_equal(props[k], v, err_msg=k)
    state = pa.to_device(Config(device='cpu', dtype=torch.float64))
    assert state['sigma'].shape == (n, 9) and state['x'].shape == (n,)
    np.testing.assert_array_equal(state['sigma'].numpy(),
                                  ref.sigma.reshape(n, 9))

    # GTVFStep.stage2 writes d_sigma[d_idx * 9 + i] on the local rows
    state['tag'][::4] = 1
    dt = 0.01
    _bind_particle_phase(GTVFStep().stage2, state, state['tag'] == 0, 0.0,
                         dt)
    live = (np.arange(n) % 4 != 0)[:, None]
    want = ref.sigma.reshape(n, 9) + np.where(
        live, dt * ref.asigma.reshape(n, 9), 0.0)
    np.testing.assert_allclose(state['sigma'].numpy(), want, rtol=0,
                               atol=1e-15)
    pa.update_from_device(state)
    np.testing.assert_allclose(pa.sigma, want.ravel(), rtol=0, atol=1e-15)

    from pysph_tpu_torch.sph.equation import ArrayView, IndexSym
    d_idx = IndexSym('dest')
    key = 9 * d_idx + 4
    assert (key.mul, key.off) == (9, 4)
    assert (d_idx * 9 + 3 * 2 + 1).off == 7
    col = ArrayView(state, 'sigma')[key]
    np.testing.assert_array_equal(col.numpy(), want[:, 4])
    with pytest.raises(IndexError):
        ArrayView(state, 'sigma')[3 * d_idx + 1]
    with pytest.raises(IndexError):
        ArrayView(state, 'x')[9 * d_idx]


def test_scheme_chooser_picks_the_scheme():
    app = _port_app('kernel')
    assert isinstance(app.scheme.scheme, GTVFScheme)
    s = app.solver
    assert isinstance(s.integrator, GTVFIntegrator)
    assert len(s.acceleration_evals) == 2
    assert all(a.grid is s.grid for a in s.acceleration_evals)
    # EDAC (ROADMAP item 35) and IISPH (item 26) are ported
    edac = DamBreak2D()
    edac.setup(['--scheme', 'edac', '--dx', '0.1', '-q',
                '--disable-output', '--device', 'cpu'])
    assert type(edac.scheme.scheme).__name__ == 'EDACScheme'
    iisph = DamBreak2D()
    iisph.setup(['--scheme', 'iisph', '--dx', '0.1', '-q',
                 '--disable-output', '--device', 'cpu'])
    assert type(iisph.scheme.scheme).__name__ == 'IISPHScheme'
    assert iisph.solver.adaptive_timestep


def test_planner_routes_gtvf_and_wcsph():
    s = _port_app('kernel').solver
    keys = []
    for a_eval in s.acceleration_evals:
        assert set(a_eval.engine_choices.values()) == {'kernel'}
        keys += list(a_eval.engine_choices)
        for plan in a_eval._plans.values():
            assert plan.op is gp.gtvf_pair
            assert plan.reference is gp.gtvf_pair_reference
    assert keys == [('boundary', ('fluid',)),
                    ('fluid', ('fluid', 'boundary')),
                    ('fluid', ('fluid', 'boundary')),
                    ('boundary', ('fluid', 'boundary'))]
    # per-source masks: the walls take ContinuitySolid, the fluid the
    # artificial stress
    plans = [p for a in s.acceleration_evals for p in a._plans.values()]
    assert [[(ps.name, ps.terms) for ps in p.sources] for p in plans] == [
        [('fluid', gp.SWV)],
        [('fluid', gp.CGTVF), ('boundary', gp.CSOLID)],
        [('fluid', gp.CDENS), ('boundary', gp.CDENS)],
        [('fluid', gp.VSUM | gp.WALLP), ('boundary', gp.VSUM)],
        [('fluid', gp.MPG | gp.MAS), ('boundary', gp.MPG)]]
    assert plans[3].sources[0].gravity == (0.0, -9.81, 0.0)
    torch_choices = _port_app('torch').solver.acceleration_evals
    assert {v for a in torch_choices for v in a.engine_choices.values()} \
        == {'torch'}

    from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
    app = DamBreak3D()
    app.setup(['-q', '--disable-output', '--use-double', '--device', 'cpu',
               '--dx', '0.12'])
    for plan in app.solver.acceleration_evals[0]._plans.values():
        assert plan.op is wp.wcsph_pair


def test_planner_refuses_mixed_gtvf_phase_sets():
    from pysph_tpu_torch.base.kernels import CubicSpline, WendlandQuintic
    from pysph_tpu_torch.ops.pair_engine import (
        PairIneligible, plan_pair_phases)
    from pysph_tpu_torch.sph.wc.gtvf import (
        CorrectDensity, MomentumEquationPressureGradient)
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        SetWallVelocity, VolumeSummation)
    k = WendlandQuintic(dim=2)
    cd = CorrectDensity('f', ['f'])
    assert plan_pair_phases('f', {'f': [cd]}, k).outputs == (
        'rho', 'rhodiv')
    with pytest.raises(PairIneligible, match='span two phase sets'):
        plan_pair_phases('f', {'f': [SetWallVelocity('f', ['f']),
                                     VolumeSummation('f', ['f'])]}, k)
    # the momentum equation reads the rho that CorrectDensity accumulates
    mpg = MomentumEquationPressureGradient('f', ['f'], pref=1.0)
    with pytest.raises(PairIneligible, match='accumulates'):
        plan_pair_phases('f', {'f': [cd, mpg]}, k)
    # every kind of KERNEL_KIND has its shape function in the kernel
    assert plan_pair_phases('f', {'f': [cd]}, CubicSpline(dim=2)).op is \
        gp.gtvf_pair
