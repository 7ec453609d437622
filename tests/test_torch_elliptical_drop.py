"""The port's elliptical drop against pysph_tpu (float64, on the CPU).

Input: ``examples/elliptical_drop.py --nx 20`` (1,247 particles, the
Gaussian kernel), for one eval with a seeded velocity and density
perturbation (numpy ``default_rng``).  The same particles go through

- pysph_tpu's resident Pallas engine (``_pair_kernel_resident`` in
  interpret mode, the kernel ``csrc/wcsph_pair.cu`` replaces) against
  the port's ``kernel`` engine (on the CPU: ``wcsph_pair_reference``);
- pysph_tpu's dense-slot Pallas engine (``PYSPH_TPU_RESIDENT=0
  PYSPH_TPU_COMPACT=0``: ``_pair_kernel`` in interpret mode, which
  ``csrc/dense_pair.cu`` replaces; the test counts its
  ``_execute_plan`` calls) against the port's ``dense`` engine.

One eval agrees to 1e-10 of ``max|ref|`` per property.  Three steps of
the whole app (adaptive, damped dt) agree with pysph_tpu's XLA engine to
1e-9, and so do ``t`` and ``dt``: the JAX time loop hands dt over as
float32 only in its chunked loop, which starts after the ``n_damp`` = 50
damped steps, so three steps keep dt in float64 on both sides.  The two
packages read each other's dumps and write the same dump files.
"""

import os

import numpy as np
import pytest

from pysph_tpu.config import get_config
from pysph_tpu.examples.elliptical_drop import \
    EllipticalDrop as JaxEllipticalDrop
from pysph_tpu.solver import output as jax_output
from pysph_tpu_torch.base.kernels import (
    CubicSpline, Gaussian, QuinticSpline, WendlandQuinticC4)
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.elliptical_drop import (
    EllipticalDrop, exact_solution)
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.solver import output
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

NX = ['--nx', '20']
PAIR_OUT = ('arho', 'au', 'av', 'aw', 'ax', 'ay', 'az', 'dt_cfl', 'p',
            'cs', 'rho')
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p')
TOL = 1e-10


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _jax_eval(tmp, pallas, monkeypatch=None):
    """One initial eval of the perturbed drop in pysph_tpu; returns
    ({prop: ndarray}, engine_choices, (props, constants) of the input,
    dt)."""
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = pallas
        app = JaxEllipticalDrop()
        app.setup(['-d', str(tmp), '-q', '--disable-output'] + NX)
        pa = app.particles[0]
        n = pa.get_number_of_particles()
        rng = np.random.default_rng(9)
        pa.u = pa.u + rng.normal(0.0, 10.0, n)
        pa.v = pa.v + rng.normal(0.0, 10.0, n)
        pa.rho = 1.0 + 1e-3 * rng.normal(size=n)
        inputs = ({k: v.copy() for k, v in pa.properties.items()},
                  {k: v.copy() for k, v in pa.constants.items()})
        s = app.solver
        s._sync_to_device()
        # as the JAX solve() does: a cell fuller than the grid's
        # capacity drops particles until the grid is grown
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        assert not s._check_overflow(diag)
        states = s._mat_fn(states, carry)
        choices = dict(s.integrator.acceleration_evals[0].engine_choices)
        out = {p: np.asarray(states['fluid'][p])[:n] for p in PAIR_OUT}
        return out, choices, inputs, s.dt
    finally:
        cfg._use_pallas = old


def _port_app(engine, argv=()):
    app = EllipticalDrop()
    app.setup(['-q', '--use-double', '--device', 'cpu', '--engine', engine]
              + NX + list(argv))
    return app


def _port_eval(engine, inputs, dt):
    app = _port_app(engine, ['--disable-output'])
    s = app.solver
    s.particles = [ParticleArray.from_numpy('fluid', *inputs)]
    s._sync_to_device()
    launches = (wp.wcsph_pair.launches, dp.dense_pair.launches)
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    # CPU tensors take the plain version: nothing was launched
    assert (wp.wcsph_pair.launches, dp.dense_pair.launches) == launches
    return {p: s.states['fluid'][p].numpy() for p in PAIR_OUT}


def _compare(port, ref, tol=TOL):
    for p in PAIR_OUT:
        assert port[p].shape == ref[p].shape, p
        err = _scaled_err(port[p], ref[p])
        assert err <= tol, '%s: scaled error %.3g' % (p, err)


def test_eval_kernel_engine_matches_jax_resident(tmp_path):
    ref, choices, inputs, dt = _jax_eval(tmp_path, pallas=True)
    assert choices == {'__mode__': 'resident'}
    assert np.abs(ref['au']).max() > 1e3     # the input is not at rest
    _compare(_port_eval('kernel', inputs, dt), ref)


def test_eval_dense_engine_matches_jax_dense_slots(tmp_path, monkeypatch):
    import pysph_tpu.ops.pallas_engine as pe
    calls = {'dense': 0, 'compact': 0}
    dense, compact = pe._execute_plan, pe._execute_plan_compact

    def count_dense(*a, **k):
        calls['dense'] += 1
        return dense(*a, **k)

    def count_compact(*a, **k):
        calls['compact'] += 1
        return compact(*a, **k)

    monkeypatch.setattr(pe, '_execute_plan', count_dense)
    monkeypatch.setattr(pe, '_execute_plan_compact', count_compact)
    monkeypatch.setenv('PYSPH_TPU_RESIDENT', '0')
    monkeypatch.setenv('PYSPH_TPU_COMPACT', '0')
    ref, choices, inputs, dt = _jax_eval(tmp_path, pallas=True)
    # the choice is recorded before _Plan.execute picks the dense path
    assert choices == {('fluid', ('fluid',)): 'pallas-compact'}
    assert calls['dense'] >= 1 and calls['compact'] == 0
    _compare(_port_eval('dense', inputs, dt), ref)


def test_engines_plan_the_drop():
    for engine, op in (('kernel', wp.wcsph_pair), ('dense', dp.dense_pair)):
        s = _port_app(engine, ['--disable-output']).solver
        a_eval = s.acceleration_evals[0]
        assert a_eval.engine_choices == {('fluid', ('fluid',)): engine}
        (plan,) = [p for p in a_eval._plans.values() if p is not None]
        assert plan.op is op and plan.reference is wp.wcsph_pair_reference
        assert [(ps.name, ps.terms) for ps in plan.sources] == [
            ('fluid', wp.CONT | wp.MOM | wp.XSPH)]
        assert isinstance(s.kernel, Gaussian)
        # cells 1.1 x 3 h = 0.2145 wide over the drop's 1.9 extent,
        # padded by 3% a side and 3 cells
        assert s.grid.radius_scale == 3.0 and s.grid.dims == (12, 12, 1)
    s = _port_app('torch', ['--disable-output']).solver
    assert s.acceleration_evals[0].engine_choices == {
        ('fluid', ('fluid',)): 'torch'}


def test_dense_engine_leaves_gtvf_to_torch_engine():
    """The JAX dense path refuses the GTVF sets' sequential and strided
    phases; under ``dense`` they take the torch engine, and the WCSPH
    sets of dam_break_3d take dense_pair."""
    from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
    from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
    app = DamBreak2D()
    app.setup(['-q', '--disable-output', '--device', 'cpu', '--engine',
               'dense', '--scheme', 'gtvf', '--dx', '0.1'])
    for a_eval in app.solver.acceleration_evals:
        assert set(a_eval.engine_choices.values()) == {'torch'}
    app = DamBreak3D()
    app.setup(['-q', '--disable-output', '--device', 'cpu', '--engine',
               'dense', '--dx', '0.12'])
    a_eval = app.solver.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'dense'}
    assert {p.op for p in a_eval._plans.values()} == {dp.dense_pair}


def test_kernel_and_scheme_options():
    s = _port_app('kernel', ['--disable-output', '--kernel',
                             'CubicSpline']).solver
    assert isinstance(s.kernel, CubicSpline)
    assert s.grid.radius_scale == 2.0 and s.grid.dims == (17, 17, 1)
    # QuinticSpline is ported, and the WCSPH walks take it: the drop's
    # pair phases stay on the kernel engine
    s = _port_app('kernel', ['--disable-output', '--kernel',
                             'QuinticSpline']).solver
    assert isinstance(s.kernel, QuinticSpline) and s.grid.radius_scale == 3.0
    assert set(s.acceleration_evals[0].engine_choices.values()) == {'kernel'}
    # so is WendlandQuinticC4 (a kind of its own in the pair kernels)
    s = _port_app('kernel', ['--disable-output', '--kernel',
                             'WendlandQuinticC4']).solver
    assert isinstance(s.kernel, WendlandQuinticC4) and \
        s.grid.radius_scale == 2.0
    assert set(s.acceleration_evals[0].engine_choices.values()) == {'kernel'}
    # IISPH is ported (ROADMAP item 26): the reference's IISPH drop
    app = _port_app('kernel', ['--disable-output', '--scheme', 'iisph'])
    assert type(app.scheme.scheme).__name__ == 'IISPHScheme'
    assert isinstance(app.solver.kernel, Gaussian)
    assert set(app.solver.acceleration_evals[0].engine_choices.values()) \
        == {'kernel'}


def test_exact_solution_matches_jax():
    from pysph_tpu.examples.elliptical_drop import \
        exact_solution as jax_exact
    for got, want in zip(exact_solution(0.0038), jax_exact(0.0038)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def three_steps(tmp_path_factory):
    """Three steps with a dump after each, in both packages (pysph_tpu on
    its XLA engine)."""
    argv = NX + ['-q', '--max-steps', '3', '--pfreq', '1']
    jax_dir = tmp_path_factory.mktemp('jax')
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = False
        ref = JaxEllipticalDrop()
        ref.run(['-d', str(jax_dir)] + argv)
    finally:
        cfg._use_pallas = old
    port_dir = tmp_path_factory.mktemp('port')
    port = EllipticalDrop()
    port.run(['-d', str(port_dir), '--use-double', '--device', 'cpu'] + argv)
    return ref, port


def test_three_steps_match_jax(three_steps):
    ref, port = three_steps
    assert port.solver.count == ref.solver.count == 3
    for attr in ('t', 'dt'):
        want = getattr(ref.solver, attr)
        assert abs(getattr(port.solver, attr) - want) <= 1e-9 * want, attr
    rpa, = ref.particles
    pa, = port.particles
    n = rpa.get_number_of_particles()
    assert pa.get_number_of_particles() == n
    for p in STEP_PROPS:
        err = _scaled_err(pa.properties[p], rpa.properties[p][:n])
        assert err <= 1e-9, '%s: scaled error %.3g' % (p, err)


def test_dumps_have_the_jax_names_and_contents(three_steps):
    ref, port = three_steps
    names = [os.path.basename(f) for f in port.output_files]
    assert names == [os.path.basename(f) for f in ref.output_files]
    assert names == ['elliptical_drop_%05d.%s' % (
        k, 'hdf5' if output._has_h5py() else 'npz') for k in range(4)]
    for mine, theirs in zip(port.output_files, ref.output_files):
        a, b = output.load(mine), output.load(theirs)
        assert a['solver_data']['count'] == b['solver_data']['count']
        for key in ('t', 'dt'):
            want = float(b['solver_data'][key])
            assert abs(float(a['solver_data'][key]) - want) <= 1e-9 * want
        pa, rpa = a['arrays']['fluid'], b['arrays']['fluid']
        assert pa.output_property_arrays == rpa.output_property_arrays
        for p in STEP_PROPS:
            assert _scaled_err(pa.properties[p], rpa.properties[p]) <= 1e-9


def _same_arrays(a, b):
    assert set(a['arrays']) == set(b['arrays'])
    assert {k: float(v) for k, v in a['solver_data'].items()} == \
        {k: float(v) for k, v in b['solver_data'].items()}
    for name, pa in a['arrays'].items():
        rpa = b['arrays'][name]
        assert set(pa.properties) == set(rpa.properties)
        assert pa.output_property_arrays == rpa.output_property_arrays
        assert pa.get_number_of_particles() == rpa.get_number_of_particles()
        for p, v in pa.properties.items():
            np.testing.assert_array_equal(v, rpa.properties[p], err_msg=p)
            assert pa.stride[p] == rpa.stride.get(p, 1)


@pytest.mark.parametrize('ext', ['npz', 'hdf5'])
def test_dumps_round_trip_between_packages(three_steps, tmp_path, ext):
    """The port's dump read by the JAX ``load`` and a JAX dump read by
    the port's ``load``: the same arrays and solver data."""
    if ext == 'hdf5' and not output._has_h5py():
        pytest.skip('h5py is not installed')
    ref, port = three_steps
    data = {'t': port.solver.t, 'dt': port.solver.dt, 'count': 3}
    mine = output.dump(str(tmp_path / ('port.' + ext)), port.particles, data)
    theirs = jax_output.dump(str(tmp_path / ('jax.' + ext)), ref.particles,
                             data)
    assert mine.endswith(ext) and theirs.endswith(ext)
    _same_arrays(jax_output.load(mine), output.load(mine))
    _same_arrays(output.load(theirs), jax_output.load(theirs))
    # and the port's load gives what it dumped
    got = output.load(mine)['arrays']['fluid']
    pa, = port.particles
    for p in pa.output_property_arrays:
        np.testing.assert_array_equal(got.properties[p], pa.properties[p])


def test_post_process_reads_the_last_dump(three_steps):
    ref, port = three_steps
    res = port.post_process(port.info_filename)
    want = ref.post_process(ref.info_filename)
    assert res['t'] == port.solver.t
    assert abs(res['a_num'] - want['a_num']) <= 1e-9
    assert res['a_exact'] == want['a_exact']
    assert os.path.isfile(os.path.join(port.output_dir, 'results.npz'))
