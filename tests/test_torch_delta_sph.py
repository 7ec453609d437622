"""delta-SPH with the Bonet-Lok gradient correction: the port against
pysph_tpu and the float64 oracle (float64, on the CPU).

- (a) ``small_solve_cols`` and ``gj_solve`` against the JAX ones for
  n = 1, 2, 3, singular systems included (1e-12 of max|ref|);
- (b) one eval of the elliptical drop (nx=20, 1,247 particles, Gaussian)
  with ``--delta-sph`` and a seeded velocity and density perturbation,
  against pysph_tpu's XLA engine, the plain reference of its resident
  Pallas kernel (which ``csrc/delta_pair.cu`` and ``csrc/wcsph_pair.cu``
  replace; ``tests/test_resident.py`` holds the two together on the
  delta-SPH sets; in interpret mode it takes ~45 s on a CPU), on the port's
  ``kernel`` engine (on the CPU the plain versions) and on its torch
  engine: ``m_mat``, ``gradrho`` and the pair outputs to 1e-10 of
  max|ref| per property;
- (c) 6 EPEC steps of the drop at nx=10 against ``NumpyDeltaSPH``
  (``tests/test_reference_parity.py``) to 1e-6 relative L2, as
  ``test_delta_sph_gradient_correction_1e6`` holds the JAX package;
- (e) the planner: ``--engine kernel`` puts every delta-SPH set on
  ``delta_pair`` / ``wcsph_pair``, ``--engine dense`` leaves them (and
  the fluid's main group, which reads the strided ``gradrho``) to the
  torch engine;
- (f) the pack of a strided column equals ``pack_reference``, and the
  wrappers' plain versions equal the torch engine;
- the chunks against the per-step loop with the strided props in the
  chunk's write-back;
- the four viscosity equations (torch engine) against pysph_tpu's
  ``SPHEvaluator``, and the scheme's ``nu`` branch with and without
  delta-SPH against the JAX XLA engine (1e-10).

``tests/test_torch_delta_dam_break.py`` holds (d), dam_break_3d
``--delta-sph`` against the JAX app.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysph_tpu.config import get_config
from pysph_tpu.examples.elliptical_drop import \
    EllipticalDrop as JaxEllipticalDrop
from pysph_tpu.sph.wc import linalg as jax_linalg
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.sph.wc import linalg
from test_reference_parity import NumpyDeltaSPH, _drop_particles
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

NX = ['--nx', '20', '--delta-sph']
OUT = ('m_mat', 'gradrho', 'arho', 'au', 'av', 'ax', 'ay', 'dt_cfl', 'p',
       'cs', 'rho')
TOL = 1e-10


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _matrices(n, rng):
    """Seeded n x n systems: well conditioned, singular (a zero row, a
    zero column, all zero: det exactly 0) and tiny (det below 1e-30 for
    n > 1)."""
    a = rng.normal(size=(8, n, n)) + 3 * np.eye(n)
    a[1, 0] = 0.0
    a[2, :, n - 1] = 0.0
    a[3] = 0.0
    a[4] = 1e-16 * rng.normal(size=(n, n))
    return a, rng.normal(size=(8, n))


@pytest.mark.parametrize('n', [1, 2, 3])
def test_solves_match_jax(n):
    rng = np.random.default_rng(40 + n)
    a, w = _matrices(n, rng)
    got = linalg.small_solve_cols(
        [[torch.as_tensor(a[:, i, j]) for j in range(n)] for i in range(n)],
        [torch.as_tensor(w[:, i]) for i in range(n)], n)
    want = jax_linalg.small_solve_cols(
        [[jnp.asarray(a[:, i, j]) for j in range(n)] for i in range(n)],
        [jnp.asarray(w[:, i]) for i in range(n)], n)
    for g, r in zip(got, want):
        assert _scaled_err(g.numpy(), np.asarray(r)) <= 1e-12
    # a singular system keeps w
    for k in (1, 2, 3) + ((4,) if n > 1 else ()):
        assert all(np.array_equal(g.numpy()[k], w[k, c])
                   for c, g in enumerate(got)), k
    for b in (w, None):
        A = a if b is not None else np.concatenate([a, w[..., None]], -1)
        got = linalg.gj_solve(torch.as_tensor(A), None if b is None
                              else torch.as_tensor(b)).numpy()
        want = np.asarray(jax_linalg.gj_solve(
            jnp.asarray(A), None if b is None else jnp.asarray(b)))
        assert _scaled_err(got, want) <= 1e-12
        assert np.array_equal(got[1:4], np.zeros((3, n)))


def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 3, 3))
    v = rng.normal(size=(4, 3))
    ta, tb, tv = (torch.as_tensor(x) for x in (a, b, v))
    for got, want in (
            (linalg.dot(tv, tv), jax_linalg.dot(v, v)),
            (linalg.mat_mult(ta, tb), jax_linalg.mat_mult(a, b)),
            (linalg.mat_vec_mult(ta, tv), jax_linalg.mat_vec_mult(a, v)),
            (linalg.augmented_matrix(ta, tv),
             jax_linalg.augmented_matrix(a, v)),
            (linalg.identity(3, (4,)), jax_linalg.identity(3, (4,)))):
        assert got.shape == np.asarray(want).shape
        assert _scaled_err(got.numpy(), np.asarray(want)) <= 1e-12


def _jax_eval(tmp):
    """One initial eval of the perturbed delta-SPH drop in pysph_tpu's
    XLA engine; returns ({prop: ndarray}, engine choices, inputs, dt,
    strides)."""
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = False
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
        strides = {k: pa.stride.get(k, 1) for k in pa.properties}
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
        out = {}
        for p in OUT:
            k = strides.get(p, 1)
            v = np.asarray(states['fluid'][p])
            out[p] = v.reshape(-1, k)[:n] if k > 1 else v[:n]
        return out, choices, inputs, s.dt, strides
    finally:
        cfg._use_pallas = old


def _port_app(engine, argv=()):
    app = EllipticalDrop()
    app.setup(['-q', '--use-double', '--device', 'cpu', '--engine', engine]
              + NX + list(argv))
    return app


def _port_eval(engine, inputs, dt, strides):
    s = _port_app(engine, ['--disable-output']).solver
    s.particles = [ParticleArray.from_numpy('fluid', *inputs,
                                            stride=strides)]
    s._sync_to_device()
    launches = (wp.wcsph_pair.launches, dl.delta_pair.launches)
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    # CPU tensors take the plain version: nothing was launched
    assert (wp.wcsph_pair.launches, dl.delta_pair.launches) == launches
    return {p: s.states['fluid'][p].numpy() for p in OUT}


@pytest.fixture(scope='module')
def jax_drop(tmp_path_factory):
    return _jax_eval(tmp_path_factory.mktemp('jax_drop'))


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_delta_drop_eval_matches_jax(engine, jax_drop):
    ref, choices, inputs, dt, strides = jax_drop
    assert choices == {('fluid', ('fluid',)): 'xla'}
    assert strides['m_mat'] == 9 and strides['gradrho'] == 3
    # the input is not at rest and the correction is not the identity
    assert np.abs(ref['gradrho']).max() > 1e-3
    assert np.abs(ref['m_mat'][:, 0] - 1.0).max() > 1e-2
    port = _port_eval(engine, inputs, dt, strides)
    for p in OUT:
        assert port[p].shape == ref[p].shape, p
        err = _scaled_err(port[p], ref[p])
        assert err <= TOL, '%s: scaled error %.3g' % (p, err)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_delta_sph_tracks_the_oracle():
    """6 EPEC steps of the nx=10 drop against the float64 oracle, as
    ``test_delta_sph_gradient_correction_1e6`` holds the JAX package."""
    from pysph_tpu_torch.base.cell_grid import CellGrid
    from pysph_tpu_torch.base.kernels import Gaussian
    from pysph_tpu_torch.base.utils import get_particle_array_wcsph
    from pysph_tpu_torch.config import Config
    from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
    from pysph_tpu_torch.sph.integrator import EPECIntegrator
    from pysph_tpu_torch.sph.integrator_step import WCSPHStep
    from pysph_tpu_torch.sph.scheme import WCSPHScheme

    c0, alpha, delta = 1400.0, 0.2, 0.1
    x, y, m, h, rho, u, v = _drop_particles(nx=10)
    oracle = NumpyDeltaSPH(x, y, m, h, rho, u, v, rho0=1.0, c0=c0,
                           gamma=7.0, alpha=alpha, beta=0.0, delta=delta)
    scheme = WCSPHScheme(
        ['fluid'], [], dim=2, rho0=1.0, c0=c0, h0=float(h[0]), hdx=1.3,
        gamma=7.0, alpha=alpha, beta=0.0, delta_sph=True, delta=delta)
    pa = get_particle_array_wcsph(
        name='fluid', x=x, y=y, m=m, rho=rho, h=h, u=u, v=v,
        cs=np.full(x.size, c0))
    scheme.setup_properties([pa], clean=False)
    config = Config(device='cpu', dtype=torch.float64)
    kernel = Gaussian(dim=2)
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0)
    a_eval = AccelerationEval([pa], scheme.get_equations(), kernel, config,
                              grid)
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    integrator = EPECIntegrator(fluid=WCSPHStep())
    integrator.set_acceleration_evals([a_eval])
    states = {'fluid': pa.to_device(config)}
    dt = 0.25 * 1.3 * 0.1 / (141 + c0)
    t = 0.0
    for _ in range(6):
        integrator.step(states, t, dt)
        oracle.epec_step(dt)
        t += dt
    s = {p: v.numpy() for p, v in states['fluid'].items()}
    for prop, ref in (('rho', oracle.rho), ('p', oracle.p),
                      ('x', oracle.x), ('y', oracle.y),
                      ('u', oracle.u), ('v', oracle.v)):
        err = _rel_l2(s[prop], ref)
        assert err <= 1e-6, '%s rel L2 %.3g > 1e-6' % (prop, err)


def _dam_break_app(engine='kernel'):
    from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
    app = DamBreak3D()
    app.setup(['-q', '--use-double', '--device', 'cpu', '--engine', engine,
               '--dx', '0.12', '--delta-sph', '--disable-output'])
    return app


def _dam_break(engine):
    return _dam_break_app(engine).solver.acceleration_evals[0]


def _plans(a_eval):
    return [(p.dest, p.op, [tuple(s) for s in p.sources])
            for p in a_eval._plans.values() if p is not None]


def test_kernel_engine_plans_every_delta_set():
    fluid = (wp.CONT | wp.MOM | wp.XSPH | wp.DCONT | wp.DMOM)
    drop = _port_app('kernel', ['--disable-output']).solver
    a_eval = drop.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = _plans(a_eval)
    assert [p[:2] for p in plans] == [('fluid', dl.delta_pair)] * 2 + [
        ('fluid', wp.wcsph_pair)]
    assert plans[0][2] == [('fluid', dl.MMAT, 2, 0.1)]
    assert plans[1][2] == [('fluid', dl.CORR | dl.GRAD, 2, 0.1)]
    (src,) = plans[2][2]
    # MomentumEquation's alpha is 0; MomentumEquationDeltaSPH takes it
    assert src[:3] == ('fluid', fluid, 1400.0) and src[3] == 0.0
    # the laminar viscosities' constants: no VISC or LVD term
    assert src[6:] == (0.1, 1400.0, 0.1, 1400.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0)
    # 3D: the moment in three dimensions, the correction in two
    plans = _plans(_dam_break('kernel'))
    assert plans[0] == ('fluid', dl.delta_pair, [('fluid', dl.MMAT, 3, 0.1)])
    assert plans[1] == ('fluid', dl.delta_pair,
                        [('fluid', dl.CORR | dl.GRAD, 2, 0.1)])
    assert [(d, op) for d, op, _ in plans[2:]] == [
        ('boundary', wp.wcsph_pair), ('obstacle', wp.wcsph_pair),
        ('fluid', wp.wcsph_pair)]
    assert [s[:2] for s in plans[4][2]] == [
        ('fluid', fluid), ('boundary', wp.CONT | wp.MOM),
        ('obstacle', wp.CONT | wp.MOM)]


def test_dense_engine_leaves_the_delta_sets_to_the_torch_engine():
    from pysph_tpu_torch.ops import dense_pair as dp
    a_eval = _port_app('dense', ['--disable-output']).solver \
        .acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'torch'}
    assert _plans(a_eval) == []
    a_eval = _dam_break('dense')
    assert a_eval.engine_choices[('fluid', ('fluid',))] == 'torch'
    assert a_eval.engine_choices[
        ('fluid', ('fluid', 'boundary', 'obstacle'))] == 'torch'
    assert [(d, op) for d, op, _ in _plans(a_eval)] == [
        ('boundary', dp.dense_pair), ('obstacle', dp.dense_pair)]


def test_delta_planner_takes_only_its_ordered_sets():
    from pysph_tpu_torch.base.kernels import Gaussian
    from pysph_tpu_torch.ops.pair_engine import (
        PairIneligible, plan_pair_phases)
    from pysph_tpu_torch.sph.wc.basic import (
        ContinuityEquationDeltaSPHPreStep as Grad)
    from pysph_tpu_torch.sph.wc.kernel_correction import (
        GradientCorrection as Corr, GradientCorrectionPreStep as Pre)
    k = Gaussian(dim=2)
    plan = plan_pair_phases('f', {'f': [Grad('f', ['f'])]}, k)
    assert plan.op is dl.delta_pair and plan.outputs == ('gradrho',)
    assert plan.sources == [dl.DeltaSource('f', dl.GRAD, 0, 0.1)]
    plan = plan_pair_phases('f', {'f': [Pre('f', ['f'], dim=2)],
                                  'g': [Pre('f', ['g'], dim=2)]}, k)
    assert plan.outputs == ('m_mat',) and len(plan.sources) == 2
    for sources in ({'f': [Grad('f', ['f']), Corr('f', ['f'])]},
                    {'f': [Corr('f', ['f'])]},
                    {'f': [Pre('f', ['f']), Grad('f', ['f'])]},
                    {'f': [Pre('f', ['f'], dim=2)],
                     'g': [Pre('f', ['g'], dim=3)]},
                    {'f': [Corr('f', ['f']), Grad('f', ['f'])],
                     'g': [Grad('f', ['g'])]}):
        with pytest.raises(PairIneligible):
            plan_pair_phases('f', sources, k)
    with pytest.raises(PairIneligible):
        plan_pair_phases('f', {'f': [Corr('f', ['f']), Grad('f', ['f'])]},
                         k, engine='dense')


def test_mixed_corrections_name_their_item():
    from pysph_tpu_torch.sph.wc.kernel_correction import (
        MixedGradientCorrection, MixedKernelCorrectionPreStep)
    for cls in (MixedKernelCorrectionPreStep, MixedGradientCorrection):
        with pytest.raises(NotImplementedError, match='item 21'):
            cls('f', ['f'])


def _drop_calls(dtype=torch.float64):
    """The pair calls of one eval of the perturbed delta-SPH drop."""
    from pysph_tpu_torch.tools_dev.time_walks import plan_calls
    app = _port_app('kernel', ['--disable-output'])
    s = app.solver
    st = s.states['fluid']
    rng = np.random.default_rng(3)
    n = st['x'].shape[0]
    st['u'] = st['u'] + torch.as_tensor(rng.normal(0.0, 10.0, n))
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n))
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    return plan_calls(s, [0])


def test_strided_column_pack_is_the_gather():
    """The fluid source of the main group packs gradrho's columns as its
    fourth plane; the pack's args point each column at its first value
    with stride 3, and the wcsph_pair and delta_pair args at their
    planes."""
    calls = _drop_calls()
    (_, _, plan, args), = [c for c in calls if c[2].op is wp.wcsph_pair]
    sources = args[4]
    src, cells, ps = sources[0]
    assert ps.terms & wp.DCONT
    assert wp.pack_layout(ps.terms)[3] == wp.GRADRHO + (None,)
    (rec,) = wp.pack_sources(sources)
    (ref,) = wp.pack_sources_reference(sources)
    assert torch.equal(rec, ref) and rec.shape[0] == 4
    order = cells.order.long()
    for c in range(3):
        assert torch.equal(rec[3, :, c], src['gradrho'][order, c])
    assert not rec[3, :, 3].any()
    assert torch.equal(rec[2, :, 0], src['rho'][order])
    wa, _, buf = wp.pair_args('wcsph_pair', *args, packed=True)
    es = buf.element_size()
    pack = wa.pack.src[0]
    for c in range(3):
        assert pack.prop[3][c] == src['gradrho'].data_ptr() + c * es
        assert pack.stride[3][c] == 3
    assert pack.stride[0][0] == 1 and pack.prop[3][3] is None
    plane = src['x'].shape[0] * 4 * es
    assert wa.src[0].grad == wa.src[0].pos + 3 * plane
    assert wa.gradrho == args[0]['gradrho'].data_ptr()
    # the delta pre-phases pack {x y z h} and {m rho 0 0}
    for _, _, plan, args in calls:
        if plan.op is not dl.delta_pair:
            continue
        (rec,) = dl.pack_sources(args[4])
        assert torch.equal(rec, dl.pack_sources_reference(args[4])[0])
        assert torch.equal(rec[1, :, 1], src['rho'][order])
        da, out, _ = dl.delta_args(*args)
        assert da.src[0].mass == da.src[0].pos + plane
        (name,) = plan.outputs
        assert out[name].shape == args[0][name].shape


def test_plain_versions_and_accepted_counts():
    """Each delta_pair call's plain version equals the torch engine's
    groups (through the evaluator), and the correction is accepted for
    most pairs, not all."""
    calls = _drop_calls()
    delta = [c for c in calls if c[2].op is dl.delta_pair]
    assert [c[2].outputs for c in delta] == [('m_mat',), ('gradrho',)]
    _, _, plan, args = delta[1]
    dest, cells, wm, pre, sources, grid, kernel = args
    got = dl.delta_pair(*args)['gradrho']
    assert torch.equal(got, plan.reference(*args)['gradrho'])
    count = torch.zeros(dest['x'].shape[0], dtype=torch.int32)
    dl.delta_pair(*args, accepted=count)
    pairs = torch.zeros_like(count)
    i, _ = grid.neighbor_pairs(dest, cells, sources[0][0], sources[0][1],
                               (0, dest['x'].shape[0]))
    pairs.index_add_(0, i, torch.ones_like(i, dtype=torch.int32))
    assert bool((count <= pairs).all())
    assert 0.5 * int(pairs.sum()) < int(count.sum()) < int(pairs.sum())


def _linked(a_eval):
    """[(dest, moment plan, gradient plan)] of the evaluator's links."""
    return [(p.dest, p, p.link.gradient) for p in a_eval._plans.values()
            if p is not None and p.link is not None and p is p.link.moment]


def test_link_forms_on_the_delta_paths():
    """The moment plan and the corrected gradient plan of the fluid share
    a link on the drop and on dam_break_3d, and no other plan has one."""
    for a_eval in (_port_app('kernel', ['--disable-output']).solver
                   .acceleration_evals[0], _dam_break('kernel')):
        (dest, moment, gradient), = _linked(a_eval)
        assert dest == 'fluid' and moment.link is gradient.link
        assert moment.outputs == ('m_mat',)
        assert gradient.sources[0].terms == dl.CORR | dl.GRAD
        assert [p for p in a_eval._plans.values() if p is not None and
                p.link is not None] == [moment, gradient]


def _link_case(between=False, gradient_sources=('f',), moves=False):
    """The plans of a moment group and a gradient group of dest ``f``
    (with a source-less group between them, a source ``g`` more for the
    gradient, or an equation in the moment group that moves ``f``),
    and the links ``link_delta`` makes of them."""
    from pysph_tpu_torch.base.kernels import WendlandQuintic
    from pysph_tpu_torch.ops.pair_engine import link_pairs as link_delta
    from pysph_tpu_torch.ops.pair_engine import plan_pair_phases
    from pysph_tpu_torch.sph.equation import Equation, Group
    from pysph_tpu_torch.sph.wc.basic import (
        ContinuityEquationDeltaSPHPreStep as Grad)
    from pysph_tpu_torch.sph.wc.kernel_correction import (
        GradientCorrection as Corr, GradientCorrectionPreStep as Pre)

    class Shift(Equation):
        def initialize(self, d_idx, d_x):
            d_x[d_idx] += 0.0

    kernel = WendlandQuintic(dim=3)
    srcs = list(gradient_sources)
    moment = Group([Pre('f', ['f'], dim=3)] +
                   ([Shift('f', None)] if moves else []), real=False)
    gradient = Group([Corr('f', srcs), Grad('f', srcs)])
    groups = [moment] + ([Group([Shift('g', None)])] if between else []) + [
        gradient]
    plans = {(id(moment), 'f'): plan_pair_phases(
        'f', {'f': [moment.equations[0]]}, kernel),
        (id(gradient), 'f'): plan_pair_phases(
            'f', {s: list(gradient.equations) for s in srcs}, kernel)}
    return plans, link_delta(groups, plans)


def test_link_forms_only_where_nothing_moves_between():
    plans, links = _link_case()
    (link,) = links
    assert [p.link for p in plans.values()] == [link, link]
    assert _link_case(between=True)[1] == []
    assert _link_case(gradient_sources=('f', 'g'))[1] == []
    assert _link_case(moves=True)[1] == []


def test_neighbours_reference_is_the_walk_order():
    """The positions of ``neighbours_reference`` are the pairs of
    ``grid.neighbor_pairs``, one dest after another in sorted order,
    and each dest's are those of the lanes' rule (``cell_walk``'s spans
    in stencil order, ascending in each) that hold the support test;
    over three sources (dam_break_3d's fluid call), source s numbered
    after the sources before it."""
    from pysph_tpu_torch.ops import cell_walk, pair_link
    from pysph_tpu_torch.tools_dev.time_walks import plan_calls
    app = _dam_break_app()
    calls = plan_calls(app.solver, [0])
    (_, _, _, args), = [c for c in calls if c[1] == 'fluid' and
                        c[2].op is wp.wcsph_pair]
    dest, dcells, _, _, sources, grid, _ = args
    assert len(sources) == 3
    count, positions = pair_link.neighbours_reference(dest, dcells, sources,
                                                      grid)
    n = dest['x'].shape[0]
    order = dcells.order.long()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n)
    pairs, base = [], 0
    for src, cells, _ in sources:
        i, j = grid.neighbor_pairs(dest, dcells, src, cells, (0, n))
        where = torch.empty_like(cells.order, dtype=torch.int64)
        where[cells.order.long()] = torch.arange(cells.order.shape[0])
        pairs.append((rank[i], base + where[j]))
        base += src['x'].shape[0]
    assert int(count.sum()) == sum(p[0].numel() for p in pairs) == \
        positions.numel()
    offsets = torch.cumsum(count.long(), 0) - count.long()
    rs = grid.radius_scale
    d = {c: dest[c].numpy() for c in 'xyzh'}
    spans = [cell_walk.walk_spans(grid, dcells, cells).tolist()
             for _, cells, _ in sources]
    for p in range(0, n, max(1, n // 40)):
        i = int(order[p])
        want, base = [], 0
        for (src, cells, _), (ri, gj), rows in zip(sources, pairs, spans):
            s = {c: src[c].numpy() for c in 'xyzh'}
            sorder = cells.order.tolist()
            mine = []
            for k0, k1 in rows[p]:
                for k in range(k0, k1):
                    j = sorder[k]
                    dx, dy, dz = (d[c][i] - s[c][j] for c in 'xyz')
                    sup = rs * max(d['h'][i], s['h'][j])
                    if dx * dx + dy * dy + dz * dz < sup * sup:
                        mine.append(base + k)
            assert gj[ri == p].tolist() == mine
            want += mine
            base += src['x'].shape[0]
        assert positions[offsets[p]:offsets[p] + count[p]].tolist() == want


def test_plain_handoff_and_its_misuse_raise():
    """On the CPU the linked pair runs the plain versions: the moment
    call's hand-off is empty (the plain gradient walks), the linked
    gradient equals the walking one, and a gradient without its
    hand-off, a moment given one, a hand-off of other sources and the
    card's check of CPU calls raise."""
    from pysph_tpu_torch.tools_dev import delta_check
    calls = _drop_calls()
    ((_, _, moment, margs), (_, _, gradient, gargs)), = \
        delta_check.linked_calls(calls)
    with pytest.raises(ValueError, match='off the card'):
        delta_check.check_linked(calls, 'drop nx=20 float64, cpu')
    with pytest.raises(RuntimeError, match='hand-off'):
        moment.link.run(gradient, gargs)
    _, handoff = dl.delta_pair(*margs, emit=True)
    assert handoff.buf.numel() == handoff.nbr.numel() == 0
    assert handoff.count is None
    with pytest.raises(ValueError, match='only a moment call'):
        dl.delta_pair(*gargs, emit=True)
    with pytest.raises(ValueError, match='takes no hand-off'):
        dl.delta_pair(*margs, handoff=handoff)
    with pytest.raises(ValueError, match='a hand-off of'):
        dl.delta_pair(*gargs, handoff=handoff._replace(
            sources=(('other', 1),)))
    out = moment.link.run(moment, margs)
    assert torch.equal(out['m_mat'], dl.delta_pair(*margs)['m_mat'])
    assert moment.link.handoff is not None
    assert torch.equal(moment.link.run(gradient, gargs)['gradrho'],
                       dl.delta_pair(*gargs)['gradrho'])
    assert moment.link.handoff is None


def test_linked_pair_counts_one_walk():
    """The work of a linked pair (``roofline.delta_work``) holds one
    walk's support tests: the consuming gradient call counts its pairs'
    work and no candidate."""
    from pysph_tpu_torch.tools_dev import delta_check, roofline
    ((_, _, _, margs), (_, _, _, gargs)), = delta_check.linked_calls(
        _drop_calls())
    walked = roofline.delta_work(*gargs)
    listed = roofline.delta_work(*gargs, walks=False)
    assert walked['candidates'] > walked['pairs'] > 0
    assert listed['candidates'] == listed['visited'] == 0
    assert (listed['pairs'], listed['bytes']) == (walked['pairs'],
                                                  walked['bytes'])
    assert walked['flops'] - listed['flops'] == \
        walked['candidates'] * roofline.SUPPORT_FLOPS
    assert roofline.delta_work(*margs)['candidates'] == walked['candidates']


def test_chunks_carry_the_strided_props(tmp_path):
    """The delta-SPH drop in chunks of 4 against the per-step loop:
    every prop, m_mat and gradrho included, equal, as
    ``tests/test_torch_chunking.py`` holds the other paths."""
    runs = []
    for k in (4, 1):
        app = _port_app('kernel', ['--max-steps', '10', '--disable-output'])
        s = app.solver
        s.n_damp = 0
        s.chunk_steps = k
        app.solve()
        runs.append(s)
    got, want = runs
    assert got.count == want.count == 10
    assert (got.t, got.dt) == (want.t, want.dt)
    assert got.states['fluid']['m_mat'].shape[1] == 9
    for p, v in want.states['fluid'].items():
        mine = got.states['fluid'][p]
        scale = max(float(v.abs().max()), 1e-300) if v.is_floating_point() \
            else 1.0
        assert float((mine - v).abs().max()) <= 1e-12 * scale, p


VISCOSITY = {
    'LaminarViscosity': dict(nu=0.01),
    'MonaghanSignalViscosityFluids': dict(alpha=0.3, h=0.13),
    'ClearyArtificialViscosity': dict(dim=2, alpha=0.5),
    'LaminarViscosityDeltaSPH': dict(dim=2, rho0=1.0, nu=0.01),
}


@pytest.mark.parametrize('name', sorted(VISCOSITY))
def test_viscosity_matches_jax(name):
    """One eval of each viscosity equation (torch engine) on a seeded
    jittered 2D lattice against pysph_tpu's ``SPHEvaluator`` (1e-10)."""
    from pysph_tpu.base.kernels import CubicSpline as JaxCubicSpline
    from pysph_tpu.base.utils import \
        get_particle_array_wcsph as jax_particle_array
    from pysph_tpu.sph import equation as jax_equation
    from pysph_tpu.sph.wc import viscosity as jax_viscosity
    from pysph_tpu.tools.sph_evaluator import SPHEvaluator
    from pysph_tpu_torch.base.cell_grid import CellGrid
    from pysph_tpu_torch.base.kernels import CubicSpline
    from pysph_tpu_torch.base.utils import get_particle_array_wcsph
    from pysph_tpu_torch.config import Config
    from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
    from pysph_tpu_torch.sph.equation import Group
    from pysph_tpu_torch.sph.wc import viscosity

    rng = np.random.default_rng(31)
    dx = 0.1
    x, y = np.meshgrid(np.arange(12) * dx, np.arange(12) * dx)
    n = x.size
    props = dict(x=x.ravel() + 0.1 * dx * rng.normal(size=n),
                 y=y.ravel() + 0.1 * dx * rng.normal(size=n),
                 u=rng.normal(size=n), v=rng.normal(size=n),
                 m=np.full(n, dx * dx), h=np.full(n, 1.3 * dx),
                 rho=1.0 + 0.01 * rng.normal(size=n),
                 cs=10.0 + rng.normal(size=n))
    kw = VISCOSITY[name]
    jpa = jax_particle_array(name='fluid', **props)
    SPHEvaluator(arrays=[jpa], equations=[jax_equation.Group(equations=[
        getattr(jax_viscosity, name)('fluid', ['fluid'], **kw)])], dim=2,
        kernel=JaxCubicSpline(dim=2)).evaluate(0.0, 0.1)
    pa = get_particle_array_wcsph(name='fluid', **props)
    config = Config(device='cpu', dtype=torch.float64)
    a_eval = AccelerationEval(
        [pa], [Group(equations=[getattr(viscosity, name)(
            'fluid', ['fluid'], **kw)])], CubicSpline(dim=2), config,
        CellGrid.from_particles([pa], dim=2, radius_scale=2.0))
    # LaminarViscosity is wcsph_pair's VISC term, LaminarViscosityDeltaSPH
    # its LVD term (their plain version here); no kernel takes the others
    assert set(a_eval.engine_choices.values()) == {
        'kernel' if name.startswith('LaminarViscosity') else 'torch'}
    states = {'fluid': pa.to_device(config)}
    a_eval.update_and_compute(0.0, 0.1, states)
    for p in ('au', 'av'):
        ref = np.asarray(jpa.properties[p])[:n]
        assert np.abs(ref).max() > 1e-3, p
        assert _scaled_err(states['fluid'][p].numpy(), ref) <= TOL, p


@pytest.mark.parametrize('delta_sph', [False, True])
def test_scheme_viscosity_branch_matches_jax(delta_sph, tmp_path):
    """``nu != 0`` puts ``LaminarViscosity`` (``LaminarViscosityDeltaSPH``
    with delta-SPH) in the fluid's main group, as the reference does:
    one eval of the drop against the JAX XLA engine (1e-10)."""
    from pysph_tpu.sph.wc.viscosity import (
        LaminarViscosity as JaxLaminar,
        LaminarViscosityDeltaSPH as JaxLaminarDelta)

    nu = 0.05
    argv = ['--nx', '20'] + (['--delta-sph'] if delta_sph else [])

    class JaxDrop(JaxEllipticalDrop):
        def configure_scheme(self):
            super().configure_scheme()
            self.scheme.configure(nu=nu)

    class Drop(EllipticalDrop):
        def configure_scheme(self):
            super().configure_scheme()
            self.scheme.configure(nu=nu)

    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = False
        ref = JaxDrop()
        ref.setup(['-q', '--disable-output', '-d', str(tmp_path)] + argv)
        want = JaxLaminarDelta if delta_sph else JaxLaminar
        assert any(isinstance(eq, want) for g in ref.equations
                   for eq in g.equations)
        s = ref.solver
        s._sync_to_device()
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
    finally:
        cfg._use_pallas = old
    n = ref.particles[0].get_number_of_particles()
    port = Drop()
    port.setup(['-q', '--disable-output', '--use-double', '--device',
                'cpu'] + argv)
    a_eval = port.solver.acceleration_evals[0]
    # the fluid's main group holds the viscosity: wcsph_pair's VISC term,
    # and with delta-SPH LaminarViscosityDeltaSPH, its LVD term
    assert a_eval.engine_choices[('fluid', ('fluid',))] == 'kernel'
    plan = next(p for p in a_eval._plans.values()
                if p is not None and p.op is wp.wcsph_pair)
    assert plan.sources[0].terms & (wp.LVD if delta_sph else wp.VISC)
    port.solver.integrator.initial_acceleration(port.solver.states, 0.0,
                                                s.dt)
    for p in ('arho', 'au', 'av', 'ax', 'ay'):
        got = port.solver.states['fluid'][p].numpy()
        assert _scaled_err(got, np.asarray(states['fluid'][p])[:n]) <= \
            TOL, p
