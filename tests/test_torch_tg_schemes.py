"""The port's Taylor-Green vortex under ``--scheme wcsph`` and ``--scheme
gtvf`` against pysph_tpu's, float64 on the CPU, on the box periodic in x
and y (``examples/taylor_green.py``, ``QuinticSpline``, a fixed dt).

- The scheme's groups are the reference's: the equations' types, dests,
  sources and constants (``WCSPHScheme`` with ``LaminarViscosity``;
  ``GTVFScheme`` without walls, with ``MomentumEquationViscosity``).
- One evaluation of every evaluator at nx=20 from ``--perturb 0.1`` and
  a seeded density jitter, to 1e-10 of ``max|ref|``, against the JAX XLA
  engine: ``wcsph`` on the kernel engine (``wcsph_pair``, its plain
  version here) and the dense one (``dense_pair``), ``gtvf`` on
  ``gtvf_pair``, every pair phase planned on the periodic grid.
- Three steps to 1e-9 in x y u v p rho.
- The chunks against the per-step loop (``time_chunks.gate``, the gates
  the card runs: 30 steps at nx=40 with particles wrapping).
- The plain ``wcsph_pair`` / ``dense_pair`` / ``gtvf_pair`` with
  ``VISC`` / ``MVISC`` on the periodic grid against the torch engine.
- The planners take a periodic grid for ``wcsph``, ``dense``, ``gtvf``
  and ``delta`` (``delta_pair``'s periodic branch).
"""

import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu.config import get_config
from pysph_tpu.examples.taylor_green import TaylorGreen as JaxTaylorGreen
from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops.pair_engine import plan_pair_phases
from pysph_tpu_torch.sph.wc.kernel_correction import (
    GradientCorrectionPreStep)
from pysph_tpu_torch.tools_dev import time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

NX = 20
# the JAX float64 time loop hands a fixed dt over as float32: a dt that
# float32 holds exactly (the example's is 1.14e-3 at nx=20)
DT = 2.0 ** -10
ARGV = ['--nx', str(NX), '--perturb', '0.1', '--disable-output', '-q',
        '--dt', repr(DT)]
#: the props each evaluator of a scheme writes
EVAL_OUT = {'wcsph': (('p', 'cs', 'arho', 'au', 'av', 'ax', 'ay'),),
            'gtvf': (('arho',), ('rho', 'rhodiv', 'p', 'p0', 'au', 'av',
                                 'auhat', 'avhat'))}
STEP_PROPS = ('x', 'y', 'u', 'v', 'p', 'rho')
EVAL_TOL = 1e-10
STEP_TOL = 1e-9
#: (scheme, engine) of the runs, and the kernel their pair phases take
RUNS = [('wcsph', 'kernel'), ('wcsph', 'dense'), ('gtvf', 'kernel')]
OPS = {('wcsph', 'kernel'): wp.wcsph_pair, ('wcsph', 'dense'): dp.dense_pair,
       ('gtvf', 'kernel'): gp.gtvf_pair}
RUN_IDS = ['%s-%s' % r for r in RUNS]


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _jitter(particles):
    """A seeded 1% density jitter (the positions are ``--perturb``'s)."""
    rng = np.random.default_rng(31)
    for pa in particles:
        n = pa.get_number_of_particles()
        pa.properties['rho'][:] *= 1.0 + 0.01 * rng.normal(size=n)


def _snapshot(particles):
    return {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                      {k: v.copy() for k, v in pa.constants.items()},
                      dict(pa.stride)) for pa in particles}


def _jax_app(out_dir, scheme, argv=ARGV):
    cfg = get_config()
    old = cfg._use_pallas
    try:
        cfg.use_pallas = False
        app = JaxTaylorGreen()
        app.setup(['-d', str(out_dir), '--scheme', scheme] + list(argv))
        return app
    finally:
        cfg._use_pallas = old


def _jax_eval(scheme, index):
    """Evaluator ``index`` once on the jittered start in pysph_tpu's XLA
    engine: ({prop: ndarray}, the input snapshot)."""
    import jax
    tmp = tempfile.mkdtemp()
    cfg = get_config()
    old = cfg._use_pallas
    try:
        app = _jax_app(tmp, scheme)
        _jitter(app.particles)
        inputs = _snapshot(app.particles)
        s = app.solver
        s._sync_to_device()
        cfg.use_pallas = False
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
        n = app.particles[0].get_number_of_particles()
        out = {p: np.asarray(states['fluid'][p])[:n]
               for p in EVAL_OUT[scheme][index]}
        return out, inputs
    finally:
        cfg._use_pallas = old
        shutil.rmtree(tmp, ignore_errors=True)


def _port_app(scheme, engine, argv=ARGV, inputs=None):
    app = TaylorGreen()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine,
               '--scheme', scheme] + list(argv))
    if inputs is not None:
        s = app.solver
        s.particles = app.particles = [
            ParticleArray.from_numpy(name, *args)
            for name, args in inputs.items()]
        s._sync_to_device()
    return app


def _port_eval(scheme, engine, index, inputs):
    s = _port_app(scheme, engine, inputs=inputs).solver
    a_eval = s.acceleration_evals[index]
    a_eval.update_and_compute(0.0, s.dt, s.states)
    return s, a_eval


def _equation_rows(equations):
    """[(stage, group, real, [(type name, dest, sources, constants)])] of
    a scheme's equations (a list of groups, or ``MultiStageEquations``),
    the constants being the equation's public attributes."""
    # either package's MultiStageEquations holds a list a stage
    stages = equations.groups if hasattr(equations, 'groups') \
        else [equations]
    rows = []
    for k, groups in enumerate(stages):
        for g, group in enumerate(groups):
            eqs = []
            for eq in group.equations:
                # var_name: the JAX package's name for its generated code
                consts = {a: v for a, v in vars(eq).items()
                          if not a.startswith('_') and a not in (
                              'dest', 'sources', 'name', 'no_source',
                              'var_name')}
                eqs.append((type(eq).__name__, eq.dest,
                            None if eq.sources is None else
                            list(eq.sources), consts))
            rows.append((k, g, bool(group.real), eqs))
    return rows


@pytest.mark.parametrize('scheme', ['wcsph', 'gtvf'])
def test_scheme_groups_are_the_reference(scheme):
    tmp = tempfile.mkdtemp()
    try:
        ref = _jax_app(tmp, scheme)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = _port_app(scheme, 'kernel')
    want = _equation_rows(ref.scheme.scheme.get_equations())
    got = _equation_rows(port.scheme.scheme.get_equations())
    assert got == want
    names = [e[0] for row in got for e in row[3]]
    assert ('LaminarViscosity' if scheme == 'wcsph'
            else 'MomentumEquationViscosity') in names
    s = port.solver
    assert type(s.kernel) is QuinticSpline
    assert type(s.integrator).__name__ == type(ref.solver.integrator).__name__
    assert s.dt == ref.solver.dt == DT and not s.adaptive_timestep
    assert s.grid.periodic == (True, True, False)


@pytest.fixture(scope='module')
def jax_evals():
    return {(scheme, index): _jax_eval(scheme, index)
            for scheme in EVAL_OUT for index in range(len(EVAL_OUT[scheme]))}


@pytest.mark.parametrize('scheme,engine', RUNS, ids=RUN_IDS)
def test_one_eval_matches_jax(scheme, engine, jax_evals):
    for index in range(len(EVAL_OUT[scheme])):
        ref, inputs = jax_evals[scheme, index]
        s, a_eval = _port_eval(scheme, engine, index, inputs)
        assert set(a_eval.engine_choices.values()) == {engine}
        plans = [p for p in a_eval._plans.values() if p is not None]
        assert plans and {p.op for p in plans} == {OPS[scheme, engine]}
        for p, want in ref.items():
            got = s.states['fluid'][p].numpy()
            err = _scaled_err(got, want)
            assert err <= EVAL_TOL, '%s eval %d %s: scaled error %.3g' % (
                scheme, index, p, err)


@pytest.mark.parametrize('scheme,engine', RUNS, ids=RUN_IDS)
def test_three_steps_match_jax(scheme, engine):
    argv = ARGV + ['--max-steps', '3']
    tmp = tempfile.mkdtemp()
    try:
        ref = _jax_app(tmp, scheme, argv)
        _jitter(ref.particles)
        ref.solver._sync_to_device()
        inputs = _snapshot(ref.particles)
        ref.solve()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = _port_app(scheme, engine, argv, inputs)
    port.solve()
    s = port.solver
    assert s.count == ref.solver.count == 3
    assert abs(s.t - ref.solver.t) <= STEP_TOL * ref.solver.t
    got, want = port.particles[0], ref.particles[0]
    for p in STEP_PROPS:
        err = _scaled_err(getattr(got, p), np.asarray(getattr(want, p)))
        assert err <= STEP_TOL, '%s after 3 steps: %.3g' % (p, err)


@pytest.mark.parametrize('case', ['taylor_green wcsph nx=40',
                                  'taylor_green wcsph nx=40 dense',
                                  'taylor_green gtvf nx=40'])
def test_chunks_match_the_per_step_loop(case):
    held = time_chunks.gate(case, 'cpu')
    assert held['steps'] == time_chunks.GATE_STEPS
    assert held['max_scaled_err'] <= time_chunks.TOL
    assert held['rebuilds'] >= 2


@pytest.mark.parametrize('scheme,engine', RUNS, ids=RUN_IDS)
def test_plain_kernels_equal_the_torch_engine(scheme, engine):
    """Each evaluator once on the jittered start: the kernel's plain
    version (on CPU tensors, the torch pair engine running the
    equations that the plan's term masks stand for: ``VISC`` /
    ``MVISC`` with their ``nu``) against the torch engine running the
    scheme's own groups, on the periodic grid."""
    tmp = tempfile.mkdtemp()
    try:
        app = _jax_app(tmp, scheme)
        _jitter(app.particles)
        inputs = _snapshot(app.particles)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    visc = wp.VISC if scheme == 'wcsph' else gp.MVISC
    for index in range(len(EVAL_OUT[scheme])):
        got, a_eval = _port_eval(scheme, engine, index, inputs)
        want, _ = _port_eval(scheme, 'torch', index, inputs)
        assert a_eval.grid.is_periodic
        terms = [ps.terms for p in a_eval._plans.values() if p is not None
                 for ps in p.sources]
        assert any(t & visc for t in terms) == (index == len(
            EVAL_OUT[scheme]) - 1)
        for p in EVAL_OUT[scheme][index]:
            err = _scaled_err(got.states['fluid'][p].numpy(),
                              want.states['fluid'][p].numpy())
            assert err <= 1e-13, '%s eval %d %s: %.3g' % (scheme, index, p,
                                                          err)


@pytest.mark.parametrize('scheme,engine', RUNS + [('delta', 'kernel')],
                         ids=RUN_IDS + ['delta-kernel'])
def test_planners_take_the_periodic_grid(scheme, engine):
    kernel = QuinticSpline(dim=2)
    if scheme == 'delta':
        # the delta-SPH groups of --delta-sph on the periodic box
        app = _port_app('wcsph', engine, ARGV + ['--delta-sph'])
        plans = [p for a_eval in app.solver.acceleration_evals
                 for p in a_eval._plans.values() if p is not None]
        assert app.solver.grid.is_periodic
        assert sum(p.op is dl.delta_pair for p in plans) == 2
        assert all(p.link is not None for p in plans
                   if p.op is dl.delta_pair)
        eqs = {'fluid': [GradientCorrectionPreStep('fluid', ['fluid'],
                                                   dim=2)]}
        assert plan_pair_phases('fluid', eqs, kernel).op is dl.delta_pair
        return
    app = _port_app(scheme, engine)
    for a_eval in app.solver.acceleration_evals:
        for group in a_eval.groups:
            sources = {}
            for eq in group.equations:
                if eq.sources:
                    for src in eq.sources:
                        sources.setdefault(src, []).append(eq)
            if not sources:
                continue
            plan = plan_pair_phases('fluid', sources, kernel, engine)
            assert plan.op is OPS[scheme, engine]
