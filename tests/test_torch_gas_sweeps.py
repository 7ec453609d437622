"""``GasDScheme``'s density iteration as the card runs it: the gated sweep
(``ops/gasd_pair.py::gasd_sweep``, on the CPU its plain version) under a
``SweepPlan`` (``sph/acceleration_eval.py::_run_swept``), the gas runs in
chunks, the binning's flag of a state that is not finite and its order
on crowded cells; float64 on the CPU, inputs seeded with numpy.

- The iterated group alone (``SummationDensity`` with
  ``density_iterations``, re-binned every sweep) on a jittered Sedov
  lattice in a periodic box, h moved by up to 5%, against the JAX
  package's ``_run_iterated`` (its ``lax.while_loop``): the same sweeps
  (host callbacks in the JAX ``post_loop``) and ``h``, ``rho``,
  ``omega``, ``converged``, ``arho``, ``ah`` within 1e-10 relative; with
  the loop stopped by convergence, by ``min_iterations`` and by
  ``max_iterations``.  The slots of a chunk (``active`` given) give the
  host loop's bits.
- ``sedov --nx 15`` (``mpm`` and ``gsph``) in chunks of 4 equal to the
  per-step loop bit for bit, and with one slot and ``min_iterations`` 2
  (every chunk runs out and is redone with more slots) too.
- A NaN h raises ``FloatingPointError`` at the solver's read, in chunks
  and per step, and in a later chunk with no redo; the plain binning's ``order`` is the stable sort's on a
  state crowded into one cell and on the grid's clamped edges.
"""

import jax
import numpy as np
import pytest
import torch

from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import Gaussian as JaxGaussian
from pysph_tpu.base.utils import get_particle_array_gasd as jax_gasd_array
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.gas_dynamics import basic as jax_basic
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import Gaussian
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.gas_dynamics.sedov import SedovPointExplosion
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.ops.pair_engine import SweepPlan
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics import basic
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
CPU = dict(device='cpu', dtype=torch.float64)
DT = 1e-4
NX = 15
#: the JAX grid's cell capacity over its setup's occupancy, as
#: ``tests/test_torch_gas_dynamics.py``'s
JAX_CAPACITY_SLACK = 2.0
_FROM_PARTICLES = GridSpec.from_particles.__func__
OUT = ('h', 'rho', 'omega', 'converged', 'arho', 'ah')
#: {case: (min_iterations, max_iterations)}: stopped by convergence, by
#: min_iterations past it, by max_iterations before it
BOUNDS = {'converged': (0, 50), 'min': (9, 50), 'max': (0, 2)}


def _roomy_cells(cls, *args, **kw):
    kw.setdefault('capacity_slack', JAX_CAPACITY_SLACK)
    return _FROM_PARTICLES(cls, *args, **kw)


def _lattice(make, seed=11):
    """Sedov's lattice filling [-0.5, 0.5]^2 (periodic), jittered by a
    tenth of dx, with seeded velocities; h0 1.2 dx varied by 10% and h
    moved from it by up to 5%, so that the iteration has sweeps to run."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / NX
    g = -0.5 + (np.arange(NX) + 0.5) * dx
    x, y = (c.ravel() for c in np.meshgrid(g, g))
    n = x.size
    h0 = 1.2 * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    return make(name='fluid', x=x + 0.1 * dx * rng.uniform(-1, 1, n),
                y=y + 0.1 * dx * rng.uniform(-1, 1, n),
                u=0.3 * rng.normal(size=n), v=0.3 * rng.normal(size=n),
                m=dx * dx, rho=1.0, h0=h0,
                h=h0 * (1.0 + 0.05 * rng.uniform(-1, 1, n)), e=1.0)


def _box(cls):
    return cls(xmin=-0.5, xmax=0.5, ymin=-0.5, ymax=0.5, periodic_in_x=True,
               periodic_in_y=True)


def _group(mod, group_cls, bounds):
    lo, hi = bounds
    return [group_cls(equations=[mod.SummationDensity(
        dest='fluid', sources=['fluid'], dim=2, density_iterations=True)],
        update_nnps=True, iterate=True, min_iterations=lo,
        max_iterations=hi)]


_LOG = []
_JAX_POST_LOOP = jax_basic.SummationDensity.post_loop


def _counting_post_loop(self, d_idx, d_arho, d_rho, d_div, d_omega, d_dwdh,
                        d_h0, d_h, d_m, d_ah, d_converged):
    jax.debug.callback(lambda: _LOG.append(1), ordered=True)
    _JAX_POST_LOOP(self, d_idx, d_arho, d_rho, d_div, d_omega, d_dwdh,
                   d_h0, d_h, d_m, d_ah, d_converged)


_JAX = {}


@pytest.fixture(scope='module')
def jax_sweeps():
    """{case: (props, sweeps)} of the JAX evaluator's iterated group."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_basic.SummationDensity, 'post_loop',
                   _counting_post_loop)
        mp.setattr(GridSpec, 'from_particles', classmethod(_roomy_cells))
        for case, bounds in BOUNDS.items():
            arr = _lattice(jax_gasd_array)
            ev = JaxEvaluator([arr], _group(jax_basic, JaxGroup, bounds),
                              dim=2, kernel=JaxGaussian(dim=2),
                              domain_manager=_box(JaxDomain))
            _LOG.clear()
            ev.evaluate(t=0.0, dt=DT)
            jax.effects_barrier()
            _JAX[case] = ({p: np.asarray(arr.properties[p]).copy()
                           for p in OUT}, len(_LOG))
    return _JAX


def _port(bounds):
    arr = _lattice(get_particle_array_gasd)
    ev = SPHEvaluator([arr], _group(basic, Group, bounds), dim=2,
                      kernel=Gaussian(dim=2),
                      domain_manager=_box(DomainManager),
                      config=Config(engine='kernel', **CPU))
    return arr, ev


@pytest.mark.parametrize('case', sorted(BOUNDS))
def test_plain_sweep_matches_jax_iterated_group(case, jax_sweeps):
    want, sweeps = jax_sweeps[case]
    arr, ev = _port(BOUNDS[case])
    a_eval = ev.func_eval
    plan, = a_eval.sweep_plans()
    assert isinstance(plan, SweepPlan) and not a_eval.host_iterated
    ev.evaluate(t=0.0, dt=DT)
    lo, hi = BOUNDS[case]
    assert a_eval.sweeps == [sweeps]
    if case == 'converged':
        assert lo < sweeps < hi
    else:
        assert sweeps == (lo if case == 'min' else hi)
    assert a_eval.binnings == sweeps
    for p, w in want.items():
        got = np.asarray(arr.properties[p])
        if p == 'converged':
            np.testing.assert_array_equal(got, w)
            assert (w == 1.0).all() == (case != 'max')
            continue
        err = np.abs(got - w).max() / np.abs(w).max()
        assert err <= TOL, (case, p, err)


@pytest.mark.parametrize('case', sorted(BOUNDS))
def test_slots_give_the_host_loops_bits(case):
    """The sweeps in a chunk's slots (``active`` set, as many slots as the
    host loop swept and more) give the host loop's state bit for bit,
    the same sweeps logged, and flag no shortage; one slot short of them
    flags it."""
    arr, ev = _port(BOUNDS[case])
    a_eval = ev.func_eval
    grid = a_eval.grid
    states = {'fluid': arr.to_device(a_eval.config)}
    start = dict(states['fluid'])
    host = {'fluid': dict(start)}
    a_eval.compute(0.0, DT, host, grid.handle_for(None, host))
    sweeps = a_eval.sweeps[-1]
    plan, = a_eval.sweep_plans()
    for slots, short in ((sweeps, False), (sweeps + 3, False),
                         (sweeps - 1, True)):
        if slots < 1:
            continue
        a_eval.drop_own_binnings()
        plan.slots = slots
        grid.sweep_overflow = torch.zeros((), dtype=torch.bool)
        run = {'fluid': dict(start)}
        a_eval.compute(0.0, DT, run, grid.handle_for(None, run),
                       active=torch.ones((), dtype=torch.bool))
        assert bool(grid.sweep_overflow) == short
        grid.sweep_overflow = None
        if short:
            continue
        assert a_eval.sweeps[-1] == sweeps
        for p, v in host['fluid'].items():
            assert torch.equal(run['fluid'][p], v), (case, slots, p)
    # an inactive evaluation sweeps nothing and logs no sweep
    logged = len(a_eval.sweeps)
    run = {'fluid': dict(start)}
    a_eval.compute(0.0, DT, run, grid.handle_for(None, run),
                   active=torch.zeros((), dtype=torch.bool))
    assert len(a_eval.sweeps) == logged
    for p in OUT:
        assert torch.equal(run['fluid'][p], start[p]), p


def _solve(k, extra=(), slots=None, min_iterations=None, nan_at=None,
           steps=13):
    app = SedovPointExplosion()
    app.setup(['--device', 'cpu', '--use-double', '-q', '--disable-output',
               '--nx', str(NX), '--max-steps', str(steps), *extra])
    s = app.solver
    s.chunk_steps = k
    for a in s.acceleration_evals:
        for plan in a.sweep_plans():
            if slots is not None:
                plan.slots = slots
            if min_iterations is not None:
                plan.min_iterations = min_iterations
    if nan_at is not None:
        st = s.states['fluid']
        st['h'] = st['h'].clone()
        st['h'][nan_at] = float('nan')
    app.solve()
    return s


@pytest.mark.parametrize('scheme', ['mpm', 'gsph'])
def test_gas_chunks_equal_the_per_step_loop(scheme):
    extra = ('--adaptive-h', scheme)
    got, want = _solve(4, extra), _solve(1, extra)
    assert got.count == want.count == 13
    assert (got.t, got.dt, got.rebuilds) == (want.t, want.dt, want.rebuilds)
    assert got.replays == 0 and got.reads < want.count
    for p, v in want.states['fluid'].items():
        assert torch.equal(got.states['fluid'][p], v), (scheme, p)
    a, b = got.acceleration_evals[0], want.acceleration_evals[0]
    assert a.sweeps == b.sweeps
    assert torch.equal(a.rebuilds, b.rebuilds)
    if scheme == 'mpm':
        assert a.converged_reads < b.converged_reads
        assert len(a.sweeps) == 14 and a.sweeps[0] == 250
    else:
        assert not a.has_iterated and int(a.rebuilds) == 2 * 14


def test_a_chunk_short_of_slots_is_redone():
    """One slot and min_iterations 2: every chunk runs out of slots, is
    redone from the state before it with the slots doubled, to the
    per-step loop's bits."""
    got = _solve(4, slots=1, min_iterations=2)
    want = _solve(1, min_iterations=2)
    assert got.redos == 1
    assert got.acceleration_evals[0].sweep_plans()[0].slots == 2
    for p, v in want.states['fluid'].items():
        assert torch.equal(got.states['fluid'][p], v), p
    assert got.acceleration_evals[0].sweeps[-12:] == \
        want.acceleration_evals[0].sweeps[-12:]


@pytest.mark.parametrize('k,extra', [(4, ()), (1, ('--adaptive-timestep',))])
def test_a_nan_h_raises_at_the_solvers_read(k, extra):
    """A NaN h is never binned: the binning flags the grid, and the
    solver's read (a chunk's, a step's with the adaptive dt) raises."""
    with pytest.raises(FloatingPointError, match='not finite'):
        _solve(k, extra, nan_at=7)


def test_a_nan_h_in_a_later_chunk_raises_with_no_redo():
    """h made NaN after a first chunk (between two ``solve`` calls, the
    example's fixed dt, so no per-step read comes first): the next
    chunk's density iteration never converges and runs out of its slots,
    and its read raises before any redo with more slots."""
    s = _solve(4, steps=4)
    assert s.count == 4 and s.redos == 0
    slots = [p.slots for p in s.acceleration_evals[0].sweep_plans()]
    s.max_steps = 13
    st = s.states['fluid']
    st['h'] = st['h'].clone()
    st['h'][7] = float('nan')
    with pytest.raises(FloatingPointError, match='not finite'):
        s.solve()
    assert s.count == 4 and s.redos == 0
    assert [p.slots for p in s.acceleration_evals[0].sweep_plans()] == slots


@pytest.mark.parametrize('spread,dims', [(1e-3, None), (400.0, (4, 4, 1))])
def test_plain_binning_orders_a_crowded_state_stably(spread, dims):
    """Every particle in one cell, or the edge cells of a grid far too
    small (clamped): ``order`` is ``torch.sort(cid, stable=True)``'s."""
    rng = np.random.default_rng(3)
    n = 4000
    pa = get_particle_array_gasd(name='fluid', x=rng.uniform(0, spread, n),
                                 y=rng.uniform(0, spread, n), h=1.0, m=1.0)
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0)
    if dims is not None:
        grid._set_dims(dims)
    states = {'fluid': pa.to_device(Config(**CPU))}
    handle = grid.handle_for(None, states)
    assert bool(bc.bin_cells(grid, states, handle, force=True))
    cells = handle.lists['fluid']
    cid = cells.cell.long()
    counts = torch.bincount(cid, minlength=grid.ncells)
    assert int(counts.max()) >= (n if dims is None else n // 10)
    assert torch.equal(cells.order.long(),
                       torch.sort(cid, stable=True).indices)
    assert torch.equal(cells.end - cells.start, counts.to(torch.int32))
