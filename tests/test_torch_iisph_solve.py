"""``iisph_solve`` (``ops/iisph_solve.py``), IISPH's iterated pressure
group in one call, on the CPU in float64 (its plain version; the kernel
is held to it on the card in ``tests/test_torch_iisph_cuda.py``).

- The loop condition against pysph_tpu's ``lax.while_loop`` cond
  (``pysph_tpu/ops/resident.py:1501``) at the edges: ``min_iterations``,
  ``max_iterations`` reached, converged at the first sweep allowed.
- The plain version against the evaluator's host loop (the per-launch
  chain on the CPU) on one evaluation of each of the three IISPH runs
  (``taylor_green``, ``elliptical_drop``, ``dam_break_2d --scheme
  iisph``), with the edge particles (30 sweeps) too: every output bit
  for bit, the same sweeps, no host read of ``converged`` counted; and
  at tolerances and sweep bounds that force each edge, against the host
  loop with the same bounds.
- The planner: IISPH's group of each run on ``iisph_solve``, with its
  constants; another iterated group, one on the torch engine and a
  kernel the library lacks refused and logged.
- The chunks: each run in chunks equal to the same run per step, bit for
  bit, with the same sweeps; a step masked in a chunk logs no sweep.
- The sweep log's ring and the wrapper's refusals.

The JAX package's iterated group is held to the port's (whose one
evaluation now runs through ``iisph_solve``) in
``tests/test_torch_iisph.py``.
"""

import logging

import jax.numpy as jnp
import pytest
import torch

from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops import iisph_solve as isv
from pysph_tpu_torch.ops import sweeps
from pysph_tpu_torch.ops.pair_engine import SolvePlan
from pysph_tpu_torch.sph import iisph
from pysph_tpu_torch.tools_dev import iisph_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

#: the three runs at a small size
RUNS = {'taylor_green': 16, 'elliptical_drop': 20, 'dam_break_2d': 0.1}
F64 = torch.float64


def _app(run, steps=0, extra=()):
    return iisph_check.app(run, RUNS[run], F64, steps=steps, device='cpu',
                           extra=extra)


# -- the loop condition ------------------------------------------------------
#: (min_iterations, max_iterations): IISPHScheme's, and the edges
BOUNDS = [(2, 30), (0, 3), (0, 0), (3, 3), (5, 2), (1, 1)]


def _jax_cond(it, conv, min_it, max_it):
    # pysph_tpu/ops/resident.py:1501-1503
    it, conv = jnp.asarray(it, jnp.int32), jnp.asarray(conv)
    return bool((it < max_it) & ~(conv & (it >= min_it)))


@pytest.mark.parametrize('min_it,max_it', BOUNDS)
def test_loop_condition_is_the_jax_cond(min_it, max_it):
    for it in range(0, 33):
        for conv in (False, True):
            assert isv.keep_sweeping(it, conv, min_it, max_it) == \
                _jax_cond(it, conv, min_it, max_it), (it, conv)


# -- the plain version against the host loop ---------------------------------
def _eval(run, solve, edges=False, bounds=None, tolerance=None):
    """One evaluation of ``run`` from its jittered state (``edges``: a
    tenth of the fluid on its box's edges) through the solve
    (``solve``) or the host loop; ``bounds`` and ``tolerance`` change the
    pressure group's.  Returns (fluid state, sweeps, converged reads,
    the recorded calls)."""
    s = _app(run).solver
    iisph_check.jitter(s)
    if edges:
        iisph_check.on_edges(s)
    a_eval = s.acceleration_evals[0]
    group, = [g for g in a_eval.groups if g.iterate]
    if bounds is not None:
        group.min_iterations, group.max_iterations = bounds
    if tolerance is not None:
        for g in group.equations:
            for eq in g.equations:
                if isinstance(eq, iisph.PressureSolve):
                    eq.tolerance = tolerance
    a_eval._plans = a_eval._plan()
    found = iisph_check.record(a_eval)
    a_eval.solve_iterated = solve
    try:
        a_eval.update_and_compute(0.0, s.dt, s.states)
    finally:
        iisph_check.forget(a_eval)
    return dict(s.states['fluid']), a_eval.sweeps[-1], \
        a_eval.converged_reads, found


def _same(a, b):
    return [p for p, v in a.items() if not torch.equal(v, b[p])]


@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('run', list(RUNS))
def test_solve_is_the_host_loop_bit_for_bit(run, edges):
    got, k, reads, calls = _eval(run, True, edges)
    want, kw, reads_w, chain = _eval(run, False, edges)
    # the host loop reads converged after each sweep that can stop it
    assert k == kw and reads == 0
    assert reads_w == sum(2 <= it < 30 for it in range(1, kw + 1))
    assert not _same(got, want)
    solves = iisph_check.solve_calls(calls)
    assert len(solves) == 1 and isinstance(solves[0][2], SolvePlan)
    fixed = 6 if run == 'dam_break_2d' else 4
    assert len(iisph_check.pair_calls(calls)) == fixed
    assert len(chain) == fixed + 2 * kw and not iisph_check.solve_calls(
        chain)
    if edges and run == 'taylor_green':
        assert k == 30


#: (min, max, tolerance, sweeps): max reached, min reached, converged
#: at the first sweep allowed, no sweep
FORCED = [(2, 30, -1.0, 30), (2, 5, -1.0, 5), (2, 30, 1e3, 2),
          (0, 30, 1e3, 1), (3, 30, 1e3, 3), (0, 0, 1e3, 0)]


@pytest.mark.parametrize('min_it,max_it,tol,sweeps', FORCED)
def test_forced_bounds_against_the_host_loop(min_it, max_it, tol, sweeps):
    run = 'dam_break_2d'
    got, k, _, calls = _eval(run, True, bounds=(min_it, max_it),
                             tolerance=tol)
    want, kw, _, _ = _eval(run, False, bounds=(min_it, max_it),
                           tolerance=tol)
    assert k == kw == sweeps
    assert not _same(got, want)
    (_, _, plan, args), = iisph_check.solve_calls(calls)
    assert plan.spec[1:] == (1000.0, 0.5, tol, min_it, max_it)
    # the plain version on the recorded call: the same outputs
    out, n = isv.iisph_solve_reference(*args)
    assert int(n) == sweeps
    assert all(torch.equal(out[p], got[p]) for p in isv.OUTPUTS)
    if sweeps == 0:
        assert all(torch.equal(out[p], args[0][p]) for p in isv.OUTPUTS)


# -- the planner -------------------------------------------------------------
@pytest.mark.parametrize('run', list(RUNS))
def test_the_planner_takes_iisph_s_group(run):
    a_eval, = _app(run).solver.acceleration_evals
    plan, = a_eval._solves.values()
    assert plan.dest == 'fluid' and plan.dijpj.op is ip.iisph_pair
    assert plan.solve.link is plan.dijpj.link is not None
    assert plan.spec == isv.SolveSpec('fluid', plan.spec.rho0, 0.5, 1e-2, 2,
                                      30)
    assert not a_eval.host_iterated and a_eval.has_iterated
    a_eval.solve_iterated = False
    assert a_eval.host_iterated


def test_the_planner_refuses_other_groups(caplog):
    from test_torch_iisph import _lattice, _tree
    from pysph_tpu_torch.base.kernels import CubicSpline
    from pysph_tpu_torch.base.utils import get_particle_array
    from pysph_tpu_torch.config import Config
    from pysph_tpu_torch.sph.equation import Equation, Group
    from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
    logger = 'pysph_tpu_torch.sph.acceleration_eval'
    with caplog.at_level(logging.INFO, logger=logger):
        ev = SPHEvaluator([_lattice(get_particle_array)],
                          _tree(Equation, Group, torch, 1.0, 2, 30), dim=2,
                          kernel=CubicSpline(dim=2),
                          config=Config(device='cpu', dtype=F64))
    assert not ev.func_eval._solves and ev.func_eval.host_iterated
    assert 'host loop for the iterated group' in caplog.text
    assert 'not ComputeDIJPJ' in caplog.text
    # IISPH's group on the torch engine, and with a kernel the library
    # lacks (CubicSpline)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        a_eval, = iisph_check.app('taylor_green', 16, F64, engine='torch',
                                  device='cpu').solver.acceleration_evals
    assert not a_eval._solves and 'read no emitting iisph_pair' in \
        caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        sch = iisph.IISPHScheme(['fluid'], [], dim=2, rho0=1000.0)
        arr = _lattice(get_particle_array)
        sch.setup_properties([arr], clean=False)
        ev = SPHEvaluator([arr], sch.get_equations(), dim=2,
                          kernel=CubicSpline(dim=2),
                          config=Config(device='cpu', dtype=F64))
    assert not ev.func_eval._solves and 'iisph_solve holds kinds' in \
        caplog.text


# -- the chunks --------------------------------------------------------------
@pytest.mark.parametrize('run', list(RUNS))
def test_chunks_equal_steps_bit_for_bit(run):
    out = []
    for k in (10, 1):
        s = _app(run, steps=13).solver
        s.chunk_steps = k
        s.n_damp = 0
        iisph_check.jitter(s)
        s.solve()
        out.append((s.states, list(s.acceleration_evals[0].sweeps), s.count,
                    s.t, s.dt))
    (got, sweeps, count, t, dt), (want, *rest) = out
    assert (sweeps, count, t, dt) == tuple(rest) and count == 13
    assert len(sweeps) == 14
    for name, st in want.items():
        assert not _same(got[name], st), name


def test_a_masked_step_logs_no_sweeps(caplog):
    s = _app('taylor_green', steps=3).solver
    with caplog.at_level(logging.INFO,
                         logger='pysph_tpu_torch.solver.solver'):
        s.solve()
    # one chunk of 10 iterations, 3 of them active: its read and the
    # first dt's grow check
    assert s.count == 3 and s.reads == 2
    assert 'per-step loop' not in caplog.text
    assert s.acceleration_evals[0].sweeps == [2] * 4


# -- the log and the wrapper -------------------------------------------------
def test_sweep_log_is_a_ring(caplog):
    log = sweeps.SweepLog('cpu', entries=3)
    assert log.drain() == []
    for k in (4, 5, 6, 7, 8):
        n = int(log.buf[0])
        log.buf[1 + n % 3] = k
        log.buf[0] = n + 1
    with caplog.at_level(logging.WARNING, logger=sweeps.logger.name):
        assert log.drain() == [6, 7, 8]
    assert '2 of 5 counts overwritten' in caplog.text
    assert log.drain() == []


def test_the_wrapper_refuses_other_sources():
    _, _, _, calls = _eval('dam_break_2d', True)
    (_, _, _, args), = iisph_check.solve_calls(calls)
    dijpj, solve = args[3], args[4]
    with pytest.raises(ValueError, match='ComputeDIJPJ over'):
        isv.iisph_solve(*args[:3], solve, solve, *args[5:])
    with pytest.raises(ValueError, match='PressureSolve terms'):
        isv.iisph_solve(*args[:3], dijpj, dijpj, *args[5:])
    # a masked call: no sweep, the outputs as they were
    out, n = isv.iisph_solve(*args[:10], torch.tensor(False))
    assert int(n) == 0 and all(torch.equal(out[p], args[0][p])
                               for p in isv.OUTPUTS)
