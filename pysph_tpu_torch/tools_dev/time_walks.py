"""The pair kernels timed on their paths' calls, on the card.

    python3 pysph_tpu_torch/tools_dev/time_walks.py [label]

Builds the pair calls of one eval of dam_break_3d at dx=0.02 and of the
elliptical drop at nx=200, and of both evals of the GTVF dam break at
dx=0.004 and of one eval of the Taylor-Green vortex at nx=400 (float32,
seeded velocity and density perturbations, as ``chip_smoke.py`` times
them), and times ``wcsph_pair`` and ``dense_pair`` on the first two,
``gtvf_pair`` on the third, ``tvf_pair`` on the fourth (walking, and as
the path runs it: ``as path graph``, linked where the checkout links)
and ``fused_continuity_momentum`` on the drop's state: CUDA events around
eager calls and around replays of a CUDA graph of the calls, and the
host's time a call (the source pack alone too, where the checkout has
its entry).  Then it runs each path for ``STEPS`` steps from rest (the
drop under ``--engine kernel`` and ``--engine dense``) and takes the
median ms/step after ``WARMUP`` steps (host clock, the card
synchronised between steps by a pre-step callback, which keeps the
solver on its per-step loop; ``time_chunks.py`` times its chunks).  Prints one JSON line per path, tagged
with ``label`` and the card's name and power limit.

The script uses only the port's entry points (the examples, the
wrappers, ``CellGrid``, ``tools_dev/common.py``, ``tools_dev/roofline.py``
and ``tools_dev/tvf_check.py``), so it also times an older checkout of the
port: run it by path with
``PYTHONPATH`` set to that checkout, and alternate the two in one call
(older, newer, newer, older) to compare them on one card.
``chip_smoke.py`` builds its calls with the functions here.
"""

import json
import sys
import time

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import common, roofline

REPS = 20
STEPS = 200
WARMUP = 20


def make_app(dx, dtype, steps=0, engine='kernel', cls=DamBreak3D,
             extra=()):
    """An example's application set up on the card."""
    app = cls()
    argv = ['--disable-output', '-q', '--device', 'cuda', '--engine',
            engine, *extra]
    if dx is not None:
        argv += ['--dx', str(dx)]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    app.setup(argv)
    return app


def perturb(states, dtype, props, seed=12345):
    """Seeded normal values for ``props`` and a 1% density perturbation
    around 1000."""
    rng = np.random.default_rng(seed)
    for st in states.values():
        n = st['x'].shape[0]
        for p in props:
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n), dtype=dtype,
                                    device='cuda')
        st['rho'] = torch.as_tensor(1000.0 * (1.0 + 0.01 * rng.normal(
            size=n)), dtype=dtype, device='cuda')


def plan_calls(s, evals):
    """[(eval index, dest, plan, kernel arguments)] for every planned
    pair phase of the solver's evaluators ``evals``, on its states binned
    afresh on the cells that the group's binning has now (the grid's;
    where binnings keep periodic counts of their own, those of the
    binning whose lists the group read in the last evaluation:
    ``AccelerationEval.last_reads``)."""
    calls = []
    for k in evals:
        a_eval = s.acceleration_evals[k]
        binned = {}
        for group in a_eval.leaf_groups():
            b = a_eval.last_reads.get(id(group))
            grid = a_eval.grid if b is None else b.cells(a_eval.grid)
            if grid not in binned:
                binned[grid] = grid.bin_all(s.states)
            for dest in a_eval._dest_order(group):
                plan = a_eval._plans.get((id(group), dest))
                if plan is None:
                    continue
                store = s.states[dest]
                pre = {p: torch.zeros_like(store[p]) for p in plan.outputs}
                calls.append((k, dest, plan, plan.args(
                    store, s.states, binned[grid], grid,
                    group.write_mask(store), pre, s.dt, s.t)))
    return calls


def run_as_path(calls):
    """The results of ``calls`` (``plan_calls``') as the evaluator runs
    their plans: a linked pair through its link (the emitting call,
    then the consuming call), in order."""
    return [c[2].op(*c[3]) if c[2].link is None
            else c[2].link.run(c[2], c[3]) for c in calls]


def _slack(s, cell_slack):
    if cell_slack is not None:
        s.grid.resize(s.states.values(), cell_slack=cell_slack)


def pair_calls(dx, dtype, cell_slack=None, cls=DamBreak3D, extra=()):
    """(calls, particle count) for one eval of the perturbed dam break
    at ``dx`` (on cells ``cell_slack`` times the support where given);
    ``cls``: ``DamBreak2D`` for the 2D WCSPH dam break (``--scheme
    wcsph``: WendlandQuintic, the Hughes-Graham walls), its velocities
    perturbed in the plane; ``extra``: the example's further arguments
    (``--kernel ...``)."""
    s = make_app(dx, dtype, cls=cls, extra=extra).solver
    _slack(s, cell_slack)
    perturb(s.states, dtype, 'uvw'[:s.dim])
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, [0]), n


def delta_calls(dx, dtype, steps=0, extra=()):
    """(calls, particle count, app) of one eval of dam_break_3d
    ``--delta-sph`` (and the further arguments ``extra``) at ``dx``: with
    ``steps``, on the state the path reaches after that many steps from
    rest; without, after the first eval of a state with seeded velocity
    and density perturbations."""
    app = make_app(dx, dtype, steps=steps,
                   extra=('--delta-sph',) + tuple(extra))
    s = app.solver
    if steps:
        app.solve()
    else:
        perturb(s.states, dtype, 'uvw')
        s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, [0]), n, app


def drop_calls(nx, dtype, cell_slack=None):
    """(calls, particle count, app) for one eval of the elliptical drop
    at ``nx`` with a seeded velocity and density perturbation (on cells
    ``cell_slack`` times the support where given)."""
    app = make_app(None, dtype, cls=EllipticalDrop, extra=('--nx', str(nx)))
    s = app.solver
    _slack(s, cell_slack)
    st = s.states['fluid']
    rng = np.random.default_rng(2024)
    n = st['x'].shape[0]
    for p in ('u', 'v'):
        st[p] = st[p] + torch.as_tensor(rng.normal(0.0, 10.0, n),
                                        dtype=dtype, device='cuda')
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n),
                                dtype=dtype, device='cuda')
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    return plan_calls(s, [0]), n, app


def gtvf_calls(dx, dtype):
    """(calls, particle count) for both evals of the perturbed GTVF dam
    break at ``dx``, after one pass of each eval has set the derived
    properties (wall ghost velocities, rho0, p0, ...)."""
    app = make_app(dx, dtype, cls=DamBreak2D, extra=('--scheme', 'gtvf'))
    s = app.solver
    perturb(s.states, dtype, ('u', 'v', 'uhat', 'vhat'))
    for a_eval in s.acceleration_evals:
        a_eval.update_and_compute(0.0, s.dt, s.states)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, range(len(s.acceleration_evals))), n


def fused_call(nx, dtype):
    """(state, cells, grid, keyword arguments, app) of one
    ``fused_continuity_momentum`` call (CubicSpline, cells 2 hmax wide)
    on the perturbed drop at ``nx`` after its first eval."""
    _, _, app = drop_calls(nx, dtype)
    st = app.solver.states['fluid']
    grid = CellGrid.from_particles(app.particles, dim=2, radius_scale=2.0)
    cells = grid.bin_all({'fluid': st})['fluid']
    return st, cells, grid, dict(dim=2, c0=app.co, alpha=app.alpha,
                                 beta=0.0), app


def step_ms(app):
    """Median ms/step of ``app``'s run after ``WARMUP`` steps."""
    stamps = []

    def pre_step(solver):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    app.solver.add_pre_step_callback(pre_step)
    app.solve()
    torch.cuda.synchronize()
    return float(np.median(np.diff(stamps)[WARMUP:])) * 1e3


def host_us(fn, n_calls, reps=REPS):
    """Median host microseconds a call of the ``n_calls`` calls that
    ``fn`` makes takes to return, the card idle before each rep: the
    wrapper's own cost, which sets an eager call's time once the
    kernel's is shorter."""
    fn()
    per = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        per.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return float(np.median(per)) * 1e6 / n_calls


def time_ops(calls, ops, reps=REPS):
    """{name: ms} of one eval's calls through each op of ``ops`` ({name:
    op}): eagerly, as ``<name> graph`` replayed from a CUDA graph, the
    host's microseconds a call as ``<name> host_us``, and where there
    are several calls, each alone in a graph as ``<name> graph per
    call``."""
    times = {}
    for name, op in ops.items():
        times[name] = common.events_ms(
            lambda: [op(*c[3]) for c in calls], reps)
        times[name + ' graph'] = common.graph_ms(
            lambda: [op(*c[3]) for c in calls], reps)
        times[name + ' host_us'] = host_us(
            lambda: [op(*c[3]) for c in calls], len(calls), reps)
        if len(calls) > 1:
            times[name + ' graph per call'] = [
                common.graph_ms(lambda: op(*c[3]), reps) for c in calls]
    return times


def main(label=''):
    smi = common.require_cuda()
    rows = []

    def report(path, calls, ops, work, extra=()):
        row = dict(label=label, card=smi, path=path, launches=len(calls),
                   **time_ops(calls, ops), **dict(extra))
        row.update(work=work, bound_ms=roofline.bound(work)[0])
        print(json.dumps(row), flush=True)
        rows.append(row)

    # the packs' entries are not in older checkouts
    wpack = getattr(wp, 'pack_sources', None)
    gpack = getattr(gp, 'pack_sources', None)
    fpack = getattr(fp, 'pack', None)
    ops = {'wcsph_pair': wp.wcsph_pair, 'dense_pair': dp.dense_pair}
    if wpack is not None:
        ops['pack_sources'] = lambda *args: wpack(args[4])
    for path, build in (('dam_break_3d dx=0.02',
                         lambda: pair_calls(0.02, torch.float32)[0]),
                        ('drop nx=200',
                         lambda: drop_calls(200, torch.float32)[0])):
        calls = build()
        report(path, calls, ops, roofline.add(
            *[roofline.wcsph_work(*c[3]) for c in calls]))
        del calls
    calls = gtvf_calls(0.004, torch.float32)[0]
    ops = {'gtvf_pair': gp.gtvf_pair}
    if gpack is not None:
        ops['pack_sources'] = lambda *args: gpack(args[4])
    report('GTVF dx=0.004', calls, ops,
           roofline.add(*[roofline.gtvf_work(*c[3]) for c in calls]))
    del calls
    # tvf_check builds its calls with this module's functions
    from pysph_tpu_torch.tools_dev import tvf_check
    calls = tvf_check.calls(400, torch.float32)[0]
    report('Taylor-Green nx=400', calls, {'tvf_pair': tp.tvf_pair},
           roofline.add(*[roofline.tvf_work(*c[3]) for c in calls]),
           {'as path graph': common.graph_ms(lambda: run_as_path(calls),
                                             REPS)})
    del calls
    st, cells, grid, kw, app = fused_call(200, torch.float32)
    ops = {'fused_pair': lambda *args: fp.fused_continuity_momentum(
        *args, **kw)}
    if fpack is not None:
        ops['pack'] = lambda st, cells, grid: fpack(st, cells)
    report('drop nx=200 fused', [(0, 'fluid', None, (st, cells, grid))],
           ops, roofline.fused_work(st, cells, grid))
    del st, cells, app
    for path, setup in (('dam_break_3d dx=0.02', dict(dx=0.02)),
                        ('GTVF dx=0.004', dict(
                            dx=0.004, cls=DamBreak2D,
                            extra=('--scheme', 'gtvf'))),
                        ('drop nx=200 kernel', dict(
                            dx=None, cls=EllipticalDrop,
                            extra=('--nx', '200'))),
                        ('drop nx=200 dense', dict(
                            dx=None, cls=EllipticalDrop,
                            extra=('--nx', '200'), engine='dense'))):
        app = make_app(dtype=torch.float32, steps=STEPS, **setup)
        row = dict(label=label, card=smi, path=path, steps=STEPS,
                   ms_per_step=step_ms(app))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del app
    return rows


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '')
