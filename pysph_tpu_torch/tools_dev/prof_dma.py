"""Data movement against arithmetic in dam_break_3d's pair phases, on the
card: the port of ``tools_dev/prof_dma.py``.

    python -m pysph_tpu_torch.tools_dev.prof_dma [dx]

Builds dam_break_3d at ``dx`` (default 0.02) on the kernel engine and
swaps every ``PairPlan.op`` of its evaluator, as the JAX tool swaps
``pl.pallas_call``, for each variant of ``VARIANTS``: the real kernel
(``wcsph_pair``), ``ops/pair_stub.py::pair_stub`` in each mode (the
walk's loads, or some of them, and zeros written), and "skip" (the plain
version of the stub: zeros, no launch).  For each it prints the device
time of one whole eval (CUDA events around ``compute``: eagerly, where
the host's dispatch of every op shows, and replayed from a CUDA graph),
of the eval's pair calls alone (eagerly and from a graph), their
launches, unique bytes and bound (``tools_dev/roofline.py``); and first
the device operations of one real eval and their busy time
(``torch.profiler``).
"""

import functools
import sys

import torch

from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import pair_stub as ps
from pysph_tpu_torch.tools_dev import common, roofline

#: (label, stub mode or 'real' or 'skip'): the JAX tool's variants
#: (prof_dma.py:120-129) and the skip of prof_phases.py:93-99
VARIANTS = (
    ('stub (all inputs)', 'all'),
    ('stub (views dropped)', 'dest'),
    ('stub (6 of 9 views dropped)', 'third'),
    ('stub (dest+views dropped)', 'none'),
    ('skip (no launch)', 'skip'),
    ('real', 'real'),
)
REPS = 10


def setup(dx, device):
    """The dam_break_3d application at ``dx`` on ``device``, float32, on
    the kernel engine."""
    app = DamBreak3D()
    app.setup(['--dx', str(dx), '--disable-output', '-q', '--device',
               device, '--max-steps', '0'])
    return app


def op_of(variant, real):
    """The pair op standing for ``variant``; ``real`` is the plan's."""
    if variant == 'real':
        return real
    if variant == 'skip':
        return ps.pair_stub_reference
    return functools.partial(ps.pair_stub, mode=variant)


def swap_ops(a_eval, variant):
    """Point every plan of ``a_eval`` at ``variant``; returns the
    original ops, for ``restore_ops``."""
    saved = {}
    for key, plan in a_eval._plans.items():
        if plan is not None:
            saved[key] = plan.op
            plan.op = op_of(variant, plan.op)
    return saved


def restore_ops(a_eval, saved):
    for key, op in saved.items():
        a_eval._plans[key].op = op


def pair_calls(a_eval, states):
    """[(plan, kernel arguments)] of every planned pair phase of one eval
    on ``states``, binned as ``compute`` bins them."""
    cells = a_eval.grid.bin_all({n: states[n] for n in a_eval.arrays_used})
    calls = []
    for group in a_eval.groups:
        for dest in a_eval._dest_order(group):
            plan = a_eval._plans.get((id(group), dest))
            if plan is None:
                continue
            store = states[dest]
            pre = {p: store[p] for p in plan.outputs}
            srcs = [(states[s.name], cells[s.name], s) for s in plan.sources]
            calls.append((plan, (store, cells[dest], group.write_mask(store),
                                 pre, srcs, a_eval.grid, a_eval.kernel)))
    return calls


def work_of(variant, calls):
    """The work of one eval's pair calls under ``variant``."""
    works = [dict(candidates=0, pairs=0, flops=0, bytes=0)]
    for _, args in calls:
        if variant == 'real':
            works.append(roofline.wcsph_work(*args))
        elif variant != 'skip':
            works.append(roofline.stub_work(variant, *args))
    return roofline.add(*works)


def run_variant(app, variant):
    """One eval of ``app`` with ``variant`` in place of the pair kernel;
    returns the evaluator's states.  Runs on any device."""
    s = app.solver
    a_eval = s.acceleration_evals[0]
    saved = swap_ops(a_eval, variant)
    try:
        a_eval.update_and_compute(0.0, s.dt, s.states)
    finally:
        restore_ops(a_eval, saved)
    return s.states


def time_variant(app, label, variant, reps=REPS):
    """Device times of one eval and of its pair calls under ``variant``
    (CUDA only); prints one line."""
    s = app.solver
    a_eval = s.acceleration_evals[0]
    calls = pair_calls(a_eval, s.states)
    saved = swap_ops(a_eval, variant)
    try:
        eval_ms = common.events_ms(
            lambda: a_eval.update_and_compute(0.0, s.dt, s.states), reps)
        eval_graph_ms = common.graph_ms(
            lambda: a_eval.update_and_compute(0.0, s.dt, s.states), reps)
        ops = [(plan.op, args) for plan, args in calls]
        pair_ms = common.events_ms(lambda: [op(*a) for op, a in ops], reps)
        graph_ms = 0.0
        if variant != 'skip':
            graph_ms = common.graph_ms(lambda: [op(*a) for op, a in ops],
                                       reps)
    finally:
        restore_ops(a_eval, saved)
    work = work_of(variant, calls)
    bound_ms, bound_by = roofline.bound(work)
    launches = 0 if variant == 'skip' else len(calls)
    print('%-34s eval %7.3f ms eager, %7.3f in a graph; pair calls eager '
          '%7.3f ms, graph %7.3f ms (%d launches); %.4g candidates, %.4g B, '
          'bound %.4f ms (%s)' % (
              label, eval_ms, eval_graph_ms, pair_ms, graph_ms, launches,
              work['candidates'], work['bytes'], bound_ms, bound_by),
          flush=True)
    return dict(label=label, variant=variant, eval_ms=eval_ms,
                eval_graph_ms=eval_graph_ms, pair_eager_ms=pair_ms,
                pair_graph_ms=graph_ms,
                launches=launches, bound_ms=bound_ms, bound_by=bound_by,
                **work)


def device_ops(fn):
    """(device operations, their summed device ms) of one call of
    ``fn``, from ``torch.profiler`` with CUDA activity only."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type.name == 'CUDA']
    return len(ops), sum(e.device_time for e in ops) / 1e3


def main(dx=0.02):
    print(common.require_cuda(), flush=True)
    app = setup(dx, 'cuda')
    s = app.solver
    a_eval = s.acceleration_evals[0]
    n_ops, busy = device_ops(lambda: a_eval.update_and_compute(
        0.0, s.dt, s.states))
    print('one real eval: %d device operations, %.3f ms busy' % (n_ops, busy),
          flush=True)
    return [time_variant(app, label, v) for label, v in VARIANTS]


if __name__ == '__main__':
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 0.02)
