"""dam_break_3d's pair group split by dest, and the pair kernel against
its stubs, on the card: the port of ``tools_dev/prof_phases.py``.

    python -m pysph_tpu_torch.tools_dev.prof_phases [dx]

Builds dam_break_3d at ``dx`` (default 0.02) on the kernel engine.
First it times one eval of each dest's share of group 1 (the pair group:
boundary, obstacle, fluid) on its own, as ``prof_phases.py:38-72`` does,
then one whole eval with the pair kernel stubbed (``pair_stub`` in
``all`` mode: the loads paid, no arithmetic), skipped (zeros, no launch)
and real.  Times, launches, bytes and bounds as in ``prof_dma``.
"""

import sys
from collections import OrderedDict

from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.tools_dev import common, prof_dma

#: (label, variant) as prof_phases.py:101-106
VARIANTS = (
    ('all (kernel stubbed, loads paid)', 'all'),
    ('all (no kernel at all)', 'skip'),
    ('all (real)', 'real'),
)


def dest_split(a_eval):
    """{dest: [equations]} of the evaluator's group 1, in order."""
    by_dest = OrderedDict()
    for eq in a_eval.groups[1].equations:
        by_dest.setdefault(eq.dest, []).append(eq)
    return by_dest


def with_groups(a_eval, groups, fn):
    """``fn()`` with the evaluator running only ``groups`` (planned anew),
    then the evaluator as it was."""
    saved = a_eval.groups, a_eval._plans, dict(a_eval.engine_choices)
    a_eval.groups = groups
    a_eval._plans = a_eval._plan()
    try:
        return fn()
    finally:
        a_eval.groups, a_eval._plans = saved[:2]
        a_eval.engine_choices.clear()
        a_eval.engine_choices.update(saved[2])


def time_split(app, reps=prof_dma.REPS):
    """Device time of one eval of each dest's share of group 1 (CUDA
    only); prints one line each."""
    s = app.solver
    a_eval = s.acceleration_evals[0]
    g1 = a_eval.groups[1]
    times = {}
    for dest, eqs in dest_split(a_eval).items():
        group = Group(equations=eqs, real=g1.real)
        times[dest] = with_groups(a_eval, [group], lambda: common.events_ms(
            lambda: a_eval.update_and_compute(0.0, s.dt, s.states), reps))
        print('%-34s %7.3f ms' % ('g1[%s]' % dest, times[dest]), flush=True)
    return times


def main(dx=0.02):
    print(common.require_cuda(), flush=True)
    app = prof_dma.setup(dx, 'cuda')
    split = time_split(app)
    return split, [prof_dma.time_variant(app, label, v)
                   for label, v in VARIANTS]


if __name__ == '__main__':
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 0.02)
