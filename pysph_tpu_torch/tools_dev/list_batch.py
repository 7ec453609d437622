"""The consuming ``delta_pair`` launch with 1, 2, 4 and 8 listed entries
in flight a lane (``csrc/delta_pair.cu``'s ``kListBatch``, 2 on the path;
each variant built with ``-DLIST_BATCH``), on one card.

    python3 -m pysph_tpu_torch.tools_dev.list_batch

On dam_break_3d ``--delta-sph`` at dx=0.02 in float32 after its 50
damped steps, each variant's consuming gradient must equal the walking
gradient bit for bit; then the consume launch alone (on a hand-off
emitted before), the linked pair (emit + consume) and the two walking
launches are replayed from CUDA graphs, all variants alternated over 7
rounds in one process, and one JSON line is printed for each variant
and graph: the median ms of 20 replays and the rounds' min and max,
tagged with the card's name and power limit.
"""

import json

import numpy as np
import torch

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.tools_dev import common, delta_check
from pysph_tpu_torch.tools_dev.time_walks import delta_calls

BATCHES = (1, 2, 4, 8)
#: delta_pair's own flags (no FMA contraction)
_FLAGS = build.EXTRA_FLAGS['delta_pair']


def _use(batch):
    """Let the next ``delta_pair`` launch build and load the variant
    with ``batch`` entries in flight."""
    build.EXTRA_FLAGS['delta_pair'] = _FLAGS + ('-DLIST_BATCH=%d' % batch,)
    build._loaded.pop('delta_pair', None)


def main(rounds=7, reps=20):
    smi = common.require_cuda()
    calls, _, _ = delta_calls(0.02, torch.float32, steps=50)
    ((_, _, _, margs), (_, _, _, gargs)), = delta_check.linked_calls(calls)
    graphs, held = {}, []
    try:
        for b in BATCHES:
            _use(b)
            _, handoff = dl.delta_pair(*margs, emit=True)
            walked = dl.delta_pair(*gargs)['gradrho']
            got = dl.delta_pair(*gargs, handoff=handoff)['gradrho']
            if not torch.equal(got, walked):
                raise AssertionError('LIST_BATCH=%d: the consuming gradient '
                                     'differs from the walk' % b)
            # the graphs hold this variant's kernels; keep its library
            held.append((build._loaded['delta_pair'], handoff))
            graphs[b, 'consume'] = common.capture(
                lambda h=handoff: dl.delta_pair(*gargs, handoff=h))
            graphs[b, 'linked'] = common.capture(lambda: dl.delta_pair(
                *gargs, handoff=dl.delta_pair(*margs, emit=True)[1]))
            graphs[b, 'walking'] = common.capture(
                lambda: (dl.delta_pair(*margs), dl.delta_pair(*gargs)))
    finally:
        build.EXTRA_FLAGS['delta_pair'] = _FLAGS
        build._loaded.pop('delta_pair', None)
    times = {k: [] for k in graphs}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(common.events_ms(graph.replay, reps))
    for (b, what), v in times.items():
        print(json.dumps(dict(card=smi, list_batch=b, graph=what,
                              ms=float(np.median(v)), min=min(v),
                              max=max(v))), flush=True)


if __name__ == '__main__':
    main()
