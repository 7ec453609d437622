"""Variants of a linked pair's kernel on one card: the listed entries a
consuming lane has in flight (``-DLIST_BATCH``) and, for ``tvf_pair``,
the blocks an SM its launches ask for (``-DEMIT_BLOCKS``,
``-DCONSUME_BLOCKS``).

    python3 -m pysph_tpu_torch.tools_dev.list_batch [delta_pair|tvf_pair]

``delta_pair`` (the default): dam_break_3d ``--delta-sph`` at dx=0.02 in
float32 after its 50 damped steps, 1, 2, 4 and 8 entries in flight.
``tvf_pair``: the Taylor-Green vortex at nx=400 in float32
(``tvf_check.calls``), the variants of ``VARIANTS`` (the walking
momentum launch's blocks, ``-DMOMENTUM_BLOCKS``, too).  The variants are
built in parallel.  Each variant's consuming call must equal the
walking call bit for bit; then the consume launch alone (on a hand-off
emitted before), the emit launch alone, the linked pair (emit +
consume) and the two walking launches are replayed from CUDA graphs,
all variants alternated over 7 rounds in one process, and one JSON line
is printed for each variant and graph: the median ms of 20 replays and
the rounds' min and max, tagged with the card's name and power limit;
for ``tvf_pair`` also a line of each variant's registers and spills by
mode (``tvf_check.resources``).
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev import common, tvf_check
from pysph_tpu_torch.tools_dev.time_walks import delta_calls


def _tvf(batch, consume, emit=8, momentum=6):
    return ('-DLIST_BATCH=%d' % batch, '-DCONSUME_BLOCKS=%d' % consume,
            '-DEMIT_BLOCKS=%d' % emit, '-DMOMENTUM_BLOCKS=%d' % momentum)


#: the variants' flags by kernel (tvf_pair's built with 4, 5, 8, 6 by
#: default)
VARIANTS = {
    'delta_pair': [('-DLIST_BATCH=%d' % b,) for b in (1, 2, 4, 8)],
    'tvf_pair': [_tvf(b, c) for c in (4, 5, 6) for b in (1, 2, 4)] +
                [_tvf(4, c) for c in (3, 7, 8)] +
                [_tvf(4, 5, emit=e) for e in (4, 6)] +
                [_tvf(4, 5, momentum=m) for m in (4, 5)],
}


def _calls(name):
    if name == 'delta_pair':
        return delta_calls(0.02, torch.float32, steps=50)[0], dl.delta_pair
    return tvf_check.calls(400, torch.float32)[0], tp.tvf_pair


def _use(name, own, extra):
    """Let the next launch of ``name`` load the variant built with
    ``extra``."""
    build.EXTRA_FLAGS[name] = own + tuple(extra)
    # the default library's key (ops/build.py::load_library)
    build._loaded.pop((name,), None)


def main(name='delta_pair', rounds=7, reps=20):
    smi = common.require_cuda()
    variants = VARIANTS[name]
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(lambda v: build.build(name, v), variants))
    if name == 'tvf_pair':
        for v, lib in zip(variants, libs):
            print(json.dumps(dict(card=smi, kernel=name, flags=v,
                                  resources=tvf_check.resources(lib))),
                  flush=True)
    calls, op = _calls(name)
    ((_, _, _, first), (_, _, _, second)), = common.linked_calls(calls)
    own = build.EXTRA_FLAGS.get(name, ())
    graphs, held = {}, []
    try:
        for v in variants:
            _use(name, own, v)
            _, handoff = op(*first, emit=True)
            walked = op(*second)
            got = op(*second, handoff=handoff)
            if any(not torch.equal(got[p], walked[p]) for p in walked):
                raise AssertionError('%s %s: the consuming call differs '
                                     'from the walk' % (name, v))
            # the graphs hold this variant's kernels; keep its library
            held.append((build._loaded[(name,)], handoff))
            graphs[v, 'consume'] = common.capture(
                lambda h=handoff: op(*second, handoff=h))
            graphs[v, 'emit'] = common.capture(
                lambda: op(*first, emit=True))
            graphs[v, 'linked'] = common.capture(lambda: op(
                *second, handoff=op(*first, emit=True)[1]))
            graphs[v, 'walking'] = common.capture(
                lambda: (op(*first), op(*second)))
    finally:
        build.EXTRA_FLAGS.pop(name, None)
        if own:
            build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    times = {k: [] for k in graphs}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(common.events_ms(graph.replay, reps))
    for (v, what), t in times.items():
        print(json.dumps(dict(card=smi, kernel=name, flags=v, graph=what,
                              ms=float(np.median(t)), min=min(t),
                              max=max(t))), flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:2])
