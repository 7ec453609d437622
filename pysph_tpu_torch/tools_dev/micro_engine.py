"""Gather probe of the compact engine's grid spec on the card: the port of
``tools_dev/micro_engine.py``.

    python -m pysph_tpu_torch.tools_dev.micro_engine [case]

Runs every case of ``CASES`` (the JAX tool's names), or the one named.
Each case makes the tool's maps from the same seeded numpy draws
(``ops/micro.py::engine_maps``), seeded normal source packs (the TPU tool
used ones, under which a wrong map goes unseen) and a dest pack, and
times K=10 launches of ``ops/micro.py::micro_engine`` with the feedback
``d += mean(out) * 1e-9`` into the dest pack, eagerly and captured in one
CUDA graph, and the K launches alone in a graph.  It prints per launch
the three times, per program, the unique bytes and the bound
(``tools_dev/roofline.py``).  The JAX tool's ``scratch`` and
``when_gate`` flags only change how the TPU writes the same function: a
case that sets them runs the same kernel, and says so.
"""

import sys

import numpy as np
import torch

from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.tools_dev import common, roofline

K = 10
#: name: (label, A_max, tz, Md, n_src, Ms, Pp, Pd, n_sblocks, flags), as
#: micro_engine.py:133-148
CASES = {
    'fluid-full': ('fluid-like full', 748, 8, 32, 3, 32, 12, 11, 748, {}),
    'fluid-static': ('fluid-like static maps', 748, 8, 32, 3, 32, 12, 11,
                     748, {'dyn_maps': False}),
    'fluid-noscratch': ('fluid-like no scratch', 748, 8, 32, 3, 32, 12, 11,
                        748, {'scratch': False}),
    'fluid-1src': ('fluid-like 1 src', 748, 8, 32, 1, 32, 12, 11, 748, {}),
    'fluid-3views': ('fluid-like 3 views', 748, 8, 32, 3, 32, 12, 11, 748,
                     {'n_views': 3}),
    'boundary-full': ('boundary-like full', 2519, 8, 32, 1, 32, 11, 9, 748,
                      {}),
    'obstacle-full': ('obstacle-like full', 283, 8, 32, 1, 32, 11, 9, 748,
                      {}),
}
#: flags of the TPU tool that change only how the TPU writes the function
TPU_ONLY_FLAGS = ('scratch', 'when_gate')


def make_case(name, device, seed=0):
    """(dest pack, arguments of ``micro_engine``, keyword arguments) of
    case ``name`` on ``device``."""
    _, a_max, tz, md, n_src, ms, pp, pd, n_sblocks, flags = CASES[name]
    rng = np.random.default_rng(seed)
    d_pack = torch.as_tensor(rng.normal(size=(a_max, 2 + pd, tz, md)),
                             dtype=torch.float32, device=device)
    src = torch.as_tensor(
        rng.normal(size=(n_src, n_sblocks + 1, pp, tz, 3 * ms)),
        dtype=torch.float32, device=device)
    maps = [torch.as_tensor(m, device=device)
            for m in micro.engine_maps(a_max, n_src, n_sblocks)]
    kw = dict(n_views=flags.get('n_views', 9),
              dyn_maps=flags.get('dyn_maps', True), md=md)
    return d_pack, (src, *maps), kw


def feedback_loop(d_pack, args, kw, k=K):
    """K launches, each output's mean fed back into the dest pack (which
    the function does not read, as on the TPU); returns the last output."""
    for _ in range(k):
        out = micro.micro_engine(*args, **kw)
        d_pack.add_(out.mean() * 1e-9)
    return out


def bench(name, reps=5):
    """Times of case ``name`` on the card (ms per launch), with its work
    and bound; prints one line."""
    label, a_max = CASES[name][:2]
    tpu_only = sorted(set(CASES[name][-1]) & set(TPU_ONLY_FLAGS))
    d_pack, args, kw = make_case(name, 'cuda')
    work = roofline.micro_engine_work(*args, **kw)
    bound_ms, bound_by = roofline.bound(work)
    eager = common.events_ms(lambda: feedback_loop(d_pack, args, kw),
                             reps) / K
    graph = common.graph_ms(lambda: feedback_loop(d_pack, args, kw),
                            reps) / K
    kernel = common.graph_ms(
        lambda: [micro.micro_engine(*args, **kw) for _ in range(K)],
        reps) / K
    print('%-26s eager %7.4f ms, graph %7.4f ms, host %7.4f ms/iter; '
          'kernel %7.4f ms (%6.2f ns/prog); %.4g B, bound %.4f ms (%s), '
          '%.1f%% of it%s' % (
              label, eager, graph, eager - graph, kernel,
              kernel / a_max * 1e6, work['bytes'], bound_ms, bound_by,
              100 * bound_ms / kernel,
              '; %s: TPU-only, the same kernel' % ', '.join(tpu_only)
              if tpu_only else ''), flush=True)
    return dict(name=name, eager_ms=eager, graph_ms=graph, kernel_ms=kernel,
                bound_ms=bound_ms, bound_by=bound_by, **work)


def main(argv):
    print(common.require_cuda(), flush=True)
    return [bench(name) for name in (argv or CASES)]


if __name__ == '__main__':
    main(sys.argv[1:])
