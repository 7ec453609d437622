"""Launch and per-view gather probe on the card: the port of
``tools_dev/micro_launch.py``.

    python -m pysph_tpu_torch.tools_dev.micro_launch

Each case runs K=10 launches of ``ops/micro.py::micro_launch`` with the
output fed back (``src += mean(out) * 1e-9``, so that no launch can be
skipped), eagerly and captured in one CUDA graph (the counterpart of the
JAX tool's ``jit(lax.scan)``), and the K launches alone in a graph.  It
prints per launch: the eager and graph times (their difference is the
host's cost of one iteration's four launches), the kernel's time, per
program and per view, the unique bytes and the bound
(``tools_dev/roofline.py``).  The inputs are seeded normal floats; the
TPU tool's were ones.
"""

import numpy as np
import torch

from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.tools_dev import common, roofline

K = 10
#: (label, n_programs, n_views, tz, lanes, planes), as the JAX tool's
#: ``__main__`` (micro_launch.py:80-89); n_blocks is 512
CASES = (
    ('512 progs, 1 tiny view', 512, 1, 8, 128, 1),
    ('3550 progs, 1 tiny view', 3550, 1, 8, 128, 1),
    ('748p 9v (ff-like)', 748, 9, 8, 384, 12),
    ('748p 27v (fluid dest phase)', 748, 27, 8, 384, 12),
    ('748p 3v wide (same bytes)', 748, 3, 8, 1152, 12),
    ('748p 1v very wide', 748, 1, 8, 3456, 12),
    ('2519p 9v (boundary dest)', 2519, 9, 8, 384, 11),
    ('2519p 9v tz=24 (3x bytes)', 2519, 9, 24, 384, 11),
    ('840p 9v tz=24 (same bytes)', 840, 9, 24, 384, 11),
)
N_BLOCKS = 512


def make_src(tz, lanes, planes, device, n_blocks=N_BLOCKS, seed=0):
    """Seeded ``(n_blocks, planes, tz, lanes)`` float32 source."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(n_blocks, planes, tz, lanes)),
                           dtype=torch.float32, device=device)


def feedback_loop(src, n_programs, n_views, k=K):
    """K launches, each output fed back into ``src`` in place; returns
    the last output."""
    for _ in range(k):
        out = micro.micro_launch(src, n_programs, n_views)
        src.add_(out.mean() * 1e-9)
    return out


def bench(label, n_programs, n_views, tz, lanes, planes, reps=5):
    """Times of one case on the card (ms per launch), with its work and
    bound; prints one line."""
    src = make_src(tz, lanes, planes, 'cuda')
    work = roofline.micro_launch_work(src, n_programs, n_views)
    bound_ms, bound_by = roofline.bound(work)
    eager = common.events_ms(
        lambda: feedback_loop(src, n_programs, n_views), reps) / K
    graph = common.graph_ms(
        lambda: feedback_loop(src, n_programs, n_views), reps) / K
    kernel = common.graph_ms(
        lambda: [micro.micro_launch(src, n_programs, n_views)
                 for _ in range(K)], reps) / K
    print('%-30s eager %7.4f ms, graph %7.4f ms, host %7.4f ms/iter; '
          'kernel %7.4f ms (%6.2f ns/prog, %6.3f ns/view); %.4g B, bound '
          '%.4f ms (%s), %.1f%% of it' % (
              label, eager, graph, eager - graph, kernel,
              kernel / n_programs * 1e6,
              kernel / (n_programs * n_views) * 1e6, work['bytes'],
              bound_ms, bound_by, 100 * bound_ms / kernel), flush=True)
    return dict(label=label, eager_ms=eager, graph_ms=graph,
                kernel_ms=kernel, bound_ms=bound_ms, bound_by=bound_by,
                **work)


def main():
    print(common.require_cuda(), flush=True)
    return [bench(*case) for case in CASES]


if __name__ == '__main__':
    main()
