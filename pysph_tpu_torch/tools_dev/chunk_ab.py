"""ms/step in chunks of the full-width paths, for comparing two checkouts
of the port on one card.

    PYTHONPATH=<checkout> python3 pysph_tpu_torch/tools_dev/chunk_ab.py \\
        <label> [path ...]

Runs each path of the checkout's ``time_chunks.PATHS`` (or the paths
named) for ``time_chunks.STEPS`` steps in float32 under the default
binning configuration, in chunks of 10, and prints one JSON line a path
with the median ms/step of ``time_chunks.timed_solve`` and its spread
and the run's peak device memory (MiB, from a reset just before it,
after a garbage collection: ``timed_solve`` leaves each solver in a
reference cycle, so an earlier path's app and its graph's memory would
stay until the collector runs), tagged with ``label`` and the card's
name and power limit.  It uses only
names that older checkouts have too, so run it by path with
``PYTHONPATH`` set to each checkout and alternate them in one call
(older, newer, newer, older): runs within a call vary by ~10%, calls by
more.
"""

import gc
import json
import sys

import torch

from pysph_tpu_torch.tools_dev import common, time_chunks
from pysph_tpu_torch.tools_dev.time_walks import make_app


def main(label, paths=()):
    smi = common.require_cuda()
    rows = []
    for path in paths or time_chunks.PATHS:
        app = time_chunks.configure(make_app(
            dtype=torch.float32, steps=time_chunks.STEPS,
            **time_chunks.PATHS[path]), 'reuse')
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms, samples = time_chunks.timed_solve(app, 10)
        row = dict(label=label, card=smi, path=path, ms_per_step=ms,
                   min=min(samples), max=max(samples),
                   samples=len(samples),
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del app
    return rows


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '', sys.argv[2:])
