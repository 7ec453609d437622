"""Timing on the card, shared by the tools and ``chip_smoke.py``.

Every time is device time from CUDA events: ``events_ms`` around eager
calls (it includes whatever the host makes the stream wait for), and
``graph_ms`` around replays of one CUDA graph that captured the calls
(no Python or launch cost of the host between kernels, the counterpart
of a JAX ``jit``).
"""

import subprocess

import torch


def require_cuda():
    """The card's ``nvidia-smi`` name and power limit; raises without a
    card (the tools time the device and have no CPU fallback)."""
    if not torch.cuda.is_available():
        raise SystemExit('torch.cuda.is_available() is False: this tool '
                         'times an NVIDIA card')
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def events_ms(fn, reps):
    """Milliseconds per call of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(fn):
    """A CUDA graph of ``fn``'s launches, after one warm-up call on a
    side stream (as ``torch.cuda.graphs`` asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, reps):
    """Milliseconds per replay of a CUDA graph of ``fn``."""
    return events_ms(capture(fn).replay, reps)


def graph_kernels_ms(fn, reps):
    """{kernel name: device milliseconds a replay} of a CUDA graph of
    ``fn``, from ``torch.profiler`` (CUDA activity only) over ``reps``
    replays."""
    graph = capture(fn)
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            out[evt.key] = us / 1e3 / reps
    return out


def linked_calls(calls):
    """[(emitting call, consuming call)] of each linked pair of plans
    among ``calls`` (``time_walks.plan_calls``'; ``ops/pair_engine.py::
    link_pairs``)."""
    pairs = []
    for c in calls:
        link = c[2].link
        if link is not None and c[2] is link.emitter:
            (d,) = [d for d in calls if d[0] == c[0] and
                    d[2] is link.consumer]
            pairs.append((c, d))
    return pairs
