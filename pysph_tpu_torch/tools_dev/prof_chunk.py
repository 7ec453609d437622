"""Device time by layer of a step replayed from the solver's CUDA graph.

    python3 -m pysph_tpu_torch.tools_dev.prof_chunk [label [path ...]]

Sets each full-width path of ``time_chunks.PATHS`` (or the paths named)
up in float32, solves it ``STEPS`` steps (past its damped steps, into its
chunks), then times on the state it reached:

- the solver's chunk graph: CUDA events around replays, and the device's
  busy time and kernels from ``torch.profiler`` (CUDA activity only) over
  replays, per step (a replay runs ``chunk_steps`` steps); and, from the
  profiler's trace of one replay, the idle time between its first and
  last device operation, its ``GAPS`` longest gaps, each with the
  operations before and after it, and the ``GAPS`` operations after
  which the most idle time falls in all;
- one CUDA graph per layer, busy time from the profiler over replays:
  the binning of each evaluator as a step runs it, its reuse test and
  the gated kernels (``ops/bin_cells.py``), once kept (``prepare_reuse``
  on the positions it was binned at) and once rebuilt (``prepare``); its
  pair calls (each plan's kernel wrapper, the source packs included, a
  linked pair as the path runs it), the whole eval on its
  binning (``compute``), each integrator stage and the adaptive dt
  (``compute_time_step``), and on a periodic box the position wrap
  (``update_domain``, times the wraps a step the captures counted); the
  elementwise phases of an eval are the eval less its pair calls; an
  evaluator's evals a step are those the solve's captures counted.  The
  binning a step is each evaluator's test, kept, plus the share of tests
  that rebuilt in the solve (``rebuilds``) times the difference; "rest"
  is the step less its evals, binning, stages, wraps and dt (the chunk's
  write-back selects and its t/dt arithmetic).

Then the host's part of a chunk: the replay call, the replay and its
wait, and a whole ``Solver._run_chunk`` (host clock, medians).

Where the profiler shows no device time, the layer's time is CUDA events
around its graph's replays instead (``method``).  Prints one JSON line
per path, tagged with ``label`` and the card's name and power limit.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pysph_tpu_torch.ops.build import BUILD_DIR
from pysph_tpu_torch.tools_dev import common
from pysph_tpu_torch.tools_dev.time_chunks import PATHS
from pysph_tpu_torch.tools_dev.time_walks import (
    make_app, plan_calls, run_as_path)

STEPS = 80
REPS = 10
GAPS = 5
#: the trace's categories of device operations
DEVICE_OPS = ('kernel', 'gpu_memcpy', 'gpu_memset')
STAGES = ('initialize', 'stage1', 'stage2', 'stage3', 'stage4', 'stage5')


def _busy(prof):
    """(device ms, kernels) of all device events the profiler kept."""
    ms, n = 0.0, 0
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            ms += us / 1e3
            n += evt.count
    return ms, n


def replay_busy(graph, reps=REPS):
    """(busy ms, kernels, events ms) a replay of ``graph``."""
    graph.replay()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    ms, n = _busy(prof)
    return ms / reps, n / reps, common.events_ms(graph.replay, reps)


def replay_gaps(graph, top=GAPS):
    """The idle time of one replay of ``graph`` from the profiler's
    trace (``trace_gaps``)."""
    return trace_gaps(graph.replay, top)


def trace_gaps(fn, top=GAPS):
    """The idle time of one call of ``fn`` (after one warm-up call) from
    the profiler's trace: {span_us: its first device operation's start
    to its last's end, idle_us: the time in that span that no operation
    runs, ops: the device operations, gaps: the ``top`` longest idle
    gaps, [us, operation before, operation after], after: the ``top``
    operations (by name) after which the most idle time falls, [us, gaps,
    name], busy: {operation name: its device us}}."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix='.json', dir=BUILD_DIR)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    device = [e for e in events if e.get('cat') in DEVICE_OPS]
    ops = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'][:80])
                 for e in device)
    if not ops:
        return None
    busy = {}
    for e in device:
        busy[e['name']] = busy.get(e['name'], 0.0) + e.get('dur', 0)
    gaps, (_, end, last) = [], ops[0]
    for start, stop, name in ops[1:]:
        if start > end:
            gaps.append([start - end, last, name])
        if stop > end:
            end, last = stop, name
    after = {}
    for us, name, _ in gaps:
        total = after.setdefault(name, [0.0, 0, name])
        total[0] += us
        total[1] += 1
    gaps.sort(key=lambda g: -g[0])
    return dict(span_us=end - ops[0][0], idle_us=sum(g[0] for g in gaps),
                ops=len(ops), gaps=gaps[:top],
                after=sorted(after.values(), key=lambda a: -a[0])[:top],
                busy=busy)


def chunk_host(s, reps=REPS):
    """Host milliseconds of a chunk on the solver's graph (medians): the
    replay call alone, the replay and the wait for it, and a whole
    ``_run_chunk`` at ``max_steps`` (every step inactive: the same
    device work, the read and the host's bookkeeping)."""
    call, replay, whole = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        s._graph.replay()
        call.append(time.perf_counter() - start)
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - start)
    for _ in range(reps):
        start = time.perf_counter()
        s._run_chunk()
        whole.append(time.perf_counter() - start)
    return {name: float(np.median(v)) * 1e3 for name, v in (
        ('replay_call_ms', call), ('replay_and_wait_ms', replay),
        ('run_chunk_ms', whole))}


def layer_ms(fn):
    """(device ms a call, how measured, kernels a call) of ``fn``
    replayed from a CUDA graph."""
    busy, n, events = replay_busy(common.capture(fn))
    if busy > 0:
        return busy, 'profiler', n
    return events, 'events', None


def _copy(states):
    return {name: dict(st) for name, st in states.items()}


def _count_captured_evals(integ):
    """Count the integrator's evaluations and position wraps made inside
    a CUDA graph's capture (in ``integ.captured_evals`` and
    ``captured_wraps``)."""
    compute, wrap = integ.compute_accelerations, integ.update_domain
    integ.captured_evals = integ.captured_wraps = 0

    def counted(*args, **kw):
        integ.captured_evals += torch.cuda.is_current_stream_capturing()
        return compute(*args, **kw)

    def wrapped():
        integ.captured_wraps += torch.cuda.is_current_stream_capturing()
        return wrap()
    integ.compute_accelerations = counted
    integ.update_domain = wrapped


def profile_path(path, kw):
    app = make_app(dtype=torch.float32, steps=STEPS, **kw)
    _count_captured_evals(app.solver.integrator)
    app.solve()
    s = app.solver
    # the solve's binnings (the replays below advance the run further)
    rebuilds = s.rebuilds
    if s._graph is None:
        raise AssertionError('%s: no chunk was captured in %d steps'
                             % (path, STEPS))
    k = s.chunk_steps
    busy, kernels, events = replay_busy(s._graph)
    method = {'profiler' if busy > 0 else 'events'}
    row = dict(path=path, steps_per_replay=k,
               particles=sum(st['x'].shape[0] for st in s.states.values()),
               step_graph_ms=events / k, step_busy_ms=busy / k,
               step_kernels=kernels / k,
               idle_share=1.0 - busy / events if busy > 0 else None,
               replay_idle=replay_gaps(s._graph))
    busy = busy if busy > 0 else events
    row['chunk_host'] = chunk_host(s)
    f64 = dict(dtype=torch.float64, device=s.config.device)
    t, dt = torch.tensor(s.t, **f64), torch.tensor(s.dt, **f64)
    layers = {}

    def measure(name, fn):
        ms, how, n = layer_ms(fn)
        layers[name] = dict(ms=ms, kernels=n)
        method.add(how)
        return ms

    evals = kept_a_step = more_if_rebuilt = 0.0
    for i, a_eval in enumerate(s.acceleration_evals):
        used = {n: s.states[n] for n in a_eval.arrays_used}
        handle = s.integrator.handles[i]
        # rebuilt at the current positions, then kept there
        rebuilt = measure('eval %d binning rebuilt' % i,
                          lambda: a_eval.prepare(used, handle))
        kept = measure('eval %d binning kept' % i,
                       lambda: a_eval.prepare_reuse(used, handle))
        kept_a_step += kept
        more_if_rebuilt += rebuilt - kept
        calls = plan_calls(s, [i])
        pairs = measure('eval %d pair calls (%d)' % (i, len(calls)),
                        lambda: run_as_path(calls))
        whole = measure('eval %d' % i, lambda: a_eval.compute(
            t, dt, _copy(s.states), handle))
        layers['eval %d elementwise' % i] = dict(ms=whole - pairs,
                                                 kernels=None)
        evals += whole
    # the evaluations a step, from those the captures counted (PEC one,
    # EPEC its one evaluator twice, GTVF each of two once)
    a_step = s.integrator.captured_evals / (k * s.captures)
    evals_a_step = evals * a_step / len(s.acceleration_evals)
    # the tests of the run that rebuilt (the first binning forced)
    tests = STEPS * len(s.acceleration_evals)
    rebuilt_share = (rebuilds - 1) / tests
    binning_a_step = kept_a_step + rebuilt_share * more_if_rebuilt
    integ = s.integrator
    stages = 0.0
    for name in STAGES:
        if not any(hasattr(st, name) for st in integ.steppers.values()):
            continue

        def stage(name=name):
            integ._states, integ._t, integ._dt = _copy(s.states), t, dt
            integ._run_stage(name)
        stages += measure('stage ' + name, stage)
    wrap_ms = 0.0
    if integ.domain is not None and integ.domain.is_periodic:
        wraps = integ.captured_wraps / (k * s.captures)

        def wrap():
            integ._states = _copy(s.states)
            integ.update_domain()
        wrap_ms = wraps * measure('domain wrap', wrap)
    integ._states = None
    dt_ms = 0.0
    if s.adaptive_timestep:
        dt_ms = measure('adaptive dt', lambda: integ.compute_time_step(
            s.states, dt.to(s.config.dtype), s.cfl))
    row.update(layers=layers, evals_a_step=a_step,
               evals_a_step_ms=evals_a_step,
               rebuilds=rebuilds, rebuilt_share=rebuilt_share,
               binning_a_step_ms=binning_a_step, stages_ms=stages,
               wrap_ms=wrap_ms, dt_ms=dt_ms,
               rest_ms=busy / k - evals_a_step - binning_a_step - stages -
               wrap_ms - dt_ms, method=sorted(method))
    return row


def main(label='', paths=()):
    smi = common.require_cuda()
    rows = []
    for path in paths or PATHS:
        row = dict(label=label, card=smi, **profile_path(path, PATHS[path]))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '', sys.argv[2:])
