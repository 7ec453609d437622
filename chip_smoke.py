"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then not 0):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the CUDA pair kernel from ``pysph_tpu_torch/csrc`` with nvcc;
3. the kernel against its plain torch version on the card, on the
   dam_break_3d state with a seeded velocity and density perturbation:
   dx=0.04 (24,672 particles) in float64 (scaled error <= 1e-10) and
   float32 (<= 1e-4 of max|ref|), and dx=0.02 (143,051 particles, the
   main path's shapes) in float32, where both are also timed; then 10
   steps of dam_break_3d at dx=0.04 in float64 on the kernel engine
   against the torch engine (<= 1e-9 of max|ref|);
4. the main path: ``pysph_tpu_torch.examples.dam_break_3d`` at dx=0.02
   in float32 for ``STEPS`` steps, with the kernel's launches counted,
   the median ms/step after warm-up, and a finite final state.

The line before the last is a JSON summary of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import wcsph_pair as wp

STEPS = 200
WARMUP = 20
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _app(dx, dtype, steps=0, engine='kernel'):
    app = DamBreak3D()
    argv = ['--dx', str(dx), '--disable-output', '-q', '--device', 'cuda',
            '--engine', engine]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    app.setup(argv)
    return app


def _pair_calls(dx, dtype):
    """([(dest, wcsph_pair arguments)], particle count) for one eval of
    the perturbed dam break at ``dx``."""
    app = _app(dx, dtype)
    s = app.solver
    rng = np.random.default_rng(12345)
    for st in s.states.values():
        n = st['x'].shape[0]
        for p in 'uvw':
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n), dtype=dtype,
                                    device='cuda')
        st['rho'] = torch.as_tensor(1000.0 * (1.0 + 0.01 * rng.normal(
            size=n)), dtype=dtype, device='cuda')
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    a_eval = s.acceleration_evals[0]
    cells = a_eval.grid.bin_all(s.states)
    calls = []
    for group in a_eval.groups:
        for dest in a_eval._dest_order(group):
            plan = a_eval._plans.get((id(group), dest))
            if plan is None:
                continue
            store = s.states[dest]
            pre = {p: torch.zeros_like(store[p]) for p in plan.outputs}
            srcs = [(s.states[ps.name], cells[ps.name], ps)
                    for ps in plan.sources]
            calls.append((dest, (store, cells[dest], store['tag'] == 0,
                                 pre, srcs, a_eval.grid, a_eval.kernel)))
    n = sum(st['x'].shape[0] for st in s.states.values())
    return calls, n


def _compare(calls, dtype, label):
    """Max absolute and max scaled error of the kernel against the plain
    version over every dest and output."""
    worst_abs = worst_scaled = 0.0
    for dest, args in calls:
        got = wp.wcsph_pair(*args)
        ref = wp.wcsph_pair_reference(*args)
        torch.cuda.synchronize()
        for p in ref:
            d = float((got[p] - ref[p]).abs().max())
            scale = max(float(ref[p].abs().max()), 1e-300)
            worst_abs = max(worst_abs, d)
            worst_scaled = max(worst_scaled, d / scale)
            if not d <= TOL[dtype] * scale:
                raise AssertionError('%s %s.%s: error %.3g > %.1g * %.3g'
                                     % (label, dest, p, d, TOL[dtype],
                                        scale))
    print('compare %s: max abs err %.3g, max scaled err %.3g (tol %.0e)'
          % (label, worst_abs, worst_scaled, TOL[dtype]), flush=True)
    return worst_abs


def _engines_agree(dx, steps):
    """The main path on the kernel engine against the same run on the
    plain torch engine, float64, after ``steps`` steps."""
    runs = {}
    for engine in ('kernel', 'torch'):
        app = _app(dx, torch.float64, steps=steps, engine=engine)
        app.solve()
        runs[engine] = app
    worst = 0.0
    for name, ref in runs['torch'].solver.states.items():
        got = runs['kernel'].solver.states[name]
        for p in ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p'):
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p] - ref[p]).abs().max()) / scale
            worst = max(worst, err)
            if not err <= 1e-9:
                raise AssertionError('engines disagree on %s.%s after %d '
                                     'steps: %.3g' % (name, p, steps, err))
    print('dam_break_3d dx=%g float64, %d steps: kernel engine against '
          'torch engine, max scaled err %.3g (tol 1e-09)'
          % (dx, steps, worst), flush=True)


def _time_ms(fn, reps):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print('torch %s, CUDA %s, device %s' % (torch.__version__,
                                            torch.version.cuda, name))

    t0 = time.perf_counter()
    lib = build.build('wcsph_pair')
    print('built %s in %.1f s' % (lib.name, time.perf_counter() - t0))
    print(lib.with_suffix('.log').read_text().strip(), flush=True)

    # kernel against its plain version
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n = _pair_calls(dx, dtype)
        _compare(calls, dtype, 'dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = _pair_calls(0.02, torch.float32)
    max_abs_err = _compare(calls, torch.float32, 'dx=0.02 float32 (%d '
                           'particles)' % n)
    kernel_ms = _time_ms(lambda: [wp.wcsph_pair(*a) for _, a in calls], 20)
    plain_ms = _time_ms(
        lambda: [wp.wcsph_pair_reference(*a) for _, a in calls], 3)
    print('pair phases of one eval at dx=0.02 float32: kernel %.3f ms, '
          'plain torch %.3f ms' % (kernel_ms, plain_ms), flush=True)
    del calls
    _engines_agree(0.04, 10)

    # the main path
    app = _app(0.02, torch.float32, steps=STEPS)
    counts = {pa.name: pa.get_number_of_particles() for pa in app.particles}
    n = sum(counts.values())
    print('dam_break_3d dx=0.02 float32: %s, %d particles' % (counts, n))
    if n != 143051:
        raise AssertionError('dam_break_3d at dx=0.02 has %d particles, '
                             'not 143,051' % n)
    stamps = []
    at_first_step = []

    def pre_step(solver):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if not at_first_step:
            at_first_step.append(wp.wcsph_pair.launches)

    app.solver.add_pre_step_callback(pre_step)
    wp.wcsph_pair.launches = 0
    app.solve()
    torch.cuda.synchronize()
    launches = wp.wcsph_pair.launches
    step_launches = launches - at_first_step[0]
    choices = app.solver.acceleration_evals[0].engine_choices
    print('engine_choices: %s' % choices)
    print('kernel launches: %d in the run, %d in the %d steps (3 dests x 2 '
          'evals x steps = %d)' % (launches, step_launches, STEPS,
                                   6 * STEPS))
    if app.solver.count != STEPS or step_launches != 6 * STEPS or \
            launches != 3 + 6 * STEPS:
        raise AssertionError('the main path did not run every pair phase '
                             'through the kernel')
    if set(choices.values()) != {'kernel'}:
        raise AssertionError('a dest planned off the kernel: %s' % choices)
    for st in app.solver.states.values():
        for p, v in st.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError('non-finite %s after the run' % p)
    ms = np.diff(stamps)[WARMUP:] * 1e3
    med = float(np.median(ms))
    print('ms/step: median %.3f (min %.3f, max %.3f) over steps %d-%d; '
          '%.4g particle-steps/s; t=%.6g dt=%.6g' % (
              med, ms.min(), ms.max(), WARMUP + 1, STEPS, n / med * 1e3,
              app.solver.t, app.solver.dt))

    print(json.dumps({'kernels': [{
        'name': 'wcsph_pair', 'route': 'cuda',
        'source': 'pysph_tpu_torch/csrc/wcsph_pair.cu',
        'replaces': 'pysph_tpu/ops/resident.py:645',
        'launches': launches, 'max_abs_err': max_abs_err,
        'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
