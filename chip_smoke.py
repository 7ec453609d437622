"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then not 0):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the two CUDA pair kernels from ``pysph_tpu_torch/csrc`` with
   nvcc, one process per source, in parallel;
3. ``wcsph_pair`` against its plain torch version on the card, on the
   dam_break_3d state with a seeded velocity and density perturbation:
   dx=0.04 (24,672 particles) in float64 (scaled error <= 1e-10) and
   float32 (<= 1e-4 of max|ref|), and dx=0.02 (143,051 particles, the
   main path's shapes) in float32, where both are also timed; then 10
   steps of dam_break_3d at dx=0.04 in float64 on the kernel engine
   against the torch engine (<= 1e-9 of max|ref|);
4. the main path: ``pysph_tpu_torch.examples.dam_break_3d`` at dx=0.02
   in float32 for ``STEPS`` steps, with the kernel's launches counted,
   the median ms/step after warm-up, and a finite final state;
5. ``gtvf_pair`` against its plain version on the GTVF dam break
   (``examples.dam_break_2d --scheme gtvf``) with a seeded perturbation,
   every phase set of both evaluators: dx=0.02 (7,603 particles) in
   float64 and float32, dx=0.004 (137,803 particles, the path's shapes)
   in float32, timed there; infinities (``rhodiv`` next to the walls)
   must match exactly; then 10 steps at dx=0.02 in float64 on the kernel
   engine against the torch engine (<= 1e-9 of max|ref|);
6. the GTVF path at dx=0.004 in float32 for ``STEPS`` steps: launches
   counted (2 + 5 x steps), every pair phase of both evaluators on the
   kernel, the median ms/step, and a finite final state (``rhodiv``
   aside).

The line before the last is a JSON summary of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp

STEPS = 200
WARMUP = 20
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _app(dx, dtype, steps=0, engine='kernel', cls=DamBreak3D, extra=()):
    app = cls()
    argv = ['--dx', str(dx), '--disable-output', '-q', '--device', 'cuda',
            '--engine', engine, *extra]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    app.setup(argv)
    return app


def _perturb(states, dtype, props, seed=12345):
    rng = np.random.default_rng(seed)
    for st in states.values():
        n = st['x'].shape[0]
        for p in props:
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n), dtype=dtype,
                                    device='cuda')
        st['rho'] = torch.as_tensor(1000.0 * (1.0 + 0.01 * rng.normal(
            size=n)), dtype=dtype, device='cuda')


def _plan_calls(s, evals):
    """[(eval index, dest, plan, kernel arguments)] for every planned
    pair phase of the solver's evaluators ``evals``, on its states."""
    calls = []
    for k in evals:
        a_eval = s.acceleration_evals[k]
        cells = a_eval.grid.bin_all(s.states)
        for group in a_eval.groups:
            for dest in a_eval._dest_order(group):
                plan = a_eval._plans.get((id(group), dest))
                if plan is None:
                    continue
                store = s.states[dest]
                pre = {p: torch.zeros_like(store[p]) for p in plan.outputs}
                srcs = [(s.states[ps.name], cells[ps.name], ps)
                        for ps in plan.sources]
                calls.append((k, dest, plan, (
                    store, cells[dest], group.write_mask(store), pre, srcs,
                    a_eval.grid, a_eval.kernel)))
    return calls


def _pair_calls(dx, dtype):
    """(calls, particle count) for one eval of the perturbed dam break
    at ``dx``."""
    app = _app(dx, dtype)
    s = app.solver
    _perturb(s.states, dtype, 'uvw')
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return _plan_calls(s, [0]), n


def _gtvf_calls(dx, dtype):
    """(calls, particle count) for both evals of the perturbed GTVF dam
    break at ``dx``, after one pass of each eval has set the derived
    properties (wall ghost velocities, rho0, p0, ...)."""
    app = _app(dx, dtype, cls=DamBreak2D, extra=('--scheme', 'gtvf'))
    s = app.solver
    _perturb(s.states, dtype, ('u', 'v', 'uhat', 'vhat'))
    for a_eval in s.acceleration_evals:
        a_eval.compute(0.0, s.dt, s.states)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return _plan_calls(s, range(len(s.acceleration_evals))), n


def _compare(calls, dtype, label):
    """Max absolute and max scaled error of each kernel against its
    plain version over every dest and output (on the entries where the
    plain version is finite; its infinities must be matched exactly)."""
    worst_abs = worst_scaled = 0.0
    for k, dest, plan, args in calls:
        got = plan.op(*args)
        ref = plan.reference(*args)
        torch.cuda.synchronize()
        for p in ref:
            fin = torch.isfinite(ref[p])
            if not torch.equal(torch.isfinite(got[p]), fin) or \
                    not torch.equal(got[p][~fin], ref[p][~fin]):
                raise AssertionError('%s eval %d %s.%s: non-finite entries '
                                     'differ' % (label, k, dest, p))
            d = float((got[p][fin] - ref[p][fin]).abs().max())
            scale = max(float(ref[p][fin].abs().max()), 1e-300)
            worst_abs = max(worst_abs, d)
            worst_scaled = max(worst_scaled, d / scale)
            if not d <= TOL[dtype] * scale:
                raise AssertionError('%s eval %d %s.%s: error %.3g > %.1g '
                                     '* %.3g' % (label, k, dest, p, d,
                                                 TOL[dtype], scale))
    print('compare %s: max abs err %.3g, max scaled err %.3g (tol %.0e)'
          % (label, worst_abs, worst_scaled, TOL[dtype]), flush=True)
    return worst_abs


def _engines_agree(label, dx, steps, props, cls=DamBreak3D, extra=()):
    """A path on the kernel engine against the same run on the plain
    torch engine, float64, after ``steps`` steps (non-finite entries
    must match exactly)."""
    runs = {}
    for engine in ('kernel', 'torch'):
        app = _app(dx, torch.float64, steps=steps, engine=engine, cls=cls,
                   extra=extra)
        app.solve()
        runs[engine] = app
    worst = 0.0
    for name, ref in runs['torch'].solver.states.items():
        got = runs['kernel'].solver.states[name]
        for p in props:
            if p not in ref:
                continue
            fin = torch.isfinite(ref[p])
            if not torch.equal(torch.isfinite(got[p]), fin) or \
                    not torch.equal(got[p][~fin], ref[p][~fin]):
                raise AssertionError('engines disagree on the non-finite '
                                     'entries of %s.%s' % (name, p))
            scale = max(float(ref[p][fin].abs().max()), 1e-300)
            err = float((got[p][fin] - ref[p][fin]).abs().max()) / scale
            worst = max(worst, err)
            if not err <= 1e-9:
                raise AssertionError('engines disagree on %s.%s after %d '
                                     'steps: %.3g' % (name, p, steps, err))
    print('%s dx=%g float64, %d steps: kernel engine against torch engine, '
          'max scaled err %.3g (tol 1e-09)' % (label, dx, steps, worst),
          flush=True)


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


def _drive(app, label, op, first, per_step, skip_finite=()):
    """Solve ``app`` for ``STEPS`` steps with ``op``'s launch count set
    to 0 just before and read just after; check that the initial eval
    launched ``first`` and each step ``per_step`` times, that every pair
    phase of every evaluator was planned on the kernel, and that the
    final state is finite (``skip_finite`` aside).  Returns (launches,
    particle count)."""
    counts = {pa.name: pa.get_number_of_particles() for pa in app.particles}
    n = sum(counts.values())
    print('%s: %s, %d particles' % (label, counts, n))
    stamps = []
    at_first_step = []

    def pre_step(solver):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if not at_first_step:
            at_first_step.append(op.launches)

    app.solver.add_pre_step_callback(pre_step)
    op.launches = 0
    app.solve()
    torch.cuda.synchronize()
    launches = op.launches
    step_launches = launches - at_first_step[0]
    for k, a_eval in enumerate(app.solver.acceleration_evals):
        print('eval %d engine_choices: %s' % (k, a_eval.engine_choices))
        if set(a_eval.engine_choices.values()) != {'kernel'}:
            raise AssertionError('a dest planned off the kernel: %s'
                                 % a_eval.engine_choices)
    print('%s launches: %d in the run = %d (initial eval) + %d in the %d '
          'steps (expected %d + %d x steps)' % (
              op.__name__, launches, at_first_step[0], step_launches,
              STEPS, first, per_step))
    if app.solver.count != STEPS or at_first_step[0] != first or \
            step_launches != per_step * STEPS:
        raise AssertionError('%s did not run every pair phase through the '
                             'kernel' % label)
    for name, st in app.solver.states.items():
        for p, v in st.items():
            if p in skip_finite or not v.is_floating_point():
                continue
            if not bool(torch.isfinite(v).all()):
                raise AssertionError('non-finite %s.%s after the run'
                                     % (name, p))
    ms = np.diff(stamps)[WARMUP:] * 1e3
    med = float(np.median(ms))
    print('%s ms/step: median %.3f (min %.3f, max %.3f) over steps %d-%d; '
          '%.4g particle-steps/s; t=%.6g dt=%.6g' % (
              label, med, ms.min(), ms.max(), WARMUP + 1, STEPS,
              n / med * 1e3, app.solver.t, app.solver.dt), flush=True)
    return launches, n


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
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(build.build, ('wcsph_pair', 'gtvf_pair')))
    print('built %s in %.1f s' % ([lib.name for lib in libs],
                                  time.perf_counter() - t0))
    for lib in libs:
        print(lib.with_suffix('.log').read_text().strip(), flush=True)

    # wcsph_pair against its plain version
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n = _pair_calls(dx, dtype)
        _compare(calls, dtype, 'wcsph_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = _pair_calls(0.02, torch.float32)
    wcsph_err = _compare(calls, torch.float32, 'wcsph_pair dx=0.02 float32 '
                         '(%d particles)' % n)
    wcsph_ms = _time_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    wcsph_plain_ms = _time_ms(
        lambda: [c[2].reference(*c[3]) for c in calls], 3)
    print('wcsph_pair, pair phases of one eval at dx=0.02 float32: kernel '
          '%.3f ms, plain torch %.3f ms' % (wcsph_ms, wcsph_plain_ms),
          flush=True)
    del calls
    _engines_agree('dam_break_3d', 0.04, 10,
                   ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p'))

    # the main path
    app = _app(0.02, torch.float32, steps=STEPS)
    wcsph_launches, n = _drive(app, 'dam_break_3d dx=0.02 float32',
                               wp.wcsph_pair, 3, 6)
    if n != 143051:
        raise AssertionError('dam_break_3d at dx=0.02 has %d particles, '
                             'not 143,051' % n)
    del app

    # gtvf_pair against its plain version
    for dx, dtype in ((0.02, torch.float64), (0.02, torch.float32)):
        calls, n = _gtvf_calls(dx, dtype)
        _compare(calls, dtype, 'gtvf_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = _gtvf_calls(0.004, torch.float32)
    gtvf_err = _compare(calls, torch.float32, 'gtvf_pair dx=0.004 float32 '
                        '(%d particles)' % n)
    gtvf_ms = gtvf_plain_ms = 0.0
    for k in (0, 1):
        mine = [c for c in calls if c[0] == k]
        kms = _time_ms(lambda: [c[2].op(*c[3]) for c in mine], 20)
        pms = _time_ms(lambda: [c[2].reference(*c[3]) for c in mine], 3)
        print('gtvf_pair, pair phases of eval %d (%d launches) at dx=0.004 '
              'float32: kernel %.3f ms, plain torch %.3f ms'
              % (k, len(mine), kms, pms), flush=True)
        gtvf_ms += kms
        gtvf_plain_ms += pms
    del calls, mine
    _engines_agree('GTVF dam_break_2d', 0.02, 10,
                   ('x', 'y', 'u', 'v', 'rho', 'p', 'sigma', 'rhodiv',
                    'au', 'auhat', 'V'), cls=DamBreak2D,
                   extra=('--scheme', 'gtvf'))

    # the GTVF path: 2 launches in the initial eval (eval 0), 5 a step
    app = _app(0.004, torch.float32, steps=STEPS, cls=DamBreak2D,
               extra=('--scheme', 'gtvf'))
    gtvf_launches, n = _drive(app, 'GTVF dam_break_2d dx=0.004 float32',
                              gp.gtvf_pair, 2, 5, skip_finite=('rhodiv',))
    rhodiv = app.solver.states['fluid']['rhodiv']
    if bool((rhodiv == -float('inf')).any()):
        raise AssertionError('rhodiv holds -inf')
    print('fluid rhodiv: %d inf, %d nan of %d (a boundary neighbour, whose '
          'rho0 is 0)' % (int(torch.isinf(rhodiv).sum()),
                          int(torch.isnan(rhodiv).sum()), rhodiv.numel()))

    print(json.dumps({'kernels': [{
        'name': 'wcsph_pair', 'route': 'cuda',
        'source': 'pysph_tpu_torch/csrc/wcsph_pair.cu',
        'replaces': 'pysph_tpu/ops/resident.py:645',
        'launches': wcsph_launches, 'max_abs_err': wcsph_err,
        'ms': wcsph_ms, 'plain_ms': wcsph_plain_ms}, {
        'name': 'gtvf_pair', 'route': 'cuda',
        'source': 'pysph_tpu_torch/csrc/gtvf_pair.cu',
        'replaces': 'pysph_tpu/ops/pallas_engine.py:1160',
        'launches': gtvf_launches, 'max_abs_err': gtvf_err,
        'ms': gtvf_ms, 'plain_ms': gtvf_plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
