"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then not 0):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the four CUDA kernels from ``pysph_tpu_torch/csrc`` with nvcc,
   one process per source, in parallel, and print ``-Xptxas -v``;
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
   aside);
7. ``wcsph_pair`` with the Gaussian kernel and ``dense_pair`` against
   their plain version on the elliptical drop (``examples.elliptical_drop``)
   with a seeded velocity and density perturbation: nx=40 (5,021
   particles) in float64 (scaled error <= 1e-10) and nx=200 (125,623,
   the path's shapes) in float32 (<= 1e-4); ``dense_pair`` also on
   dam_break_3d's calls at dx=0.04 in float64 and dx=0.02 in float32
   (three sources, 3D); ``dense_pair``, ``wcsph_pair`` and the plain
   version timed on identical calls at nx=200 and at dx=0.02;
8. ``fused_continuity_momentum`` (CubicSpline) against its plain version
   on the perturbed drop at nx=200 in float64 and float32, timed; then,
   with its launches counted, m times its rates against ``wcsph_pair``'s
   Continuity + Momentum on the same state;
9. the elliptical drop at nx=200 in float32 for ``STEPS`` steps under
   ``--engine kernel`` (``wcsph_pair``) and ``--engine dense``
   (``dense_pair``): launches counted (1 + 2 x steps), every pair phase
   on the engine, the median ms/step, and a finite final state;
10. the physics gate: the drop at nx=40 in float64 to tf=0.0076 under
    ``--engine dense``, dumping into a temporary directory under
    ``build/``: max |y| within 3% of the exact semi-major axis, and
    ``post_process`` through the ported ``load``.

The line before the last is a JSON summary of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import (
    EllipticalDrop, exact_solution)
from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops.pair_engine import PairSource

STEPS = 200
WARMUP = 20
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _app(dx, dtype, steps=0, engine='kernel', cls=DamBreak3D, extra=()):
    app = cls()
    argv = ['--disable-output', '-q', '--device', 'cuda', '--engine',
            engine, *extra]
    if dx is not None:
        argv += ['--dx', str(dx)]
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


def _drop_calls(nx, dtype):
    """(calls, particle count, app) for one eval of the elliptical drop
    at ``nx`` with a seeded velocity and density perturbation."""
    app = _app(None, dtype, cls=EllipticalDrop, extra=('--nx', str(nx)))
    s = app.solver
    st = s.states['fluid']
    rng = np.random.default_rng(2024)
    n = st['x'].shape[0]
    for p in ('u', 'v'):
        st[p] = st[p] + torch.as_tensor(rng.normal(0.0, 10.0, n),
                                        dtype=dtype, device='cuda')
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n),
                                dtype=dtype, device='cuda')
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    return _plan_calls(s, [0]), n, app


def _compare(calls, dtype, label, op=None):
    """Max absolute and max scaled error of each kernel (``op``, else
    the plan's) against its plain version over every dest and output
    (on the entries where the plain version is finite; its infinities
    must be matched exactly)."""
    worst_abs = worst_scaled = 0.0
    for k, dest, plan, args in calls:
        got = (op or plan.op)(*args)
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


def _drive(app, label, op, first, per_step, skip_finite=(),
           engine='kernel'):
    """Solve ``app`` for ``STEPS`` steps with ``op``'s launch count set
    to 0 just before and read just after; check that the initial eval
    launched ``first`` and each step ``per_step`` times, that every pair
    phase of every evaluator was planned on ``engine``, and that the
    final state is finite (``skip_finite`` aside).  Returns (launches,
    particle count, median ms/step)."""
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
        if set(a_eval.engine_choices.values()) != {engine}:
            raise AssertionError('a dest planned off the %s engine: %s'
                                 % (engine, a_eval.engine_choices))
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
    return launches, n, med


def _fused_check(nx, dtype):
    """``fused_continuity_momentum`` on the perturbed drop at ``nx``
    with CubicSpline: the kernel against its plain version (timed in
    float32), then, with its launches counted, m times its rates
    against ``wcsph_pair``'s Continuity + Momentum on the same state
    (pre = 0).  Returns (launches, max abs err, kernel ms, plain ms)."""
    calls, n, app = _drop_calls(nx, dtype)
    del calls
    st = app.solver.states['fluid']
    grid = CellGrid.from_particles(app.particles, dim=2, radius_scale=2.0)
    cells = grid.bin_all({'fluid': st})['fluid']
    kw = dict(dim=2, c0=app.co, alpha=app.alpha, beta=0.0)
    tol = TOL[dtype]
    label = 'fused_pair nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
    got = fp.fused_continuity_momentum(st, cells, grid, **kw)
    ref = fp.fused_continuity_momentum_reference(st, cells, grid, **kw)
    torch.cuda.synchronize()
    worst = worst_scaled = 0.0
    for name, g, r in zip(('arho', 'au', 'av', 'aw'), got, ref):
        d = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1e-300)
        worst = max(worst, d)
        worst_scaled = max(worst_scaled, d / scale)
        if not d <= tol * scale:
            raise AssertionError('%s %s: error %.3g > %.1g * %.3g'
                                 % (label, name, d, tol, scale))
    print('compare %s: kernel against plain, max abs err %.3g, max scaled '
          'err %.3g (tol %.0e)' % (label, worst, worst_scaled, tol),
          flush=True)
    ms = plain_ms = 0.0
    if dtype == torch.float32:
        ms = _time_ms(lambda: fp.fused_continuity_momentum(
            st, cells, grid, **kw), 20)
        plain_ms = _time_ms(lambda: fp.fused_continuity_momentum_reference(
            st, cells, grid, **kw), 3)
        print('fused_pair at nx=%d float32: kernel %.3f ms, plain torch '
              '%.3f ms' % (nx, ms, plain_ms), flush=True)

    # the drop's Continuity + Momentum rates through the fused kernel,
    # against wcsph_pair with the same kernel on the same cells (the
    # fused kernel's viscosity takes a fixed c0, wcsph_pair's the mean
    # of the pair's sound speeds, which TaitEOS set from rho)
    terms = wp.CONT | wp.MOM
    ps = PairSource('fluid', terms, c0=app.co, alpha=app.alpha, beta=0.0)
    pre = {p: torch.zeros_like(st['x']) for p in wp.outputs_for(terms)}
    st = dict(st, cs=torch.full_like(st['x'], app.co))
    fp.fused_continuity_momentum.launches = 0
    rates = fp.fused_continuity_momentum(st, cells, grid, **kw)
    torch.cuda.synchronize()
    launches = fp.fused_continuity_momentum.launches
    if launches != 1:
        raise AssertionError('fused_pair launched %d times' % launches)
    want = wp.wcsph_pair(st, cells, None, pre, [(st, cells, ps)], grid,
                         CubicSpline(dim=2))
    torch.cuda.synchronize()
    m = st['m']
    for name, r in zip(('arho', 'au', 'av', 'aw'), rates):
        d = float((m * r - want[name]).abs().max())
        scale = max(float(want[name].abs().max()), 1e-300)
        if not d <= tol * scale:
            raise AssertionError('%s: m * %s against wcsph_pair: %.3g > '
                                 '%.1g * %.3g' % (label, name, d, tol, scale))
    print('%s: m x rates against wcsph_pair CONT|MOM within %.0e scaled'
          % (label, tol), flush=True)
    return launches, worst, ms, plain_ms


def _physics_gate():
    """The drop at nx=40 in float64 to tf=0.0076 on the dense engine:
    max |y| against the exact semi-major axis (3%), and post_process
    through the ported load."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix='elliptical_drop_', dir=build.BUILD_DIR)
    try:
        app = EllipticalDrop()
        app.setup(['--nx', '40', '--use-double', '--device', 'cuda',
                   '--engine', 'dense', '-q', '-d', out])
        start = time.perf_counter()
        app.solve()
        secs = time.perf_counter() - start
        s = app.solver
        y = s.states['fluid']['y']
        if not bool(torch.isfinite(y).all()):
            raise AssertionError('the drop has non-finite positions')
        computed = float(y.abs().max())
        exact = 1.0 / exact_solution(s.t)[0]
        err = abs(computed - exact) / exact
        print('elliptical_drop nx=40 float64 dense: t=%.6g after %d steps '
              '(%.1f s); max|y| %.5f, exact semi-major axis %.5f, error '
              '%.2f%% (bar 3%%); %d dump files' % (
                  s.t, s.count, secs, computed, exact, 100 * err,
                  len(app.output_files)), flush=True)
        if not (abs(s.t - 0.0076) < 1e-12 and err < 0.03):
            raise AssertionError('the drop missed the exact semi-major axis')
        result = app.post_process(app.info_filename)
        if not (result and np.isfinite(result['a_num'])):
            raise AssertionError('post_process gave %r' % (result,))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print('torch %s, CUDA %s, device %s' % (torch.__version__,
                                            torch.version.cuda, kind))

    t0 = time.perf_counter()
    names = ('wcsph_pair', 'gtvf_pair', 'dense_pair', 'fused_pair')
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
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
    wcsph_launches, n, _ = _drive(app, 'dam_break_3d dx=0.02 float32',
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
    gtvf_launches, n, _ = _drive(app, 'GTVF dam_break_2d dx=0.004 float32',
                                 gp.gtvf_pair, 2, 5, skip_finite=('rhodiv',))
    rhodiv = app.solver.states['fluid']['rhodiv']
    if bool((rhodiv == -float('inf')).any()):
        raise AssertionError('rhodiv holds -inf')
    print('fluid rhodiv: %d inf, %d nan of %d (a boundary neighbour, whose '
          'rho0 is 0)' % (int(torch.isinf(rhodiv).sum()),
                          int(torch.isnan(rhodiv).sum()), rhodiv.numel()))
    del app, rhodiv

    # wcsph_pair (Gaussian) and dense_pair against their plain version on
    # the perturbed drop; dense_pair also on dam_break_3d's calls
    timed = {}     # the float32 calls at the paths' shapes
    for nx, dtype in ((40, torch.float64), (200, torch.float32)):
        calls, n, _ = _drop_calls(nx, dtype)
        label = 'nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
        _compare(calls, dtype, 'wcsph_pair Gaussian drop ' + label)
        dense_err = _compare(calls, dtype, 'dense_pair drop ' + label,
                             dp.dense_pair)
    timed['drop nx=200'] = calls
    for dx, dtype in ((0.04, torch.float64), (0.02, torch.float32)):
        calls, n = _pair_calls(dx, dtype)
        _compare(calls, dtype, 'dense_pair dam_break_3d dx=%g %s (%d '
                 'particles)' % (dx, str(dtype)[6:], n), dp.dense_pair)
    timed['dam_break_3d dx=0.02'] = calls
    times = {}
    for label, calls in timed.items():
        times[label] = t = {}
        for name, op in (('dense_pair', dp.dense_pair),
                         ('wcsph_pair', wp.wcsph_pair),
                         ('plain', wp.wcsph_pair_reference)):
            reps = 3 if name == 'plain' else 20
            t[name] = _time_ms(lambda: [op(*c[3]) for c in calls], reps)
        print('pair phases of one eval, %s float32 (%d launches): '
              'dense_pair %.3f ms, wcsph_pair %.3f ms, plain torch %.3f ms'
              % (label, len(calls), t['dense_pair'], t['wcsph_pair'],
                 t['plain']), flush=True)
    del timed, calls

    # fused_continuity_momentum on the drop's state
    fused_launches = 0
    for dtype in (torch.float64, torch.float32):
        k, fused_err, fused_ms, fused_plain_ms = _fused_check(200, dtype)
        fused_launches += k

    # the elliptical drop on both engines
    steps_ms = {}
    for engine, op in (('kernel', wp.wcsph_pair), ('dense', dp.dense_pair)):
        app = _app(None, torch.float32, steps=STEPS, engine=engine,
                   cls=EllipticalDrop, extra=('--nx', '200'))
        launches, n, steps_ms[engine] = _drive(
            app, 'elliptical_drop nx=200 float32 --engine %s' % engine, op,
            1, 2, engine=engine)
        if n != 125623:
            raise AssertionError('the drop at nx=200 has %d particles, not '
                                 '125,623' % n)
        if engine == 'dense':
            dense_launches = launches
        del app
    print('elliptical_drop nx=200 float32 median ms/step: kernel %.3f, '
          'dense %.3f' % (steps_ms['kernel'], steps_ms['dense']), flush=True)

    _physics_gate()

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
        'ms': gtvf_ms, 'plain_ms': gtvf_plain_ms}, {
        'name': 'dense_pair', 'route': 'cuda',
        'source': 'pysph_tpu_torch/csrc/dense_pair.cu',
        'replaces': 'pysph_tpu/ops/pallas_engine.py:574',
        'launches': dense_launches, 'max_abs_err': dense_err,
        'ms': times['drop nx=200']['dense_pair'],
        'plain_ms': times['drop nx=200']['plain']}, {
        'name': 'fused_pair', 'route': 'cuda',
        'source': 'pysph_tpu_torch/csrc/fused_pair.cu',
        'replaces': 'pysph_tpu/ops/pallas_pair.py:47',
        'launches': fused_launches, 'max_abs_err': fused_err,
        'ms': fused_ms, 'plain_ms': fused_plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
