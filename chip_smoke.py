"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then not 0):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the eleven CUDA sources of ``pysph_tpu_torch/csrc`` (the nine
   pair and probe kernels, the source pack ``cell_pack`` and the binning
   ``bin_cells``) and the libraries of the later smoothing-kernel kinds
   (4-7, ``csrc/shapes.cuh``) of the five pair kernels that take kinds,
   with nvcc, one process per library, all in parallel, each one's
   seconds printed, and print ``-Xptxas -v``;
3. ``wcsph_pair`` against its plain torch version on the card, on the
   dam_break_3d state with a seeded velocity and density perturbation:
   dx=0.04 (24,672 particles) in float64 (scaled error <= 1e-10) and
   float32 (<= 1e-4 of max|ref|), and dx=0.02 (143,051 particles, the
   main path's shapes) in float32, where both are also timed (the kernel
   with its source pack, eagerly and replayed from a CUDA graph) and the
   work is counted (candidates and ``visited``); the pack of each call
   (``ops/cell_pack.py``) equal to its plain version, and timed; then 10
   steps of dam_break_3d
   at dx=0.04 in float64 on the kernel engine against the torch engine
   (<= 1e-9 of max|ref|); then each later kind (``WendlandQuinticC4``,
   ``WendlandQuinticC6``, ``SuperGaussian`` in 2D and 3D) in every pair
   kernel that takes kinds against its plain version in float64 and
   float32 (``tools_dev/kind_check.py``: the Taylor-Green vortex at nx=50
   under ``tvf``, ``gtvf``, ``wcsph`` on both engines and ``wcsph
   --delta-sph``, dam_break_3d at dx=0.04 on both engines and with
   ``--delta-sph``; 0 flipped accept decisions);
4. the solver's chunks (``tools_dev/time_chunks.py::gate``): on each of
   the paths in float64 at a small size (dam_break_3d dx=0.04, also
   with its fluid at 3 m/s so that the binning is rebuilt inside the
   chunks, with ``--delta-sph``, its strided ``m_mat`` and ``gradrho`` in
   the chunk's write-back, and with ``--engine dense --delta-sph``, whose
   delta-SPH groups run on the torch pair engine inside the graphs; GTVF
   dx=0.02; the 2D WCSPH dam break dx=0.02 under PEC and under Euler,
   TVDRK3, LeapFrog and PEFRL; the drop nx=40 in a grid that just holds
   it), 30
   steps with ``n_damp = 0`` in chunks of 10 replayed from CUDA graphs
   against the eager per-step loop: every prop within 1e-12 of its max,
   t, dt, the count and the binnings that ran exactly equal, one landing
   on an output time inside a chunk, one replay a chunk, and the drop's
   grid grown and its chunk captured again;
5. the main path: ``pysph_tpu_torch.examples.dam_break_3d`` at dx=0.02
   in float32 for ``STEPS`` steps (``_drive``), per step (``chunk_steps
   = 1``) and in chunks of 10 (50 damped steps, then chunks), each with
   its median ms/step (per step: host clock at each step's start, the
   card synchronised; in chunks: host clock after each chunk's read,
   over the chunks after the capture) and the kernel's and the pack's
   launches counted (in chunks: the eager ones, and those a capture
   counts x the replays), the binning's too (``bin_cells``: the reuse
   test once a step, and the binnings that ran), the captures, replays
   and host reads, and a finite final state; then ``bin_cells`` against
   its plain version on the run's final state (``tools_dev/bin_check.py``:
   forced, kept, stale but inactive, rebuilt, kept; every tensor of the
   handle exactly equal, and unchanged under the flag 0) and its time an
   eval in a CUDA graph, kept and rebuilt; the same run again under the
   reference's other binning configuration (``bin_every_eval`` on cells
   1.001 times the support, ``time_chunks.CONFIGS``), per step and in
   chunks; GTVF and the drops below are driven and checked the same way;
   then dam_break_3d ``--kernel WendlandQuinticC4`` (``wcsph_pair`` at
   kind 4, a library of its own): against its plain version at dx=0.02 in
   float32, timed there with its open-grid kernels' registers and spills,
   and the path as the main path under the binning reuse;
6. the delta-SPH dam break (``dam_break_3d --delta-sph``, the
   BASELINE's): ``delta_pair`` (the moment matrix and the corrected
   density gradient) and ``wcsph_pair``'s delta terms against their plain
   versions (``tools_dev/delta_check.py``) at dx=0.04 perturbed in
   float64 and float32, and at dx=0.02 on the path's state after its 50
   damped steps in float32, with the pairs whose accept decision differs
   counted, and the linked pair there (``delta_check.check_linked``: the
   moment launch's neighbour list equal to ``neighbours_reference``, the
   gradient launch that reads it equal to the walking one bit for bit,
   0 flips, one pack for the two; the dests past the list's capacity,
   its largest count and the capacity printed); timed there (the linked
   pair against the two walking launches of before the link and each
   launch alone, graph replays alternated in one process, and the
   fluid's ``wcsph_pair`` call with the delta terms against without
   them), the launches of one eval counted (2 ``delta_pair``, 3
   ``wcsph_pair``, 4 packs); then the path as the main path, under
   ``reuse`` only (3 ``wcsph_pair`` and 2 ``delta_pair`` launches an
   eval, a pack for each but the linked gradient, peak device memory);
   its chunks against the per-step loop in float64 are a gate of phase 4
   (``dam_break_3d dx=0.04 delta``); then ``--engine dense --delta-sph``
   at dx=0.02 in float32, its delta-SPH groups on the torch pair engine,
   for its 50 damped steps and 3 chunks per step and in captured chunks,
   with one overflow forced (the capacities cut before the first chunk):
   grown, redone and captured again;
7. ``gtvf_pair`` against its plain version on the GTVF dam break
   (``examples.dam_break_2d --scheme gtvf``) with a seeded perturbation,
   every phase set of both evaluators: dx=0.02 (7,603 particles) in
   float64 and float32, dx=0.004 (137,803 particles, the path's shapes)
   in float32, timed and counted there; infinities (``rhodiv`` next to
   the walls) must match exactly; the pack of each call (the GTVF planes)
   equal to its plain version; then 10 steps at dx=0.02 in float64 on
   the kernel engine against the torch engine (<= 1e-9 of max|ref|);
8. the GTVF path at dx=0.004 in float32, as the main path (chunks from
   step 0; 2 launches in the initial eval, 5 a step, one pack a launch),
   every pair phase of both evaluators on the kernel, and a finite final
   state (``rhodiv`` aside); then the 2D WCSPH dam break
   (``examples.dam_break_2d``'s default ``--scheme wcsph``: PEC,
   WendlandQuintic, the Hughes-Graham walls): ``wcsph_pair`` against its
   plain version with a seeded perturbation at dx=0.02 and dx=0.004
   (137,803 particles, the path's shapes) in float64 and float32, timed
   and counted at dx=0.004 in float32, and the path as the main path (50
   damped steps, then chunks; 2 launches in the initial eval, 2 a step);
   then Euler, TVDRK3, LeapFrog and PEFRL each driving its equations at
   dx=0.02 in float64 for 3 captured chunks, a capture counting 2
   ``wcsph_pair`` launches an eval (1, 3, 1 and 4 evals a step); then the
   Taylor-Green vortex (``examples.taylor_green``, ``--scheme tvf``: a
   box periodic in x and y, ``QuinticSpline``, PEC): ``tvf_pair``
   against its plain version on a seeded perturbation at nx=50 in
   float64 and float32 and at nx=400 (160,000 particles, the path's
   shapes) in float32, each also with a tenth of the particles on the
   box's edges and corners (``tools_dev/tvf_check.py``), timed and
   counted at nx=400; 10 steps at nx=50 (``--perturb 0.1``) in float64
   on the kernel engine against the torch engine; then the path at
   nx=400 as the main path under the binning reuse (2 launches in the
   initial eval, 2 a step, both pair groups on ``tvf_pair``), with
   max |v| against the exact decay and the L1 error of |v| after its 200
   steps; its chunks against the per-step loop in float64 are a gate of
   phase 4 (``taylor_green nx=40``, particles wrapping across the box);
   then the same vortex under ``--scheme wcsph`` (``WCSPHScheme`` with
   ``LaminarViscosity``, PEC: ``wcsph_pair``, and under ``--engine
   dense`` ``dense_pair``) and ``--scheme gtvf`` (``GTVFScheme`` without
   walls, with ``MomentumEquationViscosity``, two evaluators a step:
   ``gtvf_pair``), each kernel's periodic branch against its plain
   version on the path's calls (``tvf_check.calls``) at nx=50 in float64
   and float32, each also with a tenth of the particles on the box's
   edges and corners, and at nx=400 in float32, timed and counted there;
   the kernel engine against the torch engine at nx=50 from
   ``--perturb 0.1`` in float64 for 10 steps (<= 1e-9 of max|ref|); the
   path at nx=400 as the main path under the binning reuse (1 launch in
   the initial eval and 1 a step; ``gtvf``: 1 and 3), every dest on the
   kernel, with its decay held to the JAX package's for the same scheme,
   nx, steps and dtype (``JAX_DECAY``: max |v| over the exact decay
   within 1e-3 of the JAX figure, the L1 error of |v| within 5% of it);
   then the same for ``--scheme wcsph`` with each of ``--delta-sph``
   (``delta_pair``'s periodic branch, linked, twice an eval, with its
   accept decisions' flips counted and 0, and ``wcsph_pair`` with the
   delta terms and ``LaminarViscosityDeltaSPH``), ``--summation-density``
   (``wcsph_pair`` twice an eval: the density launch and the main one)
   and ``--tensile-correction`` (``wcsph_pair``'s tensile term); their
   chunks against the per-step loop are gates of phase 4
   (``taylor_green <scheme>[ <option>] nx=40``); then the Adami walls on
   ``tvf_pair`` (its no-slip term) and the TVF wall examples
   (``_tvf_wall_phase``): every pair kernel of their evals (each fluid's
   density and momentum on ``tvf_pair``, linked; the wall's velocity and
   pressure on ``gtvf_pair``) against its plain version on the cavity's
   open grid at nx=50 and Poiseuille's channel, periodic in x, in float64
   and float32, each also with a tenth of the fluid on its box's edges
   and corners, and on Rayleigh-Taylor and the periodic cylinders in
   float32, the linked pair bit for bit the walk on each; the cavity at
   nx=400 (160,000 fluid and 8,921 wall particles) in float32, timed
   there; the cavity at nx=400 as the main path under the binning reuse
   (every dest on a kernel, one linked pair, no dest past its list), its
   fluid's max speed and kinetic energy within 1e-3 of the JAX package's
   (``JAX_CAVITY``); Poiseuille's and Couette's flow to their tf = 100,
   their ``post_process`` error against the exact profile within 0.005
   of the JAX package's (``JAX_PROFILE``); Rayleigh-Taylor and the
   periodic cylinders as the main path; their chunks against the
   per-step loop are gates of phase 4 (``cavity nx=20``,
   ``poiseuille``);
9. ``wcsph_pair`` with the Gaussian kernel and ``dense_pair`` against
   their plain version on the elliptical drop (``examples.elliptical_drop``)
   with a seeded velocity and density perturbation: nx=40 (5,021
   particles) in float64 (scaled error <= 1e-10) and nx=200 (125,623,
   the path's shapes) in float32 (<= 1e-4); ``dense_pair`` also on
   dam_break_3d's calls at dx=0.04 in float64 and dx=0.02 in float32
   (three sources, 3D); both kernels and the pack on the walk's edge
   cases (``tools_dev/walk_cases.py``: a clamped cell longer than a
   ``dense_pair`` stage, a 2D grid, four sources, write masks, an empty
   dest array) in float64 and float32, and the bulk copy (``UBLKCP``) in
   ``dense_pair``'s SASS; ``dense_pair``, ``wcsph_pair`` and the plain
   version timed on identical calls at nx=200 and at dx=0.02, on cells
   1.1 and 1.001 times the support, with the candidates and
   ``dense_pair``'s passes;
10. ``fused_continuity_momentum`` (CubicSpline) against its plain version
   on the perturbed drop at nx=200 in float64 and float32, timed, and its
   pack (the fused planes) equal to its plain version; then,
   with its launches counted, m times its rates against ``wcsph_pair``'s
   Continuity + Momentum on the same state;
11. the elliptical drop at nx=200 in float32 under ``--engine kernel``
    (``wcsph_pair``) and ``--engine dense`` (``dense_pair``), as the main
    path (1 launch in the initial eval, 2 a step), every pair phase on the
    engine;
12. the physics gate: the drop at nx=40 in float64 to tf=0.0076 under
    ``--engine dense``, in chunks after its 50 damped steps, dumping into
    a temporary directory under ``build/``: max |y| within 3% of the exact
    semi-major axis, and ``post_process`` through the ported ``load``; the
    drop outgrows its initial cell grid, which must grow at least once and
    end with at most twice the stencil candidates of the start, and a grow
    after the first capture must capture the chunk again;
13. ``micro_launch`` against its plain version on the nine cases of
    ``tools_dev/micro_launch.py`` (seeded inputs, <= 1e-4 of max|ref|),
    then that tool's run (its path) with the launches counted, and the
    fluid dest phase case timed beside the plain version and
    ``embedding_bag``;
14. ``micro_engine`` against its plain version on ``fluid-full`` with
    ``dyn_maps`` both ways and 9 and 3 views, then the
    ``tools_dev/micro_engine.py`` run with the launches counted;
15. ``pair_stub`` in every mode on dam_break_3d dx=0.02's calls: every
    output exactly 0, global loads in the SASS of every mode but
    ``none``, each mode timed (``all`` must be slower than ``none``);
    then the ``tools_dev/prof_dma.py`` and ``prof_phases.py`` runs (its
    path) with the launches counted.

Each kernel's bound is computed from its work at the path's shapes
(``tools_dev/roofline.py``) and printed beside its time; a kernel's
``launches`` are those on the card in its path's run.  Then ms/step of
the full-width runs under both binning configurations, per step and
in chunks, with the chunked runs' captures, replays, host reads and
binnings per 100 steps, and the binning's times an eval.  The line
before the last is a JSON summary of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import functools
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import (
    EllipticalDrop, exact_solution)
from pysph_tpu_torch.examples.couette import CouetteFlow
from pysph_tpu_torch.examples.poiseuille import PoiseuilleFlow, profile_error
from pysph_tpu_torch.examples.taylor_green import TaylorGreen, decay_errors
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.ops import build, cell_pack, cell_walk
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.ops import pair_stub as stub
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops.pair_engine import PairSource
from pysph_tpu_torch.tools_dev import bin_check, delta_check
from pysph_tpu_torch.tools_dev import micro_engine as tool_engine
from pysph_tpu_torch.tools_dev import micro_launch as tool_launch
from pysph_tpu_torch.tools_dev import prof_dma, prof_phases, roofline
from pysph_tpu_torch.tools_dev import time_chunks, tvf_check, walk_cases
from pysph_tpu_torch.tools_dev import kind_check
from pysph_tpu_torch.tools_dev.common import (
    capture, events_ms, graph_ms, linked_calls)
from pysph_tpu_torch.tools_dev.time_walks import (
    delta_calls, drop_calls, fused_call, gtvf_calls, make_app, pair_calls)

STEPS = 200
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: the JAX package's Taylor-Green decay at nx=400 after STEPS steps in
#: float32 on the CPU (``python tests/jax_tg_decay.py --scheme <scheme>
#: --nx 400 --steps 200 [<the option's flags>]``), by scheme and option:
#: (max |v| over the exact decay of the start's max |v|, the L1 error of
#: |v|)
JAX_DECAY = {'wcsph': (1.000178380345958, 0.009089970207746673),
             'gtvf': (1.000495169086151, 0.009147097045272161),
             'wcsph delta': (0.9986821392914745, 0.008999829297085801),
             'wcsph summation': (1.000352147793546, 0.009079249251684698),
             'wcsph tensile': (1.0001777789107333, 0.009101093339999769)}
#: the JAX package's ``post_process`` error against the exact steady
#: profile (max |u - ue| over max |ue|) of Poiseuille's and Couette's
#: flow run as the examples define themselves (to tf = 100) in float32 on
#: the CPU (``python tests/jax_wall_figures.py poiseuille``, ``...
#: couette``); the port's bar is the JAX error plus PROFILE_SLACK
JAX_PROFILE = {'poiseuille': 0.006605376955121756,
               'couette': 0.0002688895328901708}
PROFILE_SLACK = 0.005
#: the JAX package's lid-driven cavity at nx=400 after STEPS steps in
#: float32 on the CPU (``python tests/jax_wall_figures.py cavity --nx 400
#: --steps 200``): the fluid's max speed and kinetic energy, which the
#: port's run must meet to CAVITY_TOL relative
JAX_CAVITY = (0.9328589499779117, 0.0033403797557614422)
CAVITY_TOL = 1e-3


def _compare(calls, dtype, label, op=None):
    """Max absolute and max scaled error of each kernel (``op``, else
    the plan's) against its plain version over every dest and output
    (on the entries where the plain version is finite; its infinities
    must be matched exactly); the plain version with torch's
    deterministic algorithms (``tvf_check.reference``)."""
    worst_abs = worst_scaled = 0.0
    for k, dest, plan, args in calls:
        got = (op or plan.op)(*args)
        ref = tvf_check.reference(plan, args)
        torch.cuda.synchronize()
        for p in ref:
            fin = torch.isfinite(ref[p])
            if not torch.equal(torch.isfinite(got[p]), fin) or \
                    not torch.equal(got[p][~fin].double(),
                                    ref[p][~fin].double()):
                raise AssertionError('%s eval %d %s.%s: non-finite entries '
                                     'differ' % (label, k, dest, p))
            d = float((got[p][fin].double() - ref[p][fin]).abs().max())
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


def _engines_agree(label, dx, steps, props, cls=DamBreak3D, extra=(),
                   engine='kernel'):
    """A path on a kernel engine (``engine``) against the same run on the
    plain torch engine, float64, after ``steps`` steps (non-finite
    entries must match exactly)."""
    runs = {}
    for e in (engine, 'torch'):
        app = make_app(dx, torch.float64, steps=steps, engine=e, cls=cls,
                       extra=extra)
        app.solve()
        runs[e] = app
    worst = 0.0
    for name, ref in runs['torch'].solver.states.items():
        got = runs[engine].solver.states[name]
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
    print('%s dx=%s float64, %d steps: %s engine against torch engine, '
          'max scaled err %.3g (tol 1e-09)' % (label, dx, steps, engine,
                                               worst), flush=True)


def _chunk_launches(solver, ops):
    """Record, for each chunk body ``solver`` runs, (steps, [launches of
    each of ``ops`` counted in it], whether it was being captured): the
    wrappers count Python calls, so a capture counts its chunk's
    launches once and a replay counts none.  Returns the list it fills."""
    rows = []
    body = solver._chunk_body

    def counted(iters):
        before = [op.launches for op in ops]
        capturing = torch.cuda.is_current_stream_capturing()
        body(iters)
        rows.append((iters, [op.launches - b for op, b in zip(ops, before)],
                     capturing))

    solver._chunk_body = counted
    return rows


def _drive(label, kw, ops, bins, skip_finite=(), engine='kernel',
           checks=(), config='reuse'):
    """A path at full width in float32 for ``STEPS`` steps under the
    binning configuration ``config`` (``time_chunks.CONFIGS``), per step
    (``chunk_steps = 1``) and in chunks (10, replayed from a CUDA graph),
    each timed by ``time_chunks.timed_solve`` (median ms/step: per step
    from the host clock at each step's start, the card synchronised; in
    chunks from the host clock after each chunk's read, over the chunks
    after the capture).  ``ops``: ((kernel wrapper, first, per_step[,
    packs a launch]), ...), the path's pair kernels (a launch packs once
    but where said: a linked ``delta_pair`` pair packs once).  Each one's
    launch count (and the source pack's and ``bin_cells``') is set to 0
    just before each run and read just after: per step, the initial eval
    launches it ``first`` and a step ``per_step`` times (``bin_cells``
    once and ``bins`` times: each reuse test); in chunks, the eager
    launches are the initial eval's, the damped steps' and one warm-up
    step a capture, each capture counts ``per_step`` x K (``bins`` x K),
    and the launches on the card are the eager ones plus those of a
    capture x replays (the pack as often as the pair kernels' launches
    times their packs a launch).  Every pair phase of every evaluator must be
    planned on ``engine``, the final state finite (``skip_finite`` aside)
    and each of ``checks`` pass (called with the chunked run's solver).
    Returns {launches: {kernel: launches}, bin_launches, particles, ms:
    {chunk steps: ms/step}, rebuilds: {chunk steps: binnings that ran},
    counters: the chunked run's solver counters, peak_mib: the chunked
    run's peak device memory, from a reset after a garbage collection}."""
    ms, rebuilds, counters, launches = {}, {}, None, {}
    wrappers = [o[0] for o in ops]
    pack_share = [o[3] if len(o) > 3 else 1 for o in ops]
    for k in (1, 10):
        app = time_chunks.configure(
            make_app(dtype=torch.float32, steps=STEPS, **kw), config)
        s = app.solver
        bodies = _chunk_launches(s, wrappers + [bc.bin_cells])
        for op in wrappers:
            op.launches = 0
        cell_pack.pack.launches = bc.bin_cells.launches = 0
        # the earlier runs' solvers sit in reference cycles (timed_solve)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms[k], samples = time_chunks.timed_solve(app, k)
        counted = [op.launches for op in wrappers]
        packs, binned = cell_pack.pack.launches, bc.bin_cells.launches
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        rebuilds[k] = s.rebuilds
        n = sum(st['x'].shape[0] for st in s.states.values())
        print('%s, %s, chunk_steps=%d: median %.3f ms/step (min %.3f, max '
              '%.3f over %d samples from step %d), %.4g particle-steps/s; %d '
              'captures, %d replays, %d reads, %d binnings of %d tests; '
              't=%.6g dt=%.6g; peak device memory %.1f MiB' % (
                  label, config, k, ms[k], min(samples), max(samples),
                  len(samples), time_chunks.WARMUP, n / ms[k] * 1e3,
                  s.captures, s.replays, s.reads, s.rebuilds,
                  1 + bins * STEPS, s.t, s.dt, peak_mib), flush=True)
        if k == 1:
            if s.captures or s.replays or bodies or s.count != STEPS or \
                    any(c != o[1] + o[2] * STEPS
                        for c, o in zip(counted, ops)) \
                    or binned != 1 + bins * STEPS:
                raise AssertionError('%s, chunk_steps=1: %s launches, %d '
                                     'bin_cells launches, %d chunks' % (
                                         label, counted, binned,
                                         len(bodies)))
            del app, s
            continue
        K = s.chunk_steps
        chunked = STEPS - s.n_damp
        nb = len(ops)
        bin_captured = [c[nb] for it, c, cap in bodies if cap]
        bin_warm = [c[nb] for it, c, cap in bodies if not cap]
        ok = (s.count == STEPS and s.captures and
              s.replays == -(-chunked // K))
        for q, (op, first, per_step, *_) in enumerate(ops):
            captured = [c[q] for it, c, cap in bodies if cap]
            warm = [c[q] for it, c, cap in bodies if not cap]
            eager = counted[q] - sum(captured)
            launches[op.__name__] = eager + per_step * K * s.replays
            print('%s launches: %d eager (initial eval %d, %d damped '
                  'steps, %d warm-up steps) + %d a capture (%d steps) x %d '
                  'replays = %d on the card; %d steps chunked, %d counted in '
                  '%d captures' % (
                      op.__name__, eager, first, s.n_damp, len(warm),
                      per_step * K, K, s.replays, launches[op.__name__],
                      chunked, sum(captured), len(captured)), flush=True)
            ok = ok and (len(captured) == s.captures and
                         set(captured) == {per_step * K} and
                         warm == [per_step] * s.captures and
                         eager == first + per_step * (s.n_damp +
                                                      s.captures))
        bin_eager = binned - sum(bin_captured)
        bin_launches = bin_eager + bins * K * s.replays
        print('bin_cells: %d eager + %d a capture x %d replays = %d'
              % (bin_eager, bins * K, s.replays, bin_launches), flush=True)
        if not (ok and set(bin_captured) == {bins * K} and
                bin_warm == [bins] * s.captures and
                bin_eager == 1 + bins * (s.n_damp + s.captures)):
            raise AssertionError('%s did not run every pair phase and '
                                 'reuse test through the kernels in its '
                                 'chunks: %s' % (label, bodies))
        want = sum(c * f for c, f in zip(counted, pack_share))
        print('cell_pack launches: %d eager and in captures, for %d pair '
              'kernel launches' % (packs, sum(counted)), flush=True)
        if packs != want:
            raise AssertionError('%s: %d pack launches, not %g' % (
                label, packs, want))
        for i, a_eval in enumerate(s.acceleration_evals):
            print('eval %d engine_choices: %s' % (i, a_eval.engine_choices))
            if set(a_eval.engine_choices.values()) != {engine}:
                raise AssertionError('a dest planned off the %s engine: %s'
                                     % (engine, a_eval.engine_choices))
        for name, st in s.states.items():
            for p, v in st.items():
                if p in skip_finite or not v.is_floating_point():
                    continue
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError('non-finite %s.%s after the run'
                                         % (name, p))
        for check in checks:
            check(s)
        counters = dict(captures=s.captures, replays=s.replays,
                        reads=s.reads, chunk_steps=K)
        del app, s
    print('%s, %s: %.3f ms/step per step, %.3f in chunks (%.2fx); %d and %d '
          'binnings in %d steps' % (label, config, ms[1], ms[10],
                                    ms[1] / ms[10], rebuilds[1],
                                    rebuilds[10], STEPS), flush=True)
    return dict(launches=launches, bin_launches=bin_launches, particles=n,
                ms=ms, rebuilds=rebuilds, counters=counters,
                peak_mib=peak_mib)


def _bin_phase(label, s, out):
    """``bin_cells`` against its plain version on the states the run of
    ``s`` ended with, the arrays of each evaluator (``bin_check.check``:
    exact, and unchanged under the flag 0), then its times an eval
    (``bin_check.times``), into ``out[label]``."""
    rows = []
    for i, a_eval in enumerate(s.acceleration_evals):
        used = {n: s.states[n] for n in a_eval.arrays_used}
        calls = bin_check.check(s.grid, used, seed=i,
                                label='%s eval %d' % (label, i))
        t = bin_check.times(s.grid, used)
        n = sum(st['x'].shape[0] for st in used.values())
        print('bin_cells %s eval %d after %d steps (%d particles in %d '
              'arrays, %d cells): exactly the plain version in %d calls, '
              'bitwise unchanged under the flag 0; kept %.4f ms, rebuilt '
              '%.4f ms in a graph, plain %.3f ms; bound kept %.4f ms (%s), '
              'rebuilt %.4f ms (%s)' % (
                  (label, i, STEPS, n, len(used), s.grid.ncells, calls,
                   t['kept_ms'], t['rebuilt_ms'], t['plain_ms']) +
                  roofline.bound(t['kept_work']) +
                  roofline.bound(t['rebuilt_work'])), flush=True)
        print('  rebuilt, by kernel (ms): %s' % ', '.join(
            '%s %.4f' % (k.split('(')[0].split(' ')[-1], v)
            for k, v in t['rebuilt_kernels'].items()), flush=True)
        rows.append(t)
    out[label] = rows


def _linked_times(op, calls, rounds=5, reps=20):
    """Median ms of CUDA graph replays of the linked pair of ``calls``
    (``op``'s emitting call, then its consuming call), of the two
    walking calls (each packing, as before the link), and of each launch
    alone (``consume`` on a hand-off emitted before; ``first walk`` and
    ``second walk`` the walking calls), the graphs' replays alternated
    over ``rounds`` rounds in this process; and the linked pair as a
    function."""
    ((_, _, _, first), (_, _, _, second)), = linked_calls(calls)
    _, held = op(*first, emit=True)
    fns = {
        'linked': lambda: op(*second, handoff=op(*first, emit=True)[1]),
        'walking': lambda: (op(*first), op(*second)),
        'emit': lambda: op(*first, emit=True),
        'consume': lambda: op(*second, handoff=held),
        'first walk': lambda: op(*first),
        'second walk': lambda: op(*second),
    }
    graphs = {k: capture(fn) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(events_ms(graph.replay, reps))
    del graphs, held
    return {k: float(np.median(v)) for k, v in times.items()}, fns['linked']


def _delta_packs(app):
    """(delta_pair launches, pack launches) of one eager eval of
    ``app``'s evaluator, and the pair launches of the wcsph_pair calls."""
    s = app.solver
    a_eval = s.acceleration_evals[0]
    handle, _ = a_eval.prepare(s.states)
    torch.cuda.synchronize()
    dl.delta_pair.launches = wp.wcsph_pair.launches = 0
    cell_pack.pack.launches = 0
    a_eval.compute(0.0, s.dt, s.states, handle)
    torch.cuda.synchronize()
    return (dl.delta_pair.launches, cell_pack.pack.launches,
            wp.wcsph_pair.launches)


def _delta_phase(runs, kernels):
    """dam_break_3d ``--delta-sph``: ``delta_pair`` and ``wcsph_pair``'s
    delta terms against their plain versions (``tools_dev/delta_check.py``:
    float64 and float32 at dx=0.04 perturbed, float32 at dx=0.02 on the
    path's state after its damped steps, the accept decisions' flips
    counted), and the linked pair there (``check_linked``: the moment
    call's neighbour list equal to ``neighbours_reference``, the
    consuming gradient call equal to the walking one bit for bit, 0
    flips, one pack), timed at dx=0.02 (``_linked_times``: the linked pair
    against the two walking launches, each launch alone), the pack
    launches of one eval counted, then the path (``_drive``, reuse
    only): 3 ``wcsph_pair`` and 2 ``delta_pair`` launches an eval, 4
    packs.  Adds the ``delta_pair`` entry and the delta terms of the
    ``wcsph_pair`` one."""
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n, _ = delta_calls(dx, dtype)
        what = 'dam_break_3d --delta-sph dx=%g %s (%d particles), ' \
            'perturbed' % (dx, str(dtype)[6:], n)
        delta_check.check(calls, what)
        delta_check.check_linked(calls, what)
        del calls
    label = 'dam_break_3d dx=0.02 delta'
    calls, n, app = delta_calls(0.02, torch.float32, steps=50)
    what = '%s float32 (%d particles) after its %d damped steps' % (
        label, n, app.solver.count)
    found = delta_check.check(calls, what)
    linked = delta_check.check_linked(calls, what)
    dcalls = [c for c in calls if c[2].op is dl.delta_pair]
    times, linked_fn = _linked_times(dl.delta_pair, calls)
    delta_ms = times['linked']
    delta_eager = events_ms(linked_fn, 20)
    delta_plain_ms = events_ms(
        lambda: [c[2].reference(*c[3]) for c in dcalls], 3)
    # the linked gradient tests no candidate: one walk's support tests
    ((_, _, _, margs), (_, _, _, gargs)), = linked_calls(calls)
    delta_work = roofline.add(roofline.delta_work(*margs),
                              roofline.delta_work(*gargs, walks=False))
    two_walks = _calls_work(dcalls, roofline.delta_work)
    print('delta_pair, the 2 pre-phases of one eval at dx=0.02 float32, '
          'graph replays alternated in this process: linked (emit + '
          'consume, one pack) %.4f ms, walking (2 walks, 2 packs) %.4f ms; '
          'alone: emit %.4f, consume %.4f, moment walk %.4f, gradient walk '
          '%.4f; linked eager %.3f, plain torch %.3f ms; bound %.4f ms (%s, '
          'one walk: %.4g flops); counted with two walks %.4f ms (%s, %.4g '
          'flops)' % (
              (delta_ms, times['walking'], times['emit'], times['consume'],
               times['first walk'], times['second walk'], delta_eager,
               delta_plain_ms) + roofline.bound(delta_work) +
              (delta_work['flops'],) + roofline.bound(two_walks) +
              (two_walks['flops'],)), flush=True)
    launches, packs, wcsph = _delta_packs(app)
    print('one eager eval of %s: %d delta_pair launches, %d wcsph_pair, %d '
          'pack launches (%d for the pre-phases)' % (
              label, launches, wcsph, packs, packs - wcsph), flush=True)
    if (launches, wcsph, packs) != (2, 3, 4):
        raise AssertionError('%s: %d delta_pair, %d wcsph_pair and %d pack '
                             'launches in one eval, not 2, 3 and 4' % (
                                 label, launches, wcsph, packs))
    # the delta terms: the fluid's wcsph_pair call with and without them
    tc = delta_check.terms_calls(calls)
    with_ms = graph_ms(lambda: [wp.wcsph_pair(*c[0]) for c in tc], 20)
    without_ms = graph_ms(lambda: [wp.wcsph_pair(*c[1]) for c in tc], 20)
    alone_ms = graph_ms(lambda: [wp.wcsph_pair(*c[2]) for c in tc], 20)
    plain_alone = events_ms(
        lambda: [wp.wcsph_pair_reference(*c[2]) for c in tc], 3)
    work_with = roofline.add(*[roofline.wcsph_work(*c[0]) for c in tc])
    work_without = roofline.add(*[roofline.wcsph_work(*c[1]) for c in tc])
    terms_work = {k: work_with[k] - work_without[k] for k in work_with}
    terms_bound, terms_by = roofline.bound(terms_work)
    print('wcsph_pair, the fluid call at dx=0.02 float32: %.3f ms in a graph '
          'with the delta terms, %.3f without, %.3f with them alone (plain '
          'torch %.3f ms); the terms\' bound %.4f ms (%s)' % (
              with_ms, without_ms, alone_ms, plain_alone, terms_bound,
              terms_by), flush=True)
    # the calls with the delta terms are one of the path's wcsph_pair calls
    terms_share = len(tc) / sum(c[2].op is wp.wcsph_pair for c in calls)
    del calls, dcalls, tc, app, linked_fn, margs, gargs
    runs[label, 'reuse'] = run = _drive(
        label, time_chunks.PATHS[label],
        ((wp.wcsph_pair, 3, 6), (dl.delta_pair, 2, 4, 0.5)), 1)
    kernels['delta_pair'] = _entry(
        'delta_pair', 'pysph_tpu/ops/resident.py:645',
        run['launches']['delta_pair'], found['by_kernel']['delta_pair'],
        delta_ms, delta_plain_ms, delta_work, None, eager_ms=delta_eager,
        share=roofline.bound(delta_work)[0] / delta_ms,
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'],
                               times['second walk']],
        two_walk_bound_ms=roofline.bound(two_walks)[0],
        flips=found['flips'] + linked['flips'],
        flipped_dests=found['flipped_dests'],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'],
        path='dam_break_3d --delta-sph dx=0.02 after the damped steps, one '
        'eval (2 launches, linked: the moment emits, the gradient consumes)')
    terms_ms = with_ms - without_ms
    kernels['wcsph_pair']['delta_terms'] = dict(
        launches=round(run['launches']['wcsph_pair'] * terms_share),
        max_abs_err=found['by_kernel']['wcsph_pair'], ms=terms_ms,
        alone_ms=alone_ms, plain_ms=plain_alone, bound_ms=terms_bound,
        bound_by=terms_by, share=terms_bound / terms_ms
        if terms_ms > 0 else None, work=terms_work,
        path='dam_break_3d --delta-sph dx=0.02, the fluid call with the '
        'terms less without them (ms), the terms alone (alone_ms, and '
        'the plain version\'s plain_ms)')


def _wcsph2d_phase(runs, kernels, bins):
    """The WCSPH dam break in 2D (``examples.dam_break_2d``, its default
    ``--scheme wcsph``: PEC, WendlandQuintic, the Hughes-Graham walls):
    ``wcsph_pair`` against its plain version with a seeded velocity and
    density perturbation, dx=0.02 (7,603 particles) in float64 and
    float32 and dx=0.004 (137,803, the path's shapes) in float64 and
    float32, timed and counted there; then the path as the main path (2
    launches in the initial eval, 2 a step: PEC evaluates once).  Adds
    the path's numbers to the ``wcsph_pair`` entry."""
    for dx, dtype in ((0.02, torch.float64), (0.02, torch.float32),
                      (0.004, torch.float64)):
        calls, n = pair_calls(dx, dtype, cls=DamBreak2D)
        _compare(calls, dtype, 'wcsph_pair dam_break_2d wcsph dx=%g %s (%d '
                 'particles)' % (dx, str(dtype)[6:], n))
        del calls
    calls, n = pair_calls(0.004, torch.float32, cls=DamBreak2D)
    if n != 137803:
        raise AssertionError('dam_break_2d at dx=0.004 has %d particles, '
                             'not 137,803' % n)
    err = _compare(calls, torch.float32, 'wcsph_pair dam_break_2d wcsph '
                   'dx=0.004 float32 (%d particles)' % n)
    eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    work = _calls_work(calls, roofline.wcsph_work)
    bound_ms, bound_by = roofline.bound(work)
    print('wcsph_pair, pair phases of one eval of dam_break_2d wcsph at '
          'dx=0.004 float32 (%d launches, the pack included): kernel %.3f '
          'ms eager, %.3f ms in a graph, plain torch %.3f ms; bound %.4f ms '
          '(%s); %d candidates, %d visited, %d pairs' % (
              len(calls), eager, ms, plain_ms, bound_ms, bound_by,
              work['candidates'], work['visited'], work['pairs']),
          flush=True)
    del calls
    label = 'dam_break_2d wcsph dx=0.004'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((wp.wcsph_pair, 2, 2),), 1,
            config=config, checks=() if every else (functools.partial(
                _bin_phase, label, out=bins),))
    kernels['wcsph_pair']['dam_break_2d_wcsph'] = dict(
        launches=runs[label, 'reuse']['launches']['wcsph_pair'],
        max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, work=work,
        path='dam_break_2d --scheme wcsph dx=0.004, one eval (2 launches)')


def _integrators_phase():
    """The WCSPH dam break's equations under each other integrator
    (``time_chunks.INTEGRATORS``: Euler, TVDRK3, LeapFrog, PEFRL; their
    chunks against the eager loop in float64 are gates of the chunk
    phase) at dx=0.02 in float64, 30 steps from ``n_damp = 0`` in 3
    captured chunks: the ``wcsph_pair`` launches a capture counts must be
    2 an eval, so the graph holds 1, 3, 1 and 4 evals a step."""
    for name, (_, evals) in time_chunks.INTEGRATORS.items():
        app = time_chunks.integrated(name)()
        app.setup(['--disable-output', '-q', '--use-double', '--device',
                   'cuda', '--dx', '0.02', '--max-steps', '30'])
        s = app.solver
        s.n_damp = 0
        bodies = _chunk_launches(s, [wp.wcsph_pair])
        app.solve()
        captured = [c[0] for it, c, cap in bodies if cap]
        print('%s on dam_break_2d wcsph dx=0.02 float64: %d steps, %d '
              'captures, %d replays; wcsph_pair launches a capture %s (%d '
              'evals a step); t=%.6g' % (
                  name, s.count, s.captures, s.replays, captured, evals,
                  s.t), flush=True)
        if s.count != 30 or s.captures != 1 or s.replays != 3 or \
                captured != [2 * evals * s.chunk_steps]:
            raise AssertionError('%s did not run its %d evals a step in '
                                 'captured chunks' % (name, evals))
        for name_, st in s.states.items():
            for p, v in st.items():
                if v.is_floating_point() and \
                        not bool(torch.isfinite(v).all()):
                    raise AssertionError('%s: non-finite %s.%s'
                                         % (name, name_, p))
        del app, s


def _tg_decay(out, solver, key='tvf'):
    """max |v| and the L1 error of |v| of the Taylor-Green run's final
    state against the exact decay (into ``out``); ``key``: the scheme and
    the option of the run.  ``tvf``: max |v|
    within 1% of the exact decay of the lattice's max |v| at t = 0, the
    L1 error below 2% of U (the pressure waves of the start, p = 0 from
    the summation density against the exact field's, hold it near 0.9%
    at t=0.011 at nx=64 and nx=100 in float32 on the CPU).  The others
    (``wcsph`` and its options, ``gtvf``): that ratio within 1e-3 of the
    JAX package's for the same run, the L1 error within 5% of its
    (``JAX_DECAY[key]``)."""
    st = {p: solver.states['fluid'][p].double().cpu().numpy()
          for p in 'xyuv'}
    vmax, exact, l1 = decay_errors(st['x'], st['y'], st['u'], st['v'],
                                   solver.t, 100.0)
    ratio = vmax / (out['vmax0'] * exact)
    out.update(t=solver.t, vmax=vmax, exact=exact, l1=l1, ratio=ratio)
    if key == 'tvf':
        bars = 'bar 1%; L1 bar 2e-2'
        ok = abs(ratio - 1.0) < 1e-2 and l1 < 2e-2
    else:
        jax_ratio, jax_l1 = JAX_DECAY[key]
        out.update(jax_ratio=jax_ratio, jax_l1=jax_l1)
        bars = 'JAX %.6f, bar 1e-3; JAX L1 %.4g, bar 5%%' % (jax_ratio,
                                                              jax_l1)
        ok = abs(ratio - jax_ratio) <= 1e-3 and \
            abs(l1 - jax_l1) <= 0.05 * jax_l1
    print('taylor_green %s nx=400 float32 at t=%.6g after %d steps: max|v| '
          '%.6f, exact decay of the start\'s %.6f: %.6f (ratio %.6f); L1 '
          'error of |v| %.4g (%s)' % (
              key, solver.t, solver.count, vmax, out['vmax0'],
              out['vmax0'] * exact, ratio, l1, bars), flush=True)
    if not ok:
        raise AssertionError('the Taylor-Green vortex (%s) missed its '
                             'decay' % key)


def _tvf_linked(s):
    """The Taylor-Green run of ``s`` ran its density and momentum plans
    linked, with no dest past the list's capacity (the counter reset
    before the run)."""
    plans = [p for a in s.acceleration_evals for p in a._plans.values()
             if p is not None]
    links = {id(p.link) for p in plans if p.link is not None}
    overflowed = tp.overflowed('cuda')
    print('taylor_green nx=400: %d linked tvf_pair pair, %d dests past the '
          'list\'s capacity in the runs' % (len(links), overflowed),
          flush=True)
    if len(plans) != 2 or len(links) != 1 or overflowed:
        raise AssertionError('the Taylor-Green run was not linked, or %d '
                             'dests overflowed its list' % overflowed)


def _tvf_phase(runs, kernels, bins):
    """The Taylor-Green vortex (``examples.taylor_green``, ``--scheme
    tvf``): ``tvf_pair`` against its plain version on its periodic grid
    (``tools_dev/tvf_check.py``: perturbed, and with a tenth of the
    particles on the box's edges and corners) at nx=50 in both dtypes
    and nx=400 in float32, and its linked pair on each of these calls
    (``tvf_check.check_linked``: the density launch's neighbour list
    equal to ``neighbours_reference``, both launches equal to the
    walking ones bit for bit and within ``TOL`` of the plain version,
    one pack each, no dest past the capacity but in the edge cases,
    whose corners stack particles; at nx=50 in float64 also with the
    capacity one short of the largest count and with capacity 1, so that
    some and then all warps walk); timed and counted at nx=400
    (``_linked_times``: the linked pair against the two walking
    launches, each launch alone, graph replays alternated) with each
    mode's registers and spills; the kernel engine against the torch
    engine at nx=50 in float64 for 10 steps, from a start perturbed by a
    tenth of dx (on the unperturbed
    lattice rounding alone moves ``auhat avhat`` by ~2e-9 of their max
    in 10 steps, as ``tools_dev/tg_conditioning.py`` shows; from this
    start, every prop by <= ~4e-13); then the path at nx=400 as the main
    path under the binning reuse (2 launches in the initial eval, 2 a
    step, linked, one pack each), with its decay against the exact one.
    Adds the ``tvf_pair`` entry."""
    for nx, dtype, edges in ((50, torch.float64, False),
                             (50, torch.float64, True),
                             (50, torch.float32, False),
                             (50, torch.float32, True),
                             (400, torch.float32, True)):
        calls, n, moved = tvf_check.calls(nx, dtype, edges)
        if not calls[0][3][5].is_periodic:
            raise AssertionError('the Taylor-Green grid is not periodic')
        what = 'taylor_green nx=%d %s%s (%d particles%s)' % (
            nx, str(dtype)[6:], ' edges' * edges, n,
            ', %d on the edges' % moved if edges else '')
        _compare(calls, dtype, 'tvf_pair ' + what)
        # the corners of the edge cases stack particles: their dests past
        # the capacity are counted and walk
        found = tvf_check.check_linked(calls, what, TOL[dtype])
        if found['overflowed'] and not edges:
            raise AssertionError('%s: %d dests past the list\'s capacity'
                                 % (what, found['overflowed']))
        if (nx, dtype, edges) == (50, torch.float64, False):
            for cap in (found['max_count'] - 1, 1):
                small = tvf_check.check_linked(
                    calls, '%s, capacity %d' % (what, cap), TOL[dtype],
                    capacity=cap)
                if not small['overflowed']:
                    raise AssertionError('%s: no dest past capacity %d'
                                         % (what, cap))
        del calls
    calls, n, _ = tvf_check.calls(400, torch.float32)
    if n != 160000:
        raise AssertionError('taylor_green at nx=400 has %d particles, not '
                             '160,000' % n)
    what = 'taylor_green nx=400 float32 (%d particles)' % n
    err = _compare(calls, torch.float32, 'tvf_pair ' + what)
    linked = tvf_check.check_linked(calls, what, TOL[torch.float32])
    if linked['overflowed']:
        raise AssertionError('%s: %d dests past the list\'s capacity'
                             % (what, linked['overflowed']))
    err = max(err, linked['max_abs_err'])
    for k, dest, _, args in calls:
        _check_pack('taylor_green nx=400 ' + dest, tp.pack_sources(args[4]),
                    tp.pack_sources_reference(args[4]))
    times, linked_fn = _linked_times(tp.tvf_pair, calls)
    eager = events_ms(linked_fn, 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    ((_, _, _, dargs), (_, _, _, margs)), = linked_calls(calls)
    # the consuming momentum call tests no candidate: one walk's tests
    work = roofline.add(roofline.tvf_work(*dargs),
                        roofline.tvf_work(*margs, walks=False))
    two_walks = _calls_work(calls, roofline.tvf_work)
    bound_ms, bound_by = roofline.bound(work)
    resources = tvf_check.resources(build.build('tvf_pair'))
    print('tvf_pair, the 2 launches of one eval of taylor_green at nx=400 '
          'float32 (grid %s, periodic %s), graph replays alternated in this '
          'process: linked (emit + consume, each packing) %.4f ms, walking '
          '(2 walks) %.4f ms; alone: emit %.4f, consume %.4f, density walk '
          '%.4f, momentum walk %.4f; linked eager %.3f, plain torch %.3f '
          'ms; bound %.4f ms (%s, one walk: %.4g flops, %d candidates, %d '
          'pairs); counted with two walks %.4f ms (%s, %.4g flops, %d '
          'candidates); %.1f candidates and %.1f pairs a particle a walk; '
          'registers and spill bytes (stores, loads) by mode: %s' % ((
              calls[0][3][5].dims, calls[0][3][5].periodic, times['linked'],
              times['walking'], times['emit'], times['consume'],
              times['first walk'], times['second walk'], eager, plain_ms,
              bound_ms, bound_by, work['flops'], work['candidates'],
              work['pairs']) + roofline.bound(two_walks) + (
              two_walks['flops'], two_walks['candidates'],
              work['candidates'] / n, work['pairs'] / (2.0 * n),
              resources)), flush=True)
    del calls, linked_fn, dargs, margs
    _engines_agree('taylor_green nx=50', None, 10,
                   ('x', 'y', 'u', 'v', 'rho', 'p', 'V', 'au', 'av',
                    'auhat', 'avhat'), cls=TaylorGreen,
                   extra=('--nx', '50', '--perturb', '0.1'))
    label = 'taylor_green nx=400'
    decay = dict(vmax0=1.0)
    start = make_app(None, torch.float32, cls=TaylorGreen,
                     extra=('--nx', '400')).solver.states['fluid']
    decay['vmax0'] = float(torch.sqrt(start['u'] ** 2 +
                                      start['v'] ** 2).max())
    del start
    tp.reset_overflow('cuda')
    runs[label, 'reuse'] = _drive(
        label, time_chunks.PATHS[label], ((tp.tvf_pair, 2, 2),), 1,
        checks=(functools.partial(_bin_phase, label, out=bins),
                functools.partial(_tg_decay, decay), _tvf_linked))
    kernels['tvf_pair'] = _entry(
        'tvf_pair', 'pysph_tpu/ops/resident.py:645',
        runs[label, 'reuse']['launches']['tvf_pair'], err, times['linked'],
        plain_ms, work, None, eager_ms=eager,
        share=bound_ms / times['linked'],
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'], times['second walk']],
        two_walk_bound_ms=roofline.bound(two_walks)[0],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'], resources=resources, decay=decay,
        path='taylor_green nx=400, one eval (2 launches, linked: the '
        'density emits, the momentum consumes)')


class TgRun(NamedTuple):
    """A Taylor-Green run of ``_tg_scheme_phase``: ``scheme`` on
    ``engine`` with the ``time_chunks.WCSPH_OPTIONS`` entry ``option``
    ('' for none); ``drive``: ``_drive``'s ops ((kernel wrapper, launches
    in the initial eval, a step[, packs a launch]), ...), the first the
    kernel whose periodic entry the run adds; ``bins``: reuse tests a
    step."""
    scheme: str
    engine: str
    option: str
    drive: tuple
    bins: int

    @property
    def flags(self):
        return time_chunks.WCSPH_OPTIONS[self.option] if self.option else ()

    @property
    def key(self):
        """The scheme and the option: ``JAX_DECAY``'s key."""
        return self.scheme + (' ' + self.option if self.option else '')

    @property
    def label(self):
        """Its ``time_chunks.PATHS`` label."""
        return 'taylor_green %s nx=400%s' % (
            self.key, ' dense' if self.engine == 'dense' else '')


#: the Taylor-Green vortex's other runs
TG_RUNS = (
    TgRun('wcsph', 'kernel', '', ((wp.wcsph_pair, 1, 1),), 1),
    TgRun('wcsph', 'dense', '', ((dp.dense_pair, 1, 1),), 1),
    TgRun('gtvf', 'kernel', '', ((gp.gtvf_pair, 1, 3),), 2),
    TgRun('wcsph', 'kernel', 'delta',
          ((dl.delta_pair, 2, 2, 0.5), (wp.wcsph_pair, 1, 1)), 1),
    TgRun('wcsph', 'kernel', 'summation', ((wp.wcsph_pair, 2, 2),), 1),
    TgRun('wcsph', 'kernel', 'tensile', ((wp.wcsph_pair, 1, 1),), 1),
)
#: by pair kernel: (its pack, the pack's plain version, its work count,
#: the TPU kernel it replaces, the mangled template flags after the kind
#: of its periodic instantiations on the runs' paths)
TG_KERNELS = {
    wp.wcsph_pair: (wp.pack_sources, wp.pack_sources_reference,
                    roofline.wcsph_work, 'pysph_tpu/ops/resident.py:645',
                    'ELb[01]ELb1ELb1E'),
    dp.dense_pair: (wp.pack_sources, wp.pack_sources_reference,
                    roofline.wcsph_work, 'pysph_tpu/ops/pallas_engine.py:574',
                    'ELb1ELb1E'),
    gp.gtvf_pair: (gp.pack_sources, gp.pack_sources_reference,
                   roofline.gtvf_work, 'pysph_tpu/ops/pallas_engine.py:1160',
                   'ELb1E'),
    dl.delta_pair: (dl.pack_sources, dl.pack_sources_reference,
                    roofline.delta_work, 'pysph_tpu/ops/resident.py:645',
                    r'ELi\dELb[01]ELb1E'),
}
#: the pair kernels that take a smoothing kernel's kind, each of whose
#: later kinds is a library of its own (``ops/build.py``)
KIND_KERNELS = ('tvf_pair', 'wcsph_pair', 'gtvf_pair', 'dense_pair',
                'delta_pair')
#: the props the engines must agree on, by scheme
TG_PROPS = {'wcsph': ('x', 'y', 'u', 'v', 'rho', 'p', 'arho', 'au', 'av'),
            'gtvf': ('x', 'y', 'u', 'v', 'rho', 'p', 'rhodiv', 'au', 'av',
                     'auhat', 'avhat')}


def _path_resources(op):
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    the ``QuinticSpline`` instantiations of the kernel of ``op`` with the
    periodic flag that the Taylor-Green runs launch, in its built library
    (``build.resources``)."""
    path = re.compile(op.__name__ + '_kernelI[fd]Li3' + TG_KERNELS[op][4])
    return {name.split('_pair_kernel')[-1]: res
            for name, res in sorted(build.resources(
                build.build(op.__name__)).items())
            if path.search(name)}


def _delta_run_linked(s):
    """The Taylor-Green ``--delta-sph`` run of ``s`` ran its two
    ``delta_pair`` plans linked, with no dest past the list's capacity
    (the counter reset before the run)."""
    plans = [p for a in s.acceleration_evals for p in a._plans.values()
             if p is not None and p.op is dl.delta_pair]
    links = {id(p.link) for p in plans if p.link is not None}
    overflowed = dl.overflowed('cuda')
    print('taylor_green wcsph --delta-sph nx=400: %d linked delta_pair '
          'pair, %d dests past the list\'s capacity in the runs'
          % (len(links), overflowed), flush=True)
    if len(plans) != 2 or len(links) != 1 or overflowed:
        raise AssertionError('the Taylor-Green --delta-sph run was not '
                             'linked, or %d dests overflowed its list'
                             % overflowed)


def _tg_kernel_times(op, calls):
    """(ms in a graph, eager ms, plain ms, work, the linked pair's times
    or None) of ``op``'s calls of one eval, as the path runs them."""
    mine = [c for c in calls if c[2].op is op]
    count = TG_KERNELS[op][2]
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in mine], 3)
    if not linked_calls(mine):
        eager = events_ms(lambda: [op(*c[3]) for c in mine], 20)
        ms = graph_ms(lambda: [op(*c[3]) for c in mine], 20)
        return ms, eager, plain_ms, _calls_work(mine, count), None
    times, linked_fn = _linked_times(op, mine)
    ((_, _, _, first), (_, _, _, second)), = linked_calls(mine)
    # the consuming call tests no candidate: one walk's tests
    work = roofline.add(count(*first), count(*second, walks=False))
    return (times['linked'], events_ms(linked_fn, 20), plain_ms, work,
            times)


def _tg_scheme_phase(runs, kernels, run):
    """The Taylor-Green vortex under another scheme or option
    (``TG_RUNS``): each kernel's periodic branch against its plain
    version on the path's calls (``tvf_check.calls``: perturbed, and with
    a tenth of the particles on the box's edges and corners; after one
    eval for ``--delta-sph``, whose ``delta_pair`` calls are also held by
    ``delta_check``: the flipped accept decisions counted and 0, the
    linked pair bit for bit the walk and its list
    ``neighbours_reference``'s) at nx=50 in both dtypes and at nx=400 in
    float32, the pack of each call exact, timed and counted at nx=400
    with the path's kernels' registers and spills; the kernel engine
    against the torch engine at nx=50 from ``--perturb 0.1`` in float64
    for 10 steps; then the path at nx=400 as the main path under the
    binning reuse, every dest on its kernel (the launch counts), with its
    decay against the JAX package's (``_tg_decay``).  Adds an entry
    ``<kernel> periodic[ <option>]`` for each of its kernels."""
    ops = [d[0] for d in run.drive]
    delta = dl.delta_pair in ops
    what = 'taylor_green --scheme %s%s%s' % (
        run.scheme, ''.join(' ' + f for f in run.flags),
        ' --engine dense' if run.engine == 'dense' else '')
    flips = 0
    for nx, dtype, edges in ((50, torch.float64, False),
                             (50, torch.float64, True),
                             (50, torch.float32, False),
                             (50, torch.float32, True),
                             (400, torch.float32, True)):
        calls, n, moved = tvf_check.calls(nx, dtype, edges, run.scheme,
                                          run.engine, run.flags, delta)
        if not all(c[3][5].is_periodic for c in calls) or \
                {c[2].op for c in calls} != set(ops):
            raise AssertionError('%s: calls off the periodic %s' % (
                what, [op.__name__ for op in ops]))
        label = '%s nx=%d %s%s (%d particles%s)' % (
            what, nx, str(dtype)[6:], ' edges' * edges, n,
            ', %d on the edges' % moved if edges else '')
        _compare(calls, dtype, label)
        if delta:
            flips += delta_check.check(calls, label)['flips']
            flips += delta_check.check_linked(calls, label)['flips']
        del calls
    if flips:
        raise AssertionError('%s: %d flipped accept decisions' % (what,
                                                                   flips))
    calls, n, _ = tvf_check.calls(400, torch.float32, False, run.scheme,
                                  run.engine, run.flags, delta)
    if n != 160000:
        raise AssertionError('taylor_green at nx=400 has %d particles, not '
                             '160,000' % n)
    errs = {}
    for op in ops:
        errs[op] = _compare([c for c in calls if c[2].op is op],
                            torch.float32, '%s %s nx=400 float32 (%d '
                            'particles)' % (op.__name__, what, n))
    if delta:
        found = delta_check.check(calls, what + ' nx=400')
        linked = delta_check.check_linked(calls, what + ' nx=400')
        if found['flips'] + linked['flips']:
            raise AssertionError('%s nx=400: flipped accept decisions'
                                 % what)
    for k, dest, plan, args in calls:
        pack, pack_reference = TG_KERNELS[plan.op][:2]
        _check_pack('%s nx=400 eval %d %s' % (what, k, dest),
                    pack(args[4]), pack_reference(args[4]))
    timed = {}
    for op in ops:
        ms, eager, plain_ms, work, linked = timed[op] = _tg_kernel_times(
            op, calls)
        name = op.__name__
        print('%s, its %d launches of one step\'s evals of %s at nx=400 '
              'float32 (grid %s, periodic %s; the pack included%s): kernel '
              '%.4f ms in a graph, %.4f eager, plain torch %.3f ms; bound '
              '%.4f ms (%s: %.4g flops, %d B); %d candidates, %d visited, '
              '%d pairs; registers and spill bytes (stores, loads) of the '
              'periodic QuinticSpline kernels: %s' % ((
                  name, sum(c[2].op is op for c in calls), what,
                  calls[0][3][5].dims, calls[0][3][5].periodic,
                  ', linked: the moment emits, the gradient consumes; alone '
                  '%.4f and %.4f, the two walking launches %.4f' % (
                      linked['emit'], linked['consume'], linked['walking'])
                  if linked else '', ms, eager, plain_ms) +
                  roofline.bound(work) + (
                      work['flops'], work['bytes'], work['candidates'],
                      work['visited'], work['pairs'], _path_resources(op))),
              flush=True)
    del calls
    _engines_agree('%s nx=50' % what, None, 10,
                   TG_PROPS[run.scheme], cls=TaylorGreen, engine=run.engine,
                   extra=('--nx', '50', '--perturb', '0.1', '--scheme',
                          run.scheme) + run.flags)
    kw = time_chunks.PATHS[run.label]
    start = make_app(None, torch.float32, **{
        k: v for k, v in kw.items() if k != 'dx'}).solver.states['fluid']
    decay = dict(vmax0=float(torch.sqrt(start['u'] ** 2 +
                                        start['v'] ** 2).max()))
    del start
    dl.reset_overflow('cuda')
    runs[run.label, 'reuse'] = _drive(
        run.label, kw, run.drive, run.bins, engine=run.engine,
        checks=(functools.partial(_tg_decay, decay, key=run.key),) + (
            (_delta_run_linked,) if delta else ()))
    for op in ops:
        ms, eager, plain_ms, work, linked = timed[op]
        name = op.__name__
        extra = {} if linked is None else dict(
            per_launch_ms=[linked['emit'], linked['consume']],
            walking_ms=linked['walking'], flips=flips)
        entry = '%s periodic%s' % (name, ' ' + run.option if run.option
                                   else '')
        kernels[entry] = dict(_entry(
            name, TG_KERNELS[op][3],
            runs[run.label, 'reuse']['launches'][name], errs[op], ms,
            plain_ms, work, None, eager_ms=eager,
            resources=_path_resources(op),
            decay=decay, path='%s nx=400, the %s calls of one step (%d '
            'launches)' % (what, name, next(d[2] for d in run.drive
                                            if d[0] is op)), **extra),
            name=entry)


#: the TVF wall examples' checks of ``_tvf_wall_phase``: (example, its
#: arguments, dtypes, with the edge particles too)
WALL_CHECKS = (
    ('cavity', ('--nx', '50'), (torch.float64, torch.float32), True),
    ('poiseuille', (), (torch.float64, torch.float32), True),
    ('rayleigh_taylor', (), (torch.float32,), False),
    ('periodic_cylinders', (), (torch.float32,), False),
)


def _tvf_linked_runs(label, fluids, out=None):
    """A check of a solver (``_drive``'s ``checks``): each of its
    ``fluids`` fluids ran its ``tvf_pair`` density and momentum plans
    linked, with no dest past the list's capacity in the runs (the
    counter reset before them); with ``out``, the dests past it are
    counted into ``out['overflowed']`` instead (their warps walk: a run
    whose particles cluster, as Rayleigh-Taylor's two phases do under
    one reference density)."""
    def check(s):
        plans = [p for a in s.acceleration_evals for p in a._plans.values()
                 if p is not None and p.op is tp.tvf_pair]
        links = {id(p.link) for p in plans if p.link is not None}
        overflowed = tp.overflowed('cuda')
        print('%s: %d linked tvf_pair pairs of %d plans, %d dests past the '
              'list\'s capacity in the runs' % (label, len(links),
                                                len(plans), overflowed),
              flush=True)
        if out is not None:
            out['overflowed'] = overflowed
        if len(plans) != 2 * fluids or len(links) != fluids or \
                any(p.link is None for p in plans) or \
                (overflowed and out is None):
            raise AssertionError('%s: not linked, or %d dests overflowed '
                                 'the list' % (label, overflowed))
    return check


def _cavity_figures(out, solver):
    """The cavity's fluid max speed and kinetic energy after its run,
    against the JAX package's same run (``JAX_CAVITY``, to
    ``CAVITY_TOL`` relative); into ``out``."""
    st = solver.states['fluid']
    u, v, m = (st[c].double() for c in ('u', 'v', 'm'))
    speed2 = u * u + v * v
    vmax, ke = float(speed2.max().sqrt()), float(0.5 * (m * speed2).sum())
    errs = (vmax / JAX_CAVITY[0] - 1.0, ke / JAX_CAVITY[1] - 1.0)
    out.update(t=solver.t, vmax=vmax, ke=ke, jax_vmax=JAX_CAVITY[0],
               jax_ke=JAX_CAVITY[1], rel_err=errs)
    print('cavity nx=400 float32 at t=%.6g after %d steps: fluid max speed '
          '%.7f (JAX %.7f, relative %.3g), kinetic energy %.7g (JAX %.7g, '
          'relative %.3g); bar %.0e' % (
              solver.t, solver.count, vmax, JAX_CAVITY[0], errs[0], ke,
              JAX_CAVITY[1], errs[1], CAVITY_TOL), flush=True)
    if not max(abs(e) for e in errs) <= CAVITY_TOL:
        raise AssertionError('the cavity missed the JAX package\'s run')


def _profile_run(example):
    """Poiseuille's or Couette's flow as the example defines itself (to
    its tf, float32, on the kernels, dumping into a temporary directory
    under ``build/``): the ``post_process`` error against the exact
    steady profile within ``PROFILE_SLACK`` of the JAX package's
    (``JAX_PROFILE``), every dest on a kernel, the fluid's pair linked
    with no dest past its capacity.  Returns what it measured."""
    cls = {'poiseuille': PoiseuilleFlow, 'couette': CouetteFlow}[example]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix=example + '_', dir=build.BUILD_DIR)
    try:
        app = cls()
        app.setup(['-q', '--device', 'cuda', '-d', out])
        s = app.solver
        tp.reset_overflow('cuda')
        tp.tvf_pair.launches = gp.gtvf_pair.launches = 0
        start = time.perf_counter()
        app.solve()
        secs = time.perf_counter() - start
        launches = (tp.tvf_pair.launches, gp.gtvf_pair.launches)
        _tvf_linked_runs(example, 1)(s)
        for name, st in s.states.items():
            if not all(bool(v.isfinite().all()) for v in st.values()
                       if v.is_floating_point()):
                raise AssertionError('%s: non-finite %s' % (example, name))
        if set(s.acceleration_evals[0].engine_choices.values()) != \
                {'kernel'}:
            raise AssertionError('%s: a dest off the kernels' % example)
        _, u, ue = app.post_process(app.info_filename)
        err = profile_error(u, ue)
        bar = JAX_PROFILE[example] + PROFILE_SLACK
        print('%s float32 to t=%.6g (%d steps, %.1f s, %.4f ms/step with '
              'dumps; %d captures, %d replays, %d reads; launches counted '
              'eager and a capture once: tvf_pair %d, gtvf_pair %d): '
              'post_process error against the exact profile %.5f, JAX\'s '
              '%.5f, bar %.5f' % (
                  example, s.t, s.count, secs, 1e3 * secs / s.count,
                  s.captures, s.replays, s.reads, launches[0], launches[1],
                  err, JAX_PROFILE[example], bar), flush=True)
        if not (abs(s.t - s.tf) <= 1e-6 * s.tf and err <= bar):
            raise AssertionError('%s missed the exact profile' % example)
        return dict(t=s.t, steps=s.count, s=secs, err=err,
                    jax_err=JAX_PROFILE[example], bar=bar)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _tvf_wall_phase(runs, kernels, bins):
    """The Adami walls on ``tvf_pair`` (its no-slip term, the ``WALL``
    instantiations) and the TVF wall examples.  Every pair kernel of the
    wall examples' evals (each fluid's density and momentum on
    ``tvf_pair``, the wall's velocity and pressure on ``gtvf_pair``)
    against its plain version (``tvf_check.wall_calls``: the fluids
    jittered and seeded, and with a tenth of them on their box's edges
    and corners, after one eval) on the cavity's open grid at nx=50 and
    Poiseuille's channel, periodic in x, in float64 and float32, and on
    Rayleigh-Taylor and the periodic cylinders in float32, with the
    linked pair on each (``tvf_check.check_linked``: its list, its bits
    against the walk, no dest past the capacity but in the edge cases);
    the cavity at nx=400 (160,000 fluid and 8,921 wall particles) the
    same in float32, timed there (the linked pair against the two
    walking launches and each launch alone, the wall's ``gtvf_pair``
    calls) with the open-grid kernels' registers and spills; then the
    cavity at nx=400 as the main path under the binning reuse (2
    ``tvf_pair`` and 2 ``gtvf_pair`` launches in the initial eval and a
    step, linked, no overflow), with its fluid's max speed and kinetic
    energy against the JAX package's (``JAX_CAVITY``); Poiseuille's and
    Couette's flow to their tf with the ``post_process`` error against
    ``JAX_PROFILE``; Rayleigh-Taylor (two linked pairs) and the periodic
    cylinders for ``STEPS`` steps as the main path, the dests past the
    list's capacity counted (Rayleigh-Taylor's phases, under one
    reference density, cluster: their warps walk).  Adds the entries
    ``tvf_pair wall`` and ``gtvf_pair wall``."""
    for example, extra, dtypes, with_edges in WALL_CHECKS:
        for dtype in dtypes:
            for edges in (False, True) if with_edges else (False,):
                calls, n, moved = tvf_check.wall_calls(example, dtype, edges,
                                                       extra)
                what = '%s%s %s%s (%d particles%s)' % (
                    example, ''.join(' ' + a for a in extra),
                    str(dtype)[6:], ' edges' * edges, n,
                    ', %d on the edges' % moved if edges else '')
                _compare(calls, dtype, 'tvf_pair/gtvf_pair ' + what)
                found = tvf_check.check_linked(calls, what, TOL[dtype])
                if found['overflowed'] and not edges:
                    raise AssertionError('%s: %d dests past the list\'s '
                                         'capacity' % (what,
                                                       found['overflowed']))
                del calls
    calls, n, _ = tvf_check.wall_calls('cavity', torch.float32, False,
                                       ('--nx', '400'))
    if n != 168921 or calls[0][3][5].is_periodic:
        raise AssertionError('the cavity at nx=400 has %d particles, not '
                             '168,921, or a periodic grid' % n)
    what = 'cavity nx=400 float32 (%d particles)' % n
    tvf = [c for c in calls if c[2].op is tp.tvf_pair]
    gtvf = [c for c in calls if c[2].op is gp.gtvf_pair]
    err = _compare(tvf, torch.float32, 'tvf_pair ' + what)
    gtvf_err = _compare(gtvf, torch.float32, 'gtvf_pair ' + what)
    linked = tvf_check.check_linked(calls, what, TOL[torch.float32])
    if linked['overflowed']:
        raise AssertionError('%s: %d dests past the list\'s capacity'
                             % (what, linked['overflowed']))
    err = max(err, linked['max_abs_err'])
    for k, dest, plan, args in calls:
        pack, ref = ((tp.pack_sources, tp.pack_sources_reference)
                     if plan.op is tp.tvf_pair else
                     (gp.pack_sources, gp.pack_sources_reference))
        _check_pack('cavity nx=400 ' + dest, pack(args[4]), ref(args[4]))
    times, linked_fn = _linked_times(tp.tvf_pair, tvf)
    eager = events_ms(linked_fn, 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in tvf], 3)
    ((_, _, _, dargs), (_, _, _, margs)), = linked_calls(tvf)
    work = roofline.add(roofline.tvf_work(*dargs),
                        roofline.tvf_work(*margs, walks=False))
    bound_ms, bound_by = roofline.bound(work)
    resources = tvf_check.resources(build.build('tvf_pair'), periodic=False)
    gtvf_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in gtvf], 20)
    gtvf_eager = events_ms(lambda: [c[2].op(*c[3]) for c in gtvf], 20)
    gtvf_plain = events_ms(lambda: [c[2].reference(*c[3]) for c in gtvf],
                           3)
    gtvf_work = _calls_work(gtvf, roofline.gtvf_work)
    print('tvf_pair, the 2 launches of one eval of the cavity at nx=400 '
          'float32 (grid %s, open; the wall a source of the momentum call, '
          'its no-slip term), graph replays alternated in this process: '
          'linked (emit + consume, each packing) %.4f ms, walking (2 walks) '
          '%.4f ms; alone: emit %.4f, consume %.4f, density walk %.4f, '
          'momentum walk %.4f; linked eager %.3f, plain torch %.3f ms; bound '
          '%.4f ms (%s, one walk: %.4g flops, %d candidates, %d pairs, %d '
          'B); share %.1f%%; registers and spill bytes (stores, loads) of '
          'the open-grid kernels by mode: %s' % ((
              calls[0][3][5].dims, times['linked'], times['walking'],
              times['emit'], times['consume'], times['first walk'],
              times['second walk'], eager, plain_ms, bound_ms, bound_by,
              work['flops'], work['candidates'], work['pairs'],
              work['bytes'], 100 * bound_ms / times['linked'], resources)),
          flush=True)
    print('gtvf_pair, the wall\'s 2 launches (SetWallVelocity, '
          'SolidWallPressureBC) of one eval of the cavity at nx=400 float32: '
          '%.4f ms in a graph, %.4f eager, plain torch %.3f ms; bound %.4f '
          'ms (%s); %d candidates, %d pairs' % ((
              gtvf_ms, gtvf_eager, gtvf_plain) + roofline.bound(gtvf_work) +
              (gtvf_work['candidates'], gtvf_work['pairs'])), flush=True)
    del calls, tvf, gtvf, linked_fn, dargs, margs
    label = 'cavity nx=400'
    figures = {}
    tp.reset_overflow('cuda')
    runs[label, 'reuse'] = _drive(
        label, time_chunks.PATHS[label],
        ((tp.tvf_pair, 2, 2), (gp.gtvf_pair, 2, 2)), 1,
        checks=(functools.partial(_bin_phase, label, out=bins),
                _tvf_linked_runs(label, 1),
                functools.partial(_cavity_figures, figures)))
    if runs[label, 'reuse']['particles'] != 168921:
        raise AssertionError('the cavity at nx=400 has %d particles'
                             % runs[label, 'reuse']['particles'])
    profiles = {example: _profile_run(example)
                for example in ('poiseuille', 'couette')}
    overflows = {}
    for label, fluids in (('rayleigh_taylor', 2), ('periodic_cylinders', 1)):
        tp.reset_overflow('cuda')
        overflows[label] = {}
        runs[label, 'reuse'] = _drive(
            label, time_chunks.PATHS[label],
            ((tp.tvf_pair, 2 * fluids, 2 * fluids), (gp.gtvf_pair, 2, 2)), 1,
            checks=(_tvf_linked_runs(label, fluids, overflows[label]),))
    launches = runs['cavity nx=400', 'reuse']['launches']
    kernels['tvf_pair wall'] = dict(_entry(
        'tvf_pair', 'pysph_tpu/ops/resident.py:645', launches['tvf_pair'],
        err, times['linked'], plain_ms, work, None, eager_ms=eager,
        share=bound_ms / times['linked'],
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'], times['second walk']],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'], resources=resources,
        cavity=figures, profiles=profiles, overflows=overflows,
        path='cavity nx=400, one eval (2 launches, linked: the density '
        'emits, the momentum with the no-slip wall consumes)'),
        name='tvf_pair wall')
    kernels['gtvf_pair wall'] = dict(_entry(
        'gtvf_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        launches['gtvf_pair'], gtvf_err, gtvf_ms, gtvf_plain, gtvf_work,
        None, eager_ms=gtvf_eager,
        path='cavity nx=400, the wall\'s 2 calls of one eval'),
        name='gtvf_pair wall')


def _kinds_phase():
    """Each later kind (``kind_check.NEW_KINDS``) in every pair kernel
    that takes kinds against its plain version, in both dtypes
    (``tools_dev/kind_check.py``: the Taylor-Green vortex at nx=50 under
    ``tvf``, ``gtvf``, ``wcsph`` on both engines and ``wcsph
    --delta-sph``, dam_break_3d at dx=0.04 on both engines and with
    ``--delta-sph``; 0 flipped accept decisions)."""
    for kernel in kind_check.NEW_KINDS:
        for dtype in (torch.float64, torch.float32):
            for label, f in kind_check.check(kernel, dtype).items():
                print('%s (kinds %s): max abs err %.3g, max scaled err '
                      '%.3g%s' % (label, f['kinds'], f['max_abs_err'],
                                  f['max_scaled_err'],
                                  '; %d linked pairs, %d flips' % (
                                      f['linked'], f['flips'])
                                  if 'flips' in f else ''), flush=True)


def _c4_phase(runs, kernels):
    """dam_break_3d with ``--kernel WendlandQuinticC4``: ``wcsph_pair`` at
    kind 4 against its plain version at dx=0.02 in float32 on the
    perturbed state (float64 and both engines at dx=0.04 are
    ``_kinds_phase``'s), timed there with its registers and spills; then
    the path as the main path under the binning reuse (3 launches in the
    initial eval, 6 a step).  Adds the ``wcsph_pair C4`` entry."""
    label = 'dam_break_3d dx=0.02 C4'
    flags = time_chunks.PATHS[label]['extra']
    calls, n = pair_calls(0.02, torch.float32, extra=flags)
    err = _compare(calls, torch.float32, 'wcsph_pair %s float32 (%d '
                   'particles)' % (label, n))
    eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    work = _calls_work(calls, roofline.wcsph_work)
    lib = build.build('wcsph_pair', build.kind_flags(4))
    resources = {name.split('_pair_kernel')[-1]: res
                 for name, res in sorted(build.resources(lib).items())
                 if 'Lb0ELb0ELb0E' in name}
    print('wcsph_pair, pair phases of one eval of %s float32 (the pack '
          'included): kernel %.3f ms eager, %.3f ms in a graph, plain torch '
          '%.3f ms; bound %.4f ms (%s); %d candidates, %d pairs; registers '
          'and spill bytes (stores, loads) of its open-grid kernels: %s' % ((
              label, eager, ms, plain_ms) + roofline.bound(work) + (
              work['candidates'], work['pairs'], resources)), flush=True)
    del calls
    runs[label, 'reuse'] = _drive(label, time_chunks.PATHS[label],
                                  ((wp.wcsph_pair, 3, 6),), 1)
    kernels['wcsph_pair C4'] = dict(_entry(
        'wcsph_pair', 'pysph_tpu/ops/resident.py:645',
        runs[label, 'reuse']['launches']['wcsph_pair'], err, ms, plain_ms,
        work, None, eager_ms=eager, resources=resources,
        path='%s, one eval (3 launches)' % label), name='wcsph_pair C4')


def _dense_delta_phase():
    """dam_break_3d ``--engine dense --delta-sph`` at dx=0.02 in float32:
    the delta-SPH groups on the torch pair engine, the boundary's on
    ``dense_pair``, for its 50 damped steps and 3 chunks, per step and in
    captured chunks, with ms/step both ways; in the chunked run the
    capacities are cut to half before the first chunk, so that it
    overflows and is redone: grown, captured again, replayed from the
    state before it (1 + redos captures, 3 + redos replays).  Returns
    {ms: {chunk steps: ms/step}, rebuilds: {chunk steps: binnings},
    counters: the chunked run's solver counters}."""
    label = 'dam_break_3d dx=0.02 dense delta'
    steps = 80
    ms, rebuilds, counters = {}, {}, {}
    for k in (1, 10):
        app = make_app(0.02, torch.float32, steps=steps, engine='dense',
                       extra=('--delta-sph',))
        s = app.solver
        if k == 10:
            run_chunk = s._run_chunk

            def cut_first():
                if s.count == s.n_damp and not s.redos:
                    for cap in s.grid.pair_caps.values():
                        cap.candidates //= 2
                        cap.pairs //= 2
                run_chunk()
            s._run_chunk = cut_first
        bodies = _chunk_launches(s, [dp.dense_pair])
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms[k], samples = time_chunks.timed_solve(app, k)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        rebuilds[k] = s.rebuilds
        caps = {'%s<-%s' % key: (c.candidates, c.pairs)
                for key, c in s.grid.pair_caps.items()}
        print('%s, chunk_steps=%d: median %.3f ms/step (min %.3f, max %.3f '
              'over %d samples); %d captures, %d replays, %d redos, %d '
              'reads; capacities (candidates, pairs) %s; engines %s; peak '
              'device memory %.1f MiB' % (
                  label, k, ms[k], min(samples), max(samples), len(samples),
                  s.captures, s.replays, s.redos, s.reads, caps,
                  s.acceleration_evals[0].engine_choices, peak), flush=True)
        if 'torch' not in s.acceleration_evals[0].engine_choices.values() \
                or s.count != steps:
            raise AssertionError('%s: no torch engine dest, or %d steps'
                                 % (label, s.count))
        if k == 10:
            captured = [c for it, c, cap in bodies if cap]
            if not (s.redos >= 1 and
                    s.captures == 1 + s.redos + s.grid.grows and
                    len(captured) == s.captures and
                    s.replays == 3 + s.redos):
                raise AssertionError('%s: %d captures, %d replays, %d redos '
                                     'in chunks' % (label, s.captures,
                                                    s.replays, s.redos))
            counters = dict(captures=s.captures, replays=s.replays,
                            redos=s.redos, reads=s.reads, chunk_steps=10)
        for name, st in s.states.items():
            for p, v in st.items():
                if v.is_floating_point() and \
                        not bool(torch.isfinite(v).all()):
                    raise AssertionError('non-finite %s.%s' % (name, p))
        del app, s
    print('%s: %.3f ms/step per step (eager), %.3f in captured chunks '
          '(%.2fx)' % (label, ms[1], ms[10], ms[1] / ms[10]), flush=True)
    return dict(ms=ms, rebuilds=rebuilds, counters=counters, steps=steps)


def _rhodiv(solver):
    rhodiv = solver.states['fluid']['rhodiv']
    if bool((rhodiv == -float('inf')).any()):
        raise AssertionError('rhodiv holds -inf')
    print('fluid rhodiv: %d inf, %d nan of %d (a boundary neighbour, whose '
          'rho0 is 0)' % (int(torch.isinf(rhodiv).sum()),
                          int(torch.isnan(rhodiv).sum()), rhodiv.numel()))


def _fused_check(nx, dtype):
    """``fused_continuity_momentum`` on the perturbed drop at ``nx``
    with CubicSpline: the kernel against its plain version (timed in
    float32), then, with its launches counted, m times its rates
    against ``wcsph_pair``'s Continuity + Momentum on the same state
    (pre = 0).  Returns (launches, max abs err, and in float32 the
    times and work)."""
    st, cells, grid, kw, app = fused_call(nx, dtype)
    n = st['x'].shape[0]
    tol = TOL[dtype]
    label = 'fused_pair nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
    _check_pack(label, [fp.pack(st, cells)], [fp.pack_reference(st, cells)])
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
    timed = None
    if dtype == torch.float32:
        timed = dict(
            eager_ms=events_ms(lambda: fp.fused_continuity_momentum(
                st, cells, grid, **kw), 20),
            ms=graph_ms(lambda: fp.fused_continuity_momentum(
                st, cells, grid, **kw), 20),
            plain_ms=events_ms(lambda: fp.fused_continuity_momentum_reference(
                st, cells, grid, **kw), 3),
            work=roofline.fused_work(st, cells, grid))
        print('fused_pair at nx=%d float32: kernel %.3f ms eager, %.3f ms '
              'in a graph, plain torch %.3f ms' % (
                  nx, timed['eager_ms'], timed['ms'], timed['plain_ms']),
              flush=True)

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
    return launches, worst, timed


def _candidates(solver):
    """Stencil candidates of the drop's fluid on the solver's grid."""
    cells = solver.grid.bin_all(solver.states)['fluid']
    return roofline.stencil(solver.grid, cells, cells)[0]


def _physics_gate():
    """The drop at nx=40 in float64 to tf=0.0076 on the dense engine:
    max |y| against the exact semi-major axis (3%), post_process through
    the ported load, and the cell grid grown with the drop."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix='elliptical_drop_', dir=build.BUILD_DIR)
    try:
        app = EllipticalDrop()
        app.setup(['--nx', '40', '--use-double', '--device', 'cuda',
                   '--engine', 'dense', '-q', '-d', out])
        s = app.solver
        dims, first = s.grid.dims, _candidates(s)
        start = time.perf_counter()
        app.solve()
        secs = time.perf_counter() - start
        last = _candidates(s)
        print('elliptical_drop nx=40: the cell grid grew %d times, %s -> '
              '%s; stencil candidates %d at the start, %d at the end '
              '(%.3gx; bar 2x); %d chunk captures, %d replays, %d reads'
              % (s.grid.grows, dims, s.grid.dims, first, last, last / first,
                 s.captures, s.replays, s.reads), flush=True)
        if s.grid.grows < 1 or last > 2 * first:
            raise AssertionError('the drop\'s cell grid did not grow with '
                                 'it')
        # a grow after the first capture captures the chunk again
        if not 2 <= s.captures <= 1 + s.grid.grows:
            raise AssertionError('%d captures for %d grows'
                                 % (s.captures, s.grid.grows))
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


def _entry(name, replaces, launches, err, ms, plain_ms, work, library_ms,
           **extra):
    """One kernel of the JSON line, with its bound from ``work``."""
    bound_ms, bound_by = roofline.bound(work)
    return dict(name=name, route='cuda',
                source='pysph_tpu_torch/csrc/%s.cu' % name,
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **extra,
                work=work)


def _calls_work(calls, count):
    return roofline.add(*[count(*c[3]) for c in calls])


def _check_close(label, got, ref):
    """Max abs error of ``got`` against ``ref``, within 1e-4 of
    max|ref| (float32 sums in another order)."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= TOL[torch.float32] * scale:
        raise AssertionError('%s: error %.3g > %.0e * %.3g'
                             % (label, err, TOL[torch.float32], scale))
    return err


def _micro_launch_phase():
    """``micro_launch`` against its plain version on the tool's nine
    cases (seeded inputs); the tool's run with the launches counted;
    the fluid dest phase case timed beside its plain version and
    ``embedding_bag``."""
    worst = 0.0
    for label, progs, views, tz, lanes, planes in tool_launch.CASES:
        src = tool_launch.make_src(tz, lanes, planes, 'cuda', seed=21)
        worst = max(worst, _check_close(
            'micro_launch ' + label, micro.micro_launch(src, progs, views),
            micro.micro_launch_reference(src, progs, views)))
    print('compare micro_launch, nine cases: max abs err %.3g (tol 1e-4 '
          'scaled)' % worst, flush=True)
    micro.micro_launch.launches = 0
    rows = tool_launch.main()
    torch.cuda.synchronize()
    launches = micro.micro_launch.launches
    if launches == 0:
        raise AssertionError('the micro_launch tool launched no kernel')
    label, progs, views, tz, lanes, planes = tool_launch.CASES[3]
    src = tool_launch.make_src(tz, lanes, planes, 'cuda', seed=21)
    n_blocks = src.shape[0]
    bags = (micro.launch_map(progs, views, n_blocks, 'cuda')[:, :, None] *
            planes + torch.arange(planes, device='cuda')).reshape(progs, -1)
    weight = src.view(n_blocks * planes, tz * lanes)

    def library():
        return torch.nn.functional.embedding_bag(bags, weight, mode='sum')

    _check_close('embedding_bag', library().view(progs, 1, tz, lanes)[
        ..., :micro.OUT_LANES], micro.micro_launch_reference(src, progs,
                                                             views))
    plain_ms = events_ms(
        lambda: micro.micro_launch_reference(src, progs, views), 5)
    library_ms = events_ms(library, 20)
    print('micro_launch %s: kernel %.4f ms (graph), plain torch %.4f ms, '
          'embedding_bag (every lane) %.4f ms' % (
              label, rows[3]['kernel_ms'], plain_ms, library_ms), flush=True)
    return _entry('micro_launch', 'tools_dev/micro_launch.py:39', launches,
                  worst, rows[3]['kernel_ms'], plain_ms,
                  roofline.micro_launch_work(src, progs, views), library_ms,
                  case=label, eager_ms=rows[3]['eager_ms'],
                  graph_ms=rows[3]['graph_ms'])


def _micro_engine_phase():
    """``micro_engine`` against its plain version on ``fluid-full`` with
    ``dyn_maps`` both ways and 9 and 3 views (seeded inputs); the tool's
    run with the launches counted."""
    worst = 0.0
    for dyn_maps in (True, False):
        for n_views in (9, 3):
            _, args, kw = tool_engine.make_case('fluid-full', 'cuda', seed=22)
            kw.update(dyn_maps=dyn_maps, n_views=n_views)
            worst = max(worst, _check_close(
                'micro_engine fluid-full %s' % kw,
                micro.micro_engine(*args, **kw),
                micro.micro_engine_reference(*args, **kw)))
    print('compare micro_engine fluid-full, dyn_maps both ways, 9 and 3 '
          'views: max abs err %.3g (tol 1e-4 scaled)' % worst, flush=True)
    micro.micro_engine.launches = 0
    rows = tool_engine.main([])
    torch.cuda.synchronize()
    launches = micro.micro_engine.launches
    if launches == 0:
        raise AssertionError('the micro_engine tool launched no kernel')
    _, args, kw = tool_engine.make_case('fluid-full', 'cuda', seed=22)
    plain_ms = events_ms(lambda: micro.micro_engine_reference(*args, **kw),
                         5)
    row = rows[0]
    print('micro_engine fluid-full: kernel %.4f ms (graph), plain torch '
          '%.4f ms' % (row['kernel_ms'], plain_ms), flush=True)
    return _entry('micro_engine', 'tools_dev/micro_engine.py:69', launches,
                  worst, row['kernel_ms'], plain_ms,
                  roofline.micro_engine_work(*args, **kw), None,
                  case='fluid-full', eager_ms=row['eager_ms'],
                  graph_ms=row['graph_ms'])


def _sass_counts(lib, opcode):
    """{kernel function: SASS lines holding ``opcode``} of a library."""
    cuobjdump = Path(build.nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split(':', 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def _sass_loads(lib):
    """{stub mode: global loads (LDG) in the float kernel's SASS}."""
    counts = _sass_counts(lib, 'LDG')
    return {mode: next(v for k, v in counts.items()
                       if 'pair_stub_kernelIfLi%dE' % k_mode in k)
            for k_mode, mode in enumerate(stub.MODES)}


def _check_pack(label, copies, refs):
    """The pack kernel's copies against its plain version's: exactly
    equal."""
    torch.cuda.synchronize()
    for k, (got, ref) in enumerate(zip(copies, refs)):
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError('%s: the packed copy of source %d differs '
                                 'from its plain version' % (label, k))


def _walk_cases(dense_lib):
    """``wcsph_pair``, ``dense_pair`` and the pack against their plain
    versions on the walk's edge cases (``tools_dev/walk_cases.py``: a
    clamped cell longer than a stage, a 2D grid, four sources, write
    masks, an empty dest array) in float64 and float32; then the bulk
    copy in ``dense_pair``'s SASS."""
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for case in walk_cases.CASES:
            args = walk_cases.make_case(case, 'cuda', dtype, seed=31)
            _check_pack('walk case ' + case, wp.pack_sources(args[4]),
                        wp.pack_sources_reference(args[4]))
            for op in (wp.wcsph_pair, dp.dense_pair):
                try:
                    worst = max(worst, walk_cases.check_kernel(
                        op, args, TOL[dtype]))
                except AssertionError as e:
                    raise AssertionError('walk case %s %s: %s'
                                         % (case, str(dtype)[6:], e)) from e
    print('compare wcsph_pair, dense_pair on the walk cases %s, float64 and '
          'float32: max scaled err %.3g (tol 1e-10, 1e-04); the pack exact'
          % (walk_cases.CASES, worst), flush=True)
    copies = {k: v for k, v in _sass_counts(dense_lib, 'UBLKCP').items()
              if 'dense_pair_kernel' in k}
    print('dense_pair SASS bulk copies (UBLKCP) by kernel: %s'
          % sorted(copies.values()))
    if not copies or min(copies.values()) == 0:
        raise AssertionError('dense_pair compiled without the bulk copy: %s'
                             % copies)


def _pair_stub_phase(lib):
    """``pair_stub`` in every mode on dam_break_3d dx=0.02's calls: exact
    zeros (pre set to 7), global loads in the SASS of every mode but
    ``none``, each mode timed; then the prof tools' run with the
    launches counted."""
    calls, n = pair_calls(0.02, torch.float32)
    calls = [c[:3] + (c[3][:3] + ({p: torch.full_like(v, 7.0) for p, v in
                                   c[3][3].items()},) + c[3][4:],)
             for c in calls]
    for mode in stub.MODES:
        for _, dest, _, args in calls:
            out = stub.pair_stub(*args, mode=mode)
            torch.cuda.synchronize()
            if not all(bool((v == 0).all()) for v in out.values()):
                raise AssertionError('pair_stub %s wrote a non-zero to %s'
                                     % (mode, dest))
    print('compare pair_stub, every mode, dam_break_3d dx=0.02 (%d '
          'particles): exact zeros' % n, flush=True)
    loads = _sass_loads(lib)
    print('pair_stub float SASS global loads by mode: %s' % loads)
    if not (loads['none'] == 0 < loads['dest'] < loads['all'] and
            loads['third'] > loads['dest']):
        raise AssertionError('pair_stub: the compiler dropped loads: %s'
                             % loads)
    times = {}
    for mode in stub.MODES:
        times[mode] = graph_ms(lambda: [stub.pair_stub(*c[3], mode=mode)
                                        for c in calls], 20)
        work = _calls_work(calls, functools.partial(roofline.stub_work,
                                                    mode))
        print('pair_stub %-5s one eval (3 launches): %.4f ms (graph); %.4g '
              'candidates, %.4g B, bound %.4f ms (%s)' % (
                  (mode, times[mode], work['candidates'], work['bytes']) +
                  roofline.bound(work)), flush=True)
    if not times['all'] > times['none']:
        raise AssertionError('pair_stub all (%.4f ms) is not slower than '
                             'none (%.4f ms)' % (times['all'],
                                                 times['none']))
    plain_ms = events_ms(lambda: [stub.pair_stub_reference(*c[3])
                                  for c in calls], 20)
    work = _calls_work(calls, functools.partial(roofline.stub_work, 'all'))
    del calls

    stub.pair_stub.launches = 0
    prof_dma.main(0.02)
    prof_phases.main(0.02)
    torch.cuda.synchronize()
    launches = stub.pair_stub.launches
    if launches == 0:
        raise AssertionError('the prof tools launched no pair_stub')
    print('pair_stub launches in the prof_dma and prof_phases runs: %d'
          % launches, flush=True)
    return _entry('pair_stub', 'tools_dev/prof_dma.py:105', launches, 0.0,
                  times['all'], plain_ms, work, None,
                  also_replaces='tools_dev/prof_phases.py:86', mode='all',
                  mode_ms=times)


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
    names = ('tvf_pair', 'wcsph_pair', 'gtvf_pair', 'dense_pair',
             'fused_pair', 'micro_launch', 'micro_engine', 'pair_stub',
             'cell_pack', 'bin_cells', 'delta_pair')
    # and each later kind's library of the pair kernels that take kinds
    jobs = [(n, ()) for n in names] + [
        (n, build.kind_flags(k)) for n in KIND_KERNELS
        for k in range(build.BASE_KINDS, build.KINDS)]

    def timed_build(job):
        t = time.perf_counter()
        return build.build(*job), time.perf_counter() - t

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(timed_build, jobs)))
    libs = {n: built[n, ()][0] for n in names}
    print('built %d libraries in %.1f s, all at once (%d nvcc in parallel); '
          'each one\'s seconds: %s' % (
              len(jobs), time.perf_counter() - t0, len(jobs), ', '.join(
                  '%s%s %.1f' % (n, ''.join(' ' + f for f in extra), sec)
                  for (n, extra), (_, sec) in built.items())), flush=True)
    for lib, _ in built.values():
        print(lib.with_suffix('.log').read_text().strip(), flush=True)
    kernels = {}

    # wcsph_pair against its plain version
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n = pair_calls(dx, dtype)
        _compare(calls, dtype, 'wcsph_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = pair_calls(0.02, torch.float32)
    wcsph_err = _compare(calls, torch.float32, 'wcsph_pair dx=0.02 float32 '
                         '(%d particles)' % n)
    wcsph_eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    wcsph_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    wcsph_plain_ms = events_ms(
        lambda: [c[2].reference(*c[3]) for c in calls], 3)
    wcsph_work = _calls_work(calls, roofline.wcsph_work)
    print('wcsph_pair, pair phases of one eval at dx=0.02 float32 (the pack '
          'included): kernel %.3f ms eager, %.3f ms in a graph, plain torch '
          '%.3f ms; %d candidates, %d visited' % (
              wcsph_eager, wcsph_ms, wcsph_plain_ms,
              wcsph_work['candidates'], wcsph_work['visited']), flush=True)
    # the source pack of each call: exact, and timed alone
    for _, dest, _, args in calls:
        _check_pack('dam_break_3d dx=0.02 ' + dest, wp.pack_sources(args[4]),
                    wp.pack_sources_reference(args[4]))
    pack_ms = graph_ms(lambda: [wp.pack_sources(c[3][4]) for c in calls], 20)
    pack_eager = events_ms(
        lambda: [wp.pack_sources(c[3][4]) for c in calls], 20)
    pack_plain_ms = events_ms(
        lambda: [wp.pack_sources_reference(c[3][4]) for c in calls], 20)
    pack_work = roofline.add(*[roofline.pack_work(c[3][4]) for c in calls])
    print('pack_sources, the 3 calls of one eval at dx=0.02 float32: exact; '
          '%.4f ms in a graph, %.4f eager, plain torch %.4f ms; %d B'
          % (pack_ms, pack_eager, pack_plain_ms, pack_work['bytes']),
          flush=True)
    del calls
    _engines_agree('dam_break_3d', 0.04, 10,
                   ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p'))

    # the chunks: captured against per-step in float64 on each path
    for case in time_chunks.GATES:
        print('chunk gate: %s' % json.dumps(time_chunks.gate(case)),
              flush=True)

    # the later kinds in every pair kernel that takes kinds
    _kinds_phase()

    # the main path, under both binning configurations: 3 launches in the
    # initial eval, 6 a step; the reuse test once a step (reuse) or at
    # both evals (every eval)
    runs, bins = {}, {}
    label = MAIN = 'dam_break_3d dx=0.02'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((wp.wcsph_pair, 3, 6),),
            2 if every else 1, config=config,
            checks=() if every else (functools.partial(
                _bin_phase, label, out=bins),))
    main_run = runs[MAIN, 'reuse']
    if main_run['particles'] != 143051:
        raise AssertionError('dam_break_3d at dx=0.02 has %d particles, '
                             'not 143,051' % main_run['particles'])
    wcsph_launches = pack_launches = main_run['launches']['wcsph_pair']
    kernels['wcsph_pair'] = _entry(
        'wcsph_pair', 'pysph_tpu/ops/resident.py:645', wcsph_launches,
        wcsph_err, wcsph_ms, wcsph_plain_ms, wcsph_work, None,
        eager_ms=wcsph_eager, path='dam_break_3d dx=0.02, one eval')
    kernels['cell_pack'] = dict(_entry(
        'cell_pack', 'pysph_tpu/ops/resident.py:331', pack_launches, 0.0,
        pack_ms, pack_plain_ms, pack_work, None, eager_ms=pack_eager,
        path='dam_break_3d dx=0.02, the 3 calls of one eval'),
        source='pysph_tpu_torch/csrc/cell_pack.cuh',
        note='the source pack, launched by the walks\' launch functions; '
        'its JAX counterpart, build_pack, is an XLA gather, not a '
        'pallas_call')
    main_bin = bins[MAIN][0]
    kernels['bin_cells'] = dict(_entry(
        'bin_cells', 'pysph_tpu/sph/acceleration_eval.py:857',
        main_run['bin_launches'], 0.0, main_bin['rebuilt_ms'],
        main_bin['plain_ms'], main_bin['rebuilt_work'], None,
        kept_ms=main_bin['kept_ms'],
        kept_bound_ms=roofline.bound(main_bin['kept_work'])[0],
        path='dam_break_3d dx=0.02 after %d steps, one eval rebuilt (ms) '
        'and kept (kept_ms)' % STEPS),
        note='the binning and its reuse test, one call of five gated '
        'kernels; its JAX counterpart, prepare_reuse and prepare, is XLA '
        'ops under a lax.cond, not a pallas_call')
    _c4_phase(runs, kernels)
    _delta_phase(runs, kernels)
    dense_delta = _dense_delta_phase()

    # gtvf_pair against its plain version
    for dx, dtype in ((0.02, torch.float64), (0.02, torch.float32)):
        calls, n = gtvf_calls(dx, dtype)
        _compare(calls, dtype, 'gtvf_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = gtvf_calls(0.004, torch.float32)
    gtvf_err = _compare(calls, torch.float32, 'gtvf_pair dx=0.004 float32 '
                        '(%d particles)' % n)
    for k, dest, _, args in calls:
        _check_pack('GTVF dx=0.004 eval %d %s' % (k, dest),
                    gp.pack_sources(args[4]),
                    gp.pack_sources_reference(args[4]))
    print('cell_pack, the GTVF planes of the 5 calls: exact', flush=True)
    gtvf_eager = gtvf_plain_ms = 0.0
    for k in (0, 1):
        mine = [c for c in calls if c[0] == k]
        kms = events_ms(lambda: [c[2].op(*c[3]) for c in mine], 20)
        pms = events_ms(lambda: [c[2].reference(*c[3]) for c in mine], 3)
        print('gtvf_pair, pair phases of eval %d (%d launches) at dx=0.004 '
              'float32: kernel %.3f ms, plain torch %.3f ms'
              % (k, len(mine), kms, pms), flush=True)
        gtvf_eager += kms
        gtvf_plain_ms += pms
    gtvf_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    gtvf_work = _calls_work(calls, roofline.gtvf_work)
    print('gtvf_pair, both evals (5 launches) at dx=0.004 float32: %.3f ms '
          'in a graph' % gtvf_ms, flush=True)
    del calls, mine
    _engines_agree('GTVF dam_break_2d', 0.02, 10,
                   ('x', 'y', 'u', 'v', 'rho', 'p', 'sigma', 'rhodiv',
                    'au', 'auhat', 'V'), cls=DamBreak2D,
                   extra=('--scheme', 'gtvf'))

    # the GTVF path: 2 launches in the initial eval (eval 0), 5 a step; a
    # reuse test for each evaluator a step either way (eval 0 keeps the
    # step's neighbours)
    label = 'GTVF dx=0.004'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((gp.gtvf_pair, 2, 5),), 2,
            skip_finite=('rhodiv',), config=config,
            checks=(_rhodiv,) + (() if every else (functools.partial(
                _bin_phase, label, out=bins),)))
    gtvf_launches = runs[label, 'reuse']['launches']['gtvf_pair']
    kernels['gtvf_pair'] = _entry(
        'gtvf_pair', 'pysph_tpu/ops/pallas_engine.py:1160', gtvf_launches,
        gtvf_err, gtvf_ms, gtvf_plain_ms, gtvf_work, None,
        eager_ms=gtvf_eager, path='GTVF dx=0.004, both evals of a step')

    # the 2D WCSPH dam break (PEC) and the other integrators
    _wcsph2d_phase(runs, kernels, bins)
    _integrators_phase()

    # the Taylor-Green vortex on its periodic box
    _tvf_phase(runs, kernels, bins)
    for run in TG_RUNS:
        _tg_scheme_phase(runs, kernels, run)

    # the Adami walls on tvf_pair and the TVF wall examples
    _tvf_wall_phase(runs, kernels, bins)

    # wcsph_pair (Gaussian) and dense_pair against their plain version on
    # the perturbed drop; dense_pair also on dam_break_3d's calls
    timed = {}     # the float32 calls at the paths' shapes
    for nx, dtype in ((40, torch.float64), (200, torch.float32)):
        calls, n, _ = drop_calls(nx, dtype)
        label = 'nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
        _compare(calls, dtype, 'wcsph_pair Gaussian drop ' + label)
        dense_err = _compare(calls, dtype, 'dense_pair drop ' + label,
                             dp.dense_pair)
    timed['drop nx=200'] = calls
    for dx, dtype in ((0.04, torch.float64), (0.02, torch.float32)):
        calls, n = pair_calls(dx, dtype)
        _compare(calls, dtype, 'dense_pair dam_break_3d dx=%g %s (%d '
                 'particles)' % (dx, str(dtype)[6:], n), dp.dense_pair)
    timed['dam_break_3d dx=0.02'] = calls
    # the same calls on cells 1.001 times the support (bin_every_eval's)
    timed['drop nx=200, cells 1.001'] = drop_calls(
        200, torch.float32, cell_slack=1.001)[0]
    timed['dam_break_3d dx=0.02, cells 1.001'] = pair_calls(
        0.02, torch.float32, cell_slack=1.001)[0]
    _walk_cases(libs['dense_pair'])
    times = {}
    for label, calls in timed.items():
        times[label] = t = {}
        for name, op in (('dense_pair', dp.dense_pair),
                         ('wcsph_pair', wp.wcsph_pair),
                         ('plain', wp.wcsph_pair_reference)):
            reps = 3 if name == 'plain' else 20
            t[name] = events_ms(lambda: [op(*c[3]) for c in calls], reps)
            if name != 'plain':
                t[name + ' graph'] = graph_ms(
                    lambda: [op(*c[3]) for c in calls], 20)
        t['work'] = _calls_work(calls, roofline.wcsph_work)
        print('pair phases of one eval, %s float32 (%d launches, the pack '
              'included): dense_pair %.3f ms eager, %.3f in a graph; '
              'wcsph_pair %.3f ms eager, %.3f in a graph; plain torch %.3f '
              'ms; bound %.4f ms (%s); %d candidates, %d visited (both '
              'walks)' % (
                  (label, len(calls), t['dense_pair'], t['dense_pair graph'],
                   t['wcsph_pair'], t['wcsph_pair graph'], t['plain']) +
                  roofline.bound(t['work']) +
                  (t['work']['candidates'], t['work']['visited'])),
              flush=True)
        tiles = passes = 0
        for c in calls:
            a, b = cell_walk.dense_passes(c[3][5], c[3][1])
            tiles, passes = tiles + a, passes + b
        print('  %s: cells %g times the support, %s; dense_pair %d tiles '
              'holding dests, %d passes (%.3f a tile)' % (
                  label, calls[0][3][5].cell_slack, calls[0][3][5].dims,
                  tiles, passes, passes / max(tiles, 1)), flush=True)
    del timed, calls

    # fused_continuity_momentum on the drop's state
    fused_launches = 0
    for dtype in (torch.float64, torch.float32):
        k, fused_err, fused = _fused_check(200, dtype)
        fused_launches += k
    kernels['fused_pair'] = _entry(
        'fused_pair', 'pysph_tpu/ops/pallas_pair.py:47', fused_launches,
        fused_err, fused['ms'], fused['plain_ms'], fused['work'], None,
        eager_ms=fused['eager_ms'], path='drop nx=200 state, one call')

    # the elliptical drop on both engines: 1 launch in the initial eval,
    # 2 a step; the binning checked on the kernel engine's run
    for engine, op in (('kernel', wp.wcsph_pair), ('dense', dp.dense_pair)):
        label = 'drop nx=200 ' + engine
        for config, (every, _) in time_chunks.CONFIGS.items():
            runs[label, config] = run = _drive(
                label, time_chunks.PATHS[label], ((op, 1, 2),),
                2 if every else 1, engine=engine, config=config,
                checks=(functools.partial(_bin_phase, label, out=bins),)
                if engine == 'kernel' and not every else ())
            if run['particles'] != 125623:
                raise AssertionError('the drop at nx=200 has %d particles, '
                                     'not 125,623' % run['particles'])
    dense_launches = runs['drop nx=200 dense', 'reuse']['launches'][
        'dense_pair']
    drop = times['drop nx=200']
    kernels['dense_pair'] = _entry(
        'dense_pair', 'pysph_tpu/ops/pallas_engine.py:574', dense_launches,
        dense_err, drop['dense_pair graph'], drop['plain'],
        drop['work'], None, eager_ms=drop['dense_pair'],
        path='drop nx=200, one eval')

    _physics_gate()

    # the probes and the stub: the tools' paths
    kernels['micro_launch'] = _micro_launch_phase()
    kernels['micro_engine'] = _micro_engine_phase()
    kernels['pair_stub'] = _pair_stub_phase(libs['pair_stub'])

    print('ms/step in this run, float32, per step / in chunks of 10, and '
          'binnings a 100 steps per step / in chunks, by binning '
          'configuration (captures, replays, reads of the chunked %d-step '
          'run):' % STEPS)
    for (label, config), r in runs.items():
        print('  %-22s %-10s %8.3f / %8.3f ms/step  %6.1f / %6.1f  (%s)' % (
            label, config, r['ms'][1], r['ms'][10],
            100.0 * r['rebuilds'][1] / STEPS,
            100.0 * r['rebuilds'][10] / STEPS, r['counters']))
    r = dense_delta
    print('  %-22s %-10s %8.3f / %8.3f ms/step  %6.1f / %6.1f  (%s; %d '
          'steps: 50 damped, 3 chunks)' % (
              'dam_break_3d dx=0.02 dense delta', 'reuse', r['ms'][1],
              r['ms'][10], 100.0 * r['rebuilds'][1] / r['steps'],
              100.0 * r['rebuilds'][10] / r['steps'], r['counters'],
              r['steps']))
    print('bin_cells an eval in a CUDA graph, kept / rebuilt:')
    for label, rows in bins.items():
        for i, t in enumerate(rows):
            print('  %-22s eval %d %8.4f / %8.4f ms; bound %.4f / %.4f ms; '
                  'plain %.3f ms' % (
                      label, i, t['kept_ms'], t['rebuilt_ms'],
                      roofline.bound(t['kept_work'])[0],
                      roofline.bound(t['rebuilt_work'])[0], t['plain_ms']))
    print('%-12s %8s %12s %12s %12s %12s %12s %10s %10s %8s' % (
        'kernel', 'launches', 'candidates', 'visited', 'pairs', 'flops',
        'bytes', 'bound ms', 'ms', 'share'))
    for e in kernels.values():
        w = e['work']
        print('%-12s %8d %12d %12s %12d %12d %12d %10.4f %10.4f %7.1f%% (%s)'
              % (e['name'], e['launches'], w['candidates'],
                 w.get('visited', '-'), w['pairs'], w['flops'], w['bytes'],
                 e['bound_ms'], e['ms'], 100 * e['bound_ms'] / e['ms'],
                 e['bound_by']))
    print(json.dumps({'kernels': list(kernels.values())}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
