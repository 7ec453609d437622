"""Variants of a linked pair's kernel on one card: the listed entries a
consuming lane has in flight (``-DLIST_BATCH``) and, for ``tvf_pair``,
the blocks an SM its launches ask for (``-DEMIT_BLOCKS``,
``-DCONSUME_BLOCKS``); and of ``iisph_solve``, the float32 blocks an SM
its launch bounds ask for (``-DIISPH_SOLVE_BLOCKS``); and of
``gsph_pair``, the blocks an SM its acceleration kernel's launch bounds
ask for (``-DGSPH_ACC_BLOCKS_F32``, ``-DGSPH_ACC_BLOCKS_F64``); and of
``adke_pair`` (``gasd_pair``'s ADKE sets), the lanes a dest and the
launch bounds (``-DADKE_LANES``, ``-DADKE_DENSITY_BLOCKS``,
``-DADKE_ACCEL_BLOCKS``, ``-DADKE_BLOCKS_F64``), beside the ADKE sets of
the commit before ``adke_pair``; and of ``crksph_pair``, the lanes a dest
and the launch bounds (``-DCRKSPH_LANES``, ``-DCRKSPH_BLOCKS``,
``-DCRKSPH_BLOCKS_F64``, each variant the 2D periodic kernels alone,
``-DCRKSPH_SWEEP``), and the accuracy test ``--scheme crksph`` in chunks
under this checkout and another (``crksph_steps``).

    python3 -m pysph_tpu_torch.tools_dev.list_batch [delta_pair|tvf_pair]
    python3 -m pysph_tpu_torch.tools_dev.list_batch iisph_solve
    python3 -m pysph_tpu_torch.tools_dev.list_batch gsph_pair
    python3 -m pysph_tpu_torch.tools_dev.list_batch adke_pair PARENT
    python3 -m pysph_tpu_torch.tools_dev.list_batch crksph_pair
    python3 -m pysph_tpu_torch.tools_dev.list_batch crksph_steps PARENT

(``PARENT``: a checkout of the commit before ``csrc/adke_pair.cu``, e.g.
``git archive <commit> | tar -x -C build/parent``.)

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
mode (``tvf_check.resources``).  ``iisph_solve``: the pressure group's
call of one evaluation of each IISPH run at its full width in float32
(``SOLVE_RUNS``: the Taylor-Green vortex at nx=400, the drop at nx=200,
the dam break at dx=0.004; ``iisph_check.calls``), 4, 5, 6 and 8
blocks; each
variant's sweeps and outputs must equal the default library's bit for
bit (``tmp_comp`` aside: its sums follow the grid, which the variant
sizes); the
solve is replayed from CUDA graphs, alternated as above, with each
variant's registers and spills (``iisph_check.solve_resources``).
``gsph_pair``: the accuracy test at 256^2 (``--scheme gsph``,
``gasd_check.calls``) in float32 and float64; each variant's
acceleration on the gradients' hand-off must equal the walking launch
bit for bit; then per dtype the consuming and the walking acceleration,
the emitting and the walking gradients are replayed, alternated as
above, with each variant's registers and spills.  ``adke_pair``: the
accuracy test at 256^2 (``--scheme adke``, ``gasd_check.calls``) in
float32 and float64, the variants of ``VARIANTS`` (the Gaussian alone,
``-DPAIR_KIND=2``) and first the baseline, ``PARENT``: the checkout's
``csrc/gasd_pair.cu`` built with this repo's ``gasd_pair`` flags and
launched for the two ADKE phase ids (a thread a dest, each source's terms
a pair, the image's division on every candidate, no FMA contraction);
each variant's pairs and counts
exactly the plain version's, its outputs within 1e-10 of max|ref| in
float64 and, in float32, within ``gasd_check.F32_ROUNDING_FACTOR`` times
the plain float32 version's error against the float64 one; then per
dtype each set's launch is replayed, alternated as above, with each
variant's registers and spills; then the accuracy test ``--scheme
adke`` at 256^2 in float32, 200 steps in chunks of 10
(``time_chunks.timed_solve``) under ``PARENT`` and under the
fastest variant in float32 (the two sets' medians summed), parent,
fastest, fastest, parent, one JSON line each: ms/step, a replayed step's
device busy ms, idle share and the ADKE launches' device ms a step.
``crksph_pair``: the accuracy test at 256^2 (``--scheme crksph``,
``crksph_check.calls``) in float32 and float64, the variants of
``VARIANTS`` (G = 1, 2, 4, 8 lanes a dest for every set, each at three
launch bounds); each variant's linked chain held to the plain version and
the walk, its list to ``neighbours_reference``
(``crksph_check.check_linked``) and its energy launch to the plain
version; then per dtype each of the six launches as the path runs it
(the number density emitting, the four reading a hand-off emitted
before, the energy walking) is replayed, alternated as above, with each
variant's registers and spills (``crksph_check.resources``), and one
JSON line a set and dtype names the fastest variant.  ``crksph_steps``:
the accuracy test ``--scheme crksph`` at 256^2 in float32, 200 steps in
chunks of 10, under the checkout ``PARENT`` and this one, parent, this,
this, parent, each in a process of its own (``PYTHONPATH``), one JSON
line each: ms/step, a replayed step's device busy ms and idle share.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops import iisph_solve as isv
from pysph_tpu_torch.tools_dev import (
    common, crksph_check, gasd_check, iisph_check, prof_chunk, time_chunks,
    tvf_check)
from pysph_tpu_torch.tools_dev.time_walks import delta_calls


def _tvf(batch, consume, emit=8, momentum=6):
    return ('-DLIST_BATCH=%d' % batch, '-DCONSUME_BLOCKS=%d' % consume,
            '-DEMIT_BLOCKS=%d' % emit, '-DMOMENTUM_BLOCKS=%d' % momentum)


def _gsph(f32, f64):
    return ('-DGSPH_ACC_BLOCKS_F32=%d' % f32,
            '-DGSPH_ACC_BLOCKS_F64=%d' % f64)


def _crksph(lanes, blocks, f64):
    """A ``crksph_pair`` variant: the 2D periodic kernels alone, ``lanes``
    a dest for every set, ``blocks`` an SM in float32 and ``f64`` in
    float64."""
    return ('-DCRKSPH_SWEEP', '-DCRKSPH_LANES=%d' % lanes,
            '-DCRKSPH_BLOCKS=%d' % blocks, '-DCRKSPH_BLOCKS_F64=%d' % f64)


def _adke(lanes, blocks=8, f64=4):
    """An ``adke_pair`` variant: the Gaussian alone, ``lanes`` a dest,
    ``blocks`` an SM for both sets in float32 and ``f64`` in float64."""
    return ('-DPAIR_KIND=2', '-DADKE_LANES=%d' % lanes,
            '-DADKE_DENSITY_BLOCKS=%d' % blocks,
            '-DADKE_ACCEL_BLOCKS=%d' % blocks, '-DADKE_BLOCKS_F64=%d' % f64)


#: the ADKE sweep's baseline: the sets of the commit before
#: ``csrc/adke_pair.cu`` (``_parent_library``)
PARENT = ('parent',)

#: the variants' flags by kernel (tvf_pair's built with 4, 5, 8, 6 by
#: default; gsph_pair's with 4, 2)
VARIANTS = {
    'delta_pair': [('-DLIST_BATCH=%d' % b,) for b in (1, 2, 4, 8)],
    'tvf_pair': [_tvf(b, c) for c in (4, 5, 6) for b in (1, 2, 4)] +
                [_tvf(4, c) for c in (3, 7, 8)] +
                [_tvf(4, 5, emit=e) for e in (4, 6)] +
                [_tvf(4, 5, momentum=m) for m in (4, 5)],
    'iisph_solve': [('-DIISPH_SOLVE_BLOCKS=%d' % b,) for b in (4, 5, 6, 8)],
    'gsph_pair': [_gsph(3, 2), _gsph(4, 2), _gsph(5, 2), _gsph(6, 2),
                  _gsph(4, 1)],
    'adke_pair': [PARENT] +
                 [_adke(g, b) for g in (1, 2, 4, 8) for b in (6, 8)] +
                 [_adke(8, 12, f64=6), _adke(8, 4, f64=2)],
    'crksph_pair': [_crksph(g, b, f) for g in (1, 2, 4, 8)
                    for b, f in ((4, 2), (6, 3), (8, 4))],
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


#: the IISPH runs of the solve's variants, at their full width
SOLVE_RUNS = {'taylor_green': 400, 'elliptical_drop': 200,
              'dam_break_2d': 0.004}


def _solve_variants(smi, variants, libs):
    """The solve's graph of each variant and run, and the variants'
    libraries, which the graphs' kernels need loaded."""
    name = 'iisph_solve'
    for v, lib in zip(variants, libs):
        print(json.dumps(dict(card=smi, kernel=name, flags=v,
                              resources=iisph_check.solve_resources(lib))),
              flush=True)
    runs = {}
    for run, size in SOLVE_RUNS.items():
        calls = iisph_check.calls(run, size, torch.float32, solve=True)[0]
        (_, _, _, args), = iisph_check.solve_calls(calls)
        runs[run] = (args,) + isv.iisph_solve(*args)
    own = build.EXTRA_FLAGS.get(name, ())
    graphs, held = {}, []
    try:
        for v in variants:
            _use(name, own, v)
            for run, (args, want, sweeps) in runs.items():
                got, k = isv.iisph_solve(*args)
                # tmp_comp's sums follow the grid, which the variant sizes
                if int(k) != int(sweeps) or any(
                        not torch.equal(got[p], want[p])
                        for p in isv.OUTPUTS[:-1]):
                    raise AssertionError('%s %s %s: the outputs differ from '
                                         'the default library\'s'
                                         % (name, v, run))
                graphs[v, run] = common.capture(
                    lambda args=args: isv.iisph_solve(*args))
            held.append(build._loaded[(name,)])
    finally:
        build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    return graphs, held


def _gsph_variants(smi, variants, libs, size=256):
    """The graphs of each ``gsph_pair`` variant's launches (see the
    module's docstring), and the variants' libraries and hand-offs, which
    the graphs need kept."""
    name = 'gsph_pair'
    for v, lib in zip(variants, libs):
        print(json.dumps(dict(card=smi, kernel=name, flags=v,
                              resources=gasd_check.resources(
                                  lib, kernel=name))), flush=True)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        calls = gasd_check.calls('accuracy_test_2d', size, dtype,
                                 extra=('--scheme', 'gsph'))[0]
        (g, a), = common.linked_calls(calls)
        runs[str(dtype)[6:]] = (g[3], a[3])
    own = build.EXTRA_FLAGS.get(name, ())
    graphs, held = {}, []
    try:
        for v in variants:
            _use(name, own, v)
            for tag, (first, second) in runs.items():
                _, handoff = gs.gsph_pair(*first, emit=True)
                walked = gs.gsph_pair(*second)
                got = gs.gsph_pair(*second, handoff=handoff)
                if any(not torch.equal(got[p], walked[p]) for p in walked):
                    raise AssertionError('%s %s %s: the consuming call '
                                         'differs from the walk'
                                         % (name, v, tag))
                held.append((build._loaded[(name,)], handoff))
                graphs[v, tag + ' consume'] = common.capture(
                    lambda h=handoff, a=second: gs.gsph_pair(*a, handoff=h))
                graphs[v, tag + ' walking acceleration'] = common.capture(
                    lambda a=second: gs.gsph_pair(*a))
                graphs[v, tag + ' emit'] = common.capture(
                    lambda a=first: gs.gsph_pair(*a, emit=True))
                graphs[v, tag + ' walking gradients'] = common.capture(
                    lambda a=first: gs.gsph_pair(*a))
    finally:
        build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    return graphs, held


#: the accuracy test's size of the ADKE sweep
ADKE_SIZE = 256


def _parent_library(root):
    """``csrc/gasd_pair.cu`` of the checkout ``root`` (the commit before
    ``csrc/adke_pair.cu``, whose phases 2 and 3 were the ADKE sets), built
    into ``build/`` with this repo's ``gasd_pair`` flags for the Gaussian
    alone."""
    src = Path(root) / 'pysph_tpu_torch' / 'csrc' / 'gasd_pair.cu'
    lib = build.BUILD_DIR / 'libgasd_pair-parent.so'
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.nvcc(), *build.flags('gasd_pair', ('-DPAIR_KIND=2',)),
         '-o', str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s%s' % (
            src, proc.stdout, proc.stderr))
    lib.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    return lib


class _AsAdke:
    """The parent's ``gasd_pair`` library under ``adke_pair``'s names, so
    that ``build.launch('adke_pair', ...)`` runs its ADKE sets: the same
    argument struct, the same phase ids."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        lib.gasd_pair_args_size.restype = ctypes.c_int
        if lib.gasd_pair_args_size() != ctypes.sizeof(gd._Args):
            raise RuntimeError('%s: argument struct is %d bytes in C and %d '
                               'in Python' % (path, lib.gasd_pair_args_size(),
                                              ctypes.sizeof(gd._Args)))
        self.adke_pair_launch = lib.gasd_pair_launch
        self.adke_pair_launch.argtypes = [ctypes.POINTER(gd._Args),
                                          ctypes.c_void_p]
        self.adke_pair_launch.restype = ctypes.c_int
        self.adke_pair_error_string = lib.gasd_pair_error_string
        self.adke_pair_error_string.argtypes = [ctypes.c_int]
        self.adke_pair_error_string.restype = ctypes.c_char_p


def _use_adke(own, v, parent):
    """Let the next ADKE launch run the variant ``v``: flags, or
    ``PARENT`` (the library ``parent``, an ``_AsAdke``)."""
    _use('adke_pair', own, () if v == PARENT else v)
    if v == PARENT:
        build._loaded[('adke_pair',)] = parent


def _adke_variants(smi, variants, libs, parent, size=ADKE_SIZE):
    """The graphs of each ``adke_pair`` variant's two launches by dtype
    (see the module's docstring), and the variants' libraries, which the
    graphs' kernels need loaded."""
    name = 'adke_pair'
    for v, lib in zip(variants, libs):
        print(json.dumps(dict(card=smi, kernel=name, flags=v,
                              resources=gasd_check.resources(
                                  lib, kernel='gasd_pair' if v == PARENT
                                  else name, sets=gasd_check.ADKE_SETS))),
              flush=True)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        calls = gasd_check.calls('accuracy_test_2d', size, dtype,
                                 extra=('--scheme', 'adke'))[0]
        for _, _, plan, args in calls:
            if plan.op is not gd.gasd_pair:
                continue
            ref = tvf_check.reference(plan, args + (True,))
            ref64 = None if dtype == torch.float64 else \
                tvf_check.reference(plan, gasd_check.double(args))
            what = 'density' if plan.sources[0].terms == gd.ADEN else \
                'accelerations'
            runs[str(dtype)[6:] + ' ' + what] = (plan, args, ref, ref64)
    own = build.EXTRA_FLAGS.get(name, ())
    graphs, held = {}, []
    try:
        for v in variants:
            _use_adke(own, v, parent)
            for tag, (plan, args, ref, ref64) in runs.items():
                got = gd.gasd_pair(*args, counts=True)
                torch.cuda.synchronize()
                if not torch.equal(got['nnbr'], ref['nnbr']):
                    raise AssertionError('%s %s %s: the pairs differ from '
                                         'the plain version\'s' % (
                                             name, v, tag))
                if ref64 is None:
                    for p in plan.outputs:
                        scale = max(float(ref[p].abs().max()), 1e-300)
                        err = float((got[p] - ref[p]).abs().max())
                        if not err <= 1e-10 * scale:
                            raise AssertionError('%s %s %s %s: error %.3g' % (
                                name, v, tag, p, err / scale))
                else:
                    gasd_check.against_float64(got, ref, ref64, plan.outputs,
                                               '%s %s %s' % (name, v, tag))
                graphs[v, tag] = common.capture(
                    lambda a=args: gd.gasd_pair(*a))
            held.append(build._loaded[(name,)])
    finally:
        build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    return graphs, held


def _adke_steps(smi, variants, parent, steps=200, chunk_steps=10):
    """The accuracy test ``--scheme adke`` at ``ADKE_SIZE`` in float32 in
    chunks under each of ``variants`` (flags or ``PARENT``) in turn: one
    JSON line each."""
    name = 'adke_pair'
    own = build.EXTRA_FLAGS.get(name, ())
    held = []
    try:
        for v in variants:
            _use_adke(own, v, parent)
            app = gasd_check.app('accuracy_test_2d', ADKE_SIZE,
                                 torch.float32, steps=steps,
                                 extra=('--scheme', 'adke'))
            gd.gasd_pair.adke_launches = 0
            ms, samples = time_chunks.timed_solve(app, chunk_steps)
            s = app.solver
            trace = prof_chunk.replay_gaps(s._graph)
            # adke_pair's kernels, or the parent's gasd_pair ADKE sets
            adke = sum(us for k, us in trace['busy'].items()
                       if 'adke' in k.lower()) / 1e3 / chunk_steps
            held.append((build._loaded[(name,)], app))
            print(json.dumps(dict(
                card=smi, kernel=name, flags=v, run='accuracy_test_2d adke '
                '%d float32, %d steps in chunks of %d' % (
                    ADKE_SIZE, steps, chunk_steps), ms_step=ms,
                min=min(samples), max=max(samples), samples=len(samples),
                busy_ms=(trace['span_us'] - trace['idle_us']) / 1e3 /
                chunk_steps, idle_share=trace['idle_us'] / trace['span_us'],
                adke_ms=adke, adke_launches=gd.gasd_pair.adke_launches,
                steps=s.count)), flush=True)
    finally:
        build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    return held


#: the default libraries that a sweep's set-up launches, built beside its
#: variants
PREBUILT = {'crksph_pair': ('crksph_pair', 'crk_solve', 'cell_pack',
                            'bin_cells')}

#: the accuracy test's size of the CRKSPH sweep
CRKSPH_SIZE = 256


def _crksph_variants(smi, variants, libs, size=CRKSPH_SIZE):
    """The graphs of each ``crksph_pair`` variant's six launches by dtype
    (see the module's docstring), and the variants' libraries and
    hand-offs, which the graphs need kept."""
    name = 'crksph_pair'
    for v, lib in zip(variants, libs):
        print(json.dumps(dict(card=smi, kernel=name, flags=v,
                              resources=crksph_check.resources(lib))),
              flush=True)
    runs = {str(dtype)[6:]: crksph_check.calls(
        'accuracy_test_2d', size, dtype)[0]
        for dtype in (torch.float32, torch.float64)}
    own = build.EXTRA_FLAGS.get(name, ())
    graphs, held = {}, []
    try:
        for v in variants:
            _use(name, own, v)
            for tag, calls in runs.items():
                tol = 1e-4 if tag == 'float32' else 1e-10
                label = '%s %s %s' % (name, ' '.join(v), tag)
                crksph_check.check_linked(calls, label, tol)
                crksph_check.check(calls[-1:], label, tol)
                links = crksph_check.chain(calls)
                (_, _, emitter, first) = links[0]
                handoff = emitter.op(*first, emit=True)[1]
                held.append((build._loaded[(name,)], handoff))
                graphs[v, tag + ' number density'] = common.capture(
                    lambda p=emitter, a=first: p.op(*a, emit=True))
                for _, _, plan, args in links[1:]:
                    graphs[v, '%s %s' % (tag, crksph_check.SET_NAMES[
                        plan.sources[0].terms])] = common.capture(
                            lambda p=plan, a=args: p.op(*a, handoff=handoff))
                (_, _, plan, args) = calls[-1]
                graphs[v, tag + ' energy'] = common.capture(
                    lambda p=plan, a=args: p.op(*a))
    finally:
        build.EXTRA_FLAGS[name] = own
        build._loaded.pop((name,), None)
    return graphs, held


def _fastest(smi, name, times):
    """One JSON line a graph tag (set and dtype): the variant of the
    least median."""
    for tag in dict.fromkeys(w for _, w in times):
        v, t = min(((v, t) for (v, w), t in times.items() if w == tag),
                   key=lambda vt: np.median(vt[1]))
        print(json.dumps(dict(card=smi, kernel=name, graph=tag, fastest=v,
                              ms=float(np.median(t)))), flush=True)


#: ``crksph_steps``' run in each checkout's process: the names it uses
#: are in every checkout since ``CRKSPHScheme`` came
_CRKSPH_RUN = """
import json, torch
import pysph_tpu_torch
from pysph_tpu_torch.tools_dev import gasd_check, prof_chunk, time_chunks
app = gasd_check.app('accuracy_test_2d', %d, torch.float32, steps=%d,
                     extra=('--scheme', 'crksph'))
ms, samples = time_chunks.timed_solve(app, 10)
trace = prof_chunk.replay_gaps(app.solver._graph)
print(json.dumps(dict(package=pysph_tpu_torch.__file__, ms_step=ms,
                      min=min(samples), max=max(samples),
                      samples=len(samples), steps=app.solver.count,
                      busy_ms=(trace['span_us'] - trace['idle_us']) / 1e4,
                      idle_share=trace['idle_us'] / trace['span_us'])))
"""


def _crksph_steps(smi, parent, steps=200):
    """The accuracy test ``--scheme crksph`` in chunks under ``parent``
    and this checkout, alternated (see the module's docstring)."""
    here = str(Path(__file__).resolve().parents[2])
    for tree in (parent, here, here, parent):
        # from the tree itself: `python -c` puts the working directory
        # first on the path
        tree = str(Path(tree).resolve())
        proc = subprocess.run(
            [sys.executable, '-c', _CRKSPH_RUN % (CRKSPH_SIZE, steps)],
            capture_output=True, text=True, cwd=tree,
            env=dict(os.environ, PYTHONPATH=tree))
        if proc.returncode != 0:
            raise RuntimeError('crksph_steps under %s:\n%s' % (
                tree, proc.stderr[-4000:]))
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(card=smi, kernel='crksph_pair', tree=tree,
                              run='accuracy_test_2d crksph %d float32, %d '
                              'steps in chunks of 10' % (CRKSPH_SIZE, steps),
                              **row)), flush=True)


def main(name='delta_pair', parent=None, rounds=7, reps=20):
    smi = common.require_cuda()
    if name == 'crksph_steps':
        return _crksph_steps(smi, parent)
    variants = VARIANTS[name]
    if name == 'adke_pair' and parent is None:
        raise SystemExit('adke_pair needs a checkout of the commit before '
                         'csrc/adke_pair.cu (see the module\'s docstring)')

    def built(v):
        return _parent_library(parent) if v == PARENT else \
            build.build(name, v)

    with ThreadPoolExecutor(len(variants) + len(PREBUILT.get(name, ()))) \
            as pool:
        # the libraries the runs' set-up launches, beside the variants
        pre = [pool.submit(build.build, n) for n in PREBUILT.get(name, ())]
        libs = list(pool.map(built, variants))
        for lib in pre:
            lib.result()
    if name == 'adke_pair':
        as_adke = _AsAdke(libs[0])
        graphs, _held = _adke_variants(smi, variants, libs, as_adke)
        times = _report(smi, name, graphs, rounds, reps)

        def f32(v):
            return sum(np.median(t) for (w, tag), t in times.items()
                       if w == v and tag.startswith('float32'))
        fastest = min(variants[1:], key=f32)
        _held.append(_adke_steps(smi, [PARENT, fastest, fastest, PARENT],
                                 as_adke))
        return
    if name == 'crksph_pair':
        graphs, _held = _crksph_variants(smi, variants, libs)
        _fastest(smi, name, _report(smi, name, graphs, rounds, reps))
        return
    if name in ('iisph_solve', 'gsph_pair'):
        variants_of = {'iisph_solve': _solve_variants,
                       'gsph_pair': _gsph_variants}[name]
        graphs, _held = variants_of(smi, variants, libs)
        _report(smi, name, graphs, rounds, reps)
        return
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
    _report(smi, name, graphs, rounds, reps)


def _report(smi, name, graphs, rounds, reps):
    """Each graph's median ms of ``reps`` replays over ``rounds`` rounds,
    all alternated, one JSON line each."""
    times = {k: [] for k in graphs}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(common.events_ms(graph.replay, reps))
    for (v, what), t in times.items():
        print(json.dumps(dict(card=smi, kernel=name, flags=v, graph=what,
                              ms=float(np.median(t)), min=min(t),
                              max=max(t))), flush=True)
    return times


if __name__ == '__main__':
    main(*sys.argv[1:3])
