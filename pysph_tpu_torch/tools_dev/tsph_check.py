"""TSPH's pair calls, for the card: ``tsph_pair``'s three sets and
``tsph_sweep`` on the accuracy test, the hydrostatic box, Sedov's blast
and Cheng-Shu's wave under ``--scheme tsph``.

``RUNS``: ``examples/gas_dynamics/accuracy_test_2d.py`` (2D periodic,
``--nparticles``), ``hydrostatic_box.py`` (2D periodic, ``--nx``),
``sedov.py`` (2D open, ``--nx``) and ``cheng_shu_1d.py`` (1D periodic,
``--n-particles``).  ``app(run, size, dtype, steps=0, device='cuda',
extra=())``: the run's application set up under ``--scheme tsph`` (with
the further arguments ``extra``).  ``calls(run, size, dtype, steps=1,
device='cuda')``: (calls, particles, app): the three ``tsph_pair`` calls
of one evaluation (the density set, the velocity gradient, the momentum;
``time_walks.plan_calls``, each walking) on the run's start, jittered
(``gasd_check.jitter``), after ``steps`` steps and one evaluation.
``check(calls, label, tol)``: each call's kernel against its plain
version (torch's deterministic algorithms on the card): every output
within ``tol`` of max|ref| and each dest's pairs in support equal;
returns the largest errors, by set too.  ``sweep_start(run, size, dtype,
steps)``: ``gasd_check.sweep_start`` of a TSPH run, whose
``check_sweep`` and ``sweep_times`` then hold ``tsph_sweep`` to its plain
version, its list to ``neighbours_reference`` and both readers of the
list (the velocity gradient and the momentum) to their walks, and time
them.  ``set_times(calls)``: each set's kernel in a CUDA graph, eagerly
and its plain version, with its bound (``roofline.tsph_work``).
``resources(lib)``: registers and spill bytes by dtype, dimension, grid,
set and mode.  ``chip_smoke.py`` and ``tests/test_torch_tsph_cuda.py``
use them; on CPU tensors the kernels are their plain versions.
"""

import re

import torch

from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
    AccuracyTest2D)
from pysph_tpu_torch.examples.gas_dynamics.cheng_shu_1d import ChengShu
from pysph_tpu_torch.examples.gas_dynamics.hydrostatic_box import (
    HydrostaticBox)
from pysph_tpu_torch.examples.gas_dynamics.sedov import SedovPointExplosion
from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.tools_dev import gasd_check, roofline
from pysph_tpu_torch.tools_dev.common import events_ms, graph_ms
from pysph_tpu_torch.tools_dev.time_walks import plan_calls
from pysph_tpu_torch.tools_dev.tvf_check import reference

#: {run: (application class, size argument)}
RUNS = {'accuracy_test_2d': (AccuracyTest2D, '--nparticles'),
        'hydrostatic_box': (HydrostaticBox, '--nx'),
        'sedov': (SedovPointExplosion, '--nx'),
        'cheng_shu_1d': (ChengShu, '--n-particles')}
SET_NAMES = {ts.SDEN: 'density', ts.GRADV: 'velocity gradient',
             ts.MOM: 'momentum'}


def app(run, size, dtype, steps=0, device='cuda', extra=()):
    """``run``'s application at ``size`` on ``device`` under ``--scheme
    tsph`` (``extra`` may name another scheme)."""
    cls, arg = RUNS[run]
    argv = ['--disable-output', '-q', '--device', device, arg, str(size)]
    if '--scheme' not in extra:
        argv += ['--scheme', 'tsph']
    argv += list(extra)
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    a = cls()
    a.setup(argv)
    return a


def calls(run, size, dtype, steps=1, device='cuda'):
    """(calls, particles, app): the ``tsph_pair`` calls of one evaluation
    of ``run`` at ``size``, after ``steps`` steps and one evaluation of
    its jittered start."""
    a = app(run, size, dtype, steps=steps, device=device)
    s = a.solver
    gasd_check.jitter(s)
    if steps:
        s.solve()
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, [0]), n, a


def check(calls_, label, tol):
    """Each call's kernel against its plain version: raises where an
    output passes ``tol`` of max|ref| or a dest's pair count differs.
    Returns the largest absolute and scaled errors (``by_set`` too) and
    the pairs in support of all the calls."""
    worst_abs = worst = 0.0
    pairs = 0
    by_set = {}
    failures = []
    for _, dest, plan, args in calls_:
        got = plan.op(*args, counts=True)
        ref = reference(plan, args + (True,))
        if args[0]['x'].is_cuda:
            torch.cuda.synchronize()
        name = SET_NAMES[plan.sources[0].terms]
        for p in plan.outputs:
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p].double() - ref[p].double()).abs().max())
            if not err <= tol * scale:
                failures.append('%s %s %s.%s: error %.3g > %.0e * %.3g' % (
                    label, name, dest, p, err, tol, scale))
            worst_abs = max(worst_abs, err)
            worst = max(worst, err / scale)
            by_set[name] = max(by_set.get(name, 0.0), err / scale)
        differ = int((got['nnbr'] != ref['nnbr']).sum())
        if differ:
            failures.append('%s %s: %d dests count other pairs than the '
                            'plain version' % (label, name, differ))
        pairs += int(ref['nnbr'].sum())
    if failures:
        raise AssertionError('; '.join(failures))
    return dict(max_abs_err=worst_abs, max_scaled_err=worst, by_set=by_set,
                pairs=pairs)


def sweep_start(run, size, dtype, steps=0, device='cuda', scale=0.05,
                extra=()):
    """``gasd_check.sweep_start`` of the TSPH run ``run`` (with the further
    arguments ``extra``): a solver whose fluid stands where an
    evaluation's density iteration starts, its h moved by up to ``scale``
    of itself."""
    return gasd_check.sweep_start(run, size, dtype, steps=steps,
                                  device=device, extra=extra, scale=scale,
                                  make=app)


def set_times(calls_, plain_reps=3, reps=20):
    """{set: ms in a CUDA graph, eagerly, the plain version's, the bound
    and its work} of each call, walking."""
    out = {}
    for _, _, plan, args in calls_:
        w = roofline.tsph_work(*args)
        bound_ms, bound_by = roofline.bound(w)
        out[SET_NAMES[plan.sources[0].terms]] = dict(
            ms=graph_ms(lambda: plan.op(*args), reps),
            eager_ms=events_ms(lambda: plan.op(*args), reps),
            plain_ms=events_ms(lambda: reference(plan, args), plain_reps),
            bound_ms=bound_ms, bound_by=bound_by, work=w)
    return out


_KERNEL = re.compile(r'tsph_pair_kernelI([fd])Lb([01])ENS_\d+([A-Za-z]+)'
                     r'I[fd]Li\d+ELi(\d)EEELi(\d)E')
_TERMS = re.compile(r'tsph_terms_kernelI([fd])Li(\d)E')
_MODES = {'0': 'walk', '1': 'sweep', '2': 'consume'}


def _dtype(c):
    return 'float32' if c == 'f' else 'float64'


def resources(lib=None):
    """{'float32 2D periodic Density sweep': (registers, spill store
    bytes, spill load bytes)} of the default library's kernels (or of
    ``lib``), and of the per-source terms' kernel ('float32 2D terms')."""
    lib = build.build('tsph_pair') if lib is None else lib
    out = {}
    for name, res in build.resources(lib).items():
        m = _KERNEL.search(name)
        if m is not None:
            dtype, periodic, cls, dim, mode = m.groups()
            out['%s %sD %s %s %s' % (
                _dtype(dtype), dim, 'periodic' if periodic == '1' else 'open',
                cls, _MODES[mode])] = res
            continue
        m = _TERMS.search(name)
        out['%s %sD terms' % (_dtype(m.group(1)), m.group(2))
            if m is not None else name] = res
    return out
