"""The gas schemes' pair calls, for the card: ``gasd_pair``'s (``GasDScheme``
and ``ADKEScheme``) and ``gsph_pair``'s (``GSPHScheme``) on the shock tube,
the Sedov blast, the accuracy test and the hydrostatic box.

``RUNS``: ``examples/gas_dynamics/shocktube.py`` (1D, ``--nl``),
``examples/gas_dynamics/sedov.py`` (2D, ``--nx``),
``examples/gas_dynamics/accuracy_test_2d.py`` (2D periodic,
``--nparticles``) and ``examples/gas_dynamics/hydrostatic_box.py`` (2D
periodic, ``--nx``); the scheme is an ``extra`` argument (``--scheme
gsph``, ``--scheme adke``).

``app(run, size, dtype, steps=0, engine='kernel', device='cuda',
extra=())``: the run's application set up (with the further arguments
``extra``, e.g. ``FULL_WIDTH``).  ``calls(run, size, dtype, steps=0,
jitter_start=True, device='cuda', extra=())``: (calls, particles, app):
the two
``gasd_pair`` calls of one evaluation (one more sweep of the density
set, then the momentum set; ``time_walks.plan_calls``), on the run's
state after ``steps`` steps and one evaluation, whose start's positions
are first moved by up to a tenth of the spacing and its velocities
seeded (numpy ``default_rng``, ``jitter``) where ``jitter_start``: h
then varies from particle to particle.  ``check(calls, label, tol)``: each call's kernel
(``gasd_pair``, ``gsph_pair`` or, for ADKE's plain summation density,
``wcsph_pair``) against its plain version (torch's deterministic
algorithms on the card): every output within ``tol`` of max|ref| (``dt_cfl``, the
``MAX``, among them), each dest's pairs in support (``nnbr``) and their
total exactly equal.  ``gradient_h(dim, dtype, device)``: the density
set's ``dwdh`` of a dest with one neighbour at a few distances against
``Gaussian.gradient_h`` (``base/kernels.py``).  ``kinds(dtype, tol,
device)``: ``check`` of both sets under each other kernel (``KINDS``:
``--kernel``, the Sedov lattice at nx=21 and, for the kernels with a 1D
shape, the shock tube at nl=40).  ``resources(lib, kind)``: the kernels'
registers and spills at one kind.  ``sweep_start(run, size, dtype,
steps, ...)``: a solver whose fluid stands at the start of an
evaluation with its h moved by a seeded fraction (``converged`` 0, h0
the h before), so that the density iteration has sweeps to run.
``check_sweep(s, label, tol, capacity)``: the sweep plan's op (the gated
density sweep: ``gasd_sweep``, or ``tsph_sweep`` of a TSPH run from
``tools_dev/tsph_check.py``) against its plain version on every sweep of
that iteration (each from the plain version's state: every output within
``tol`` of max|ref|, the count of unconverged particles and each
``converged`` flag equal), its emitted list against
``pair_link.neighbours_reference``, the iteration's sweeps on the kernel
alone and on the plain version alone, and each linked launch that reads
the last sweep's list (``MPMAccelerations``'; TSPH's velocity gradient
and momentum) bit for bit the walking one (its ``use`` flag set, and
cleared).  ``branch_calls(calls_)``: a GSPH run's calls
with the acceleration call again under each entry of ``BRANCHES`` (every Riemann solver, every
monotonicity and interpolation, ``interface_zero`` off, the hybrid blend
at t = 0.3 and the conduction), each with its own ``GSPHAcceleration``.
``path_calls(run, size, dtype, steps, extra)``: (calls, app): the pair
calls of one evaluation as the path makes them (each at the h it runs
at, on the cells of its binning), after ``steps`` steps of the run's
start.  ``check_gsph_linked(calls_, label, tol, capacity)``: GSPH's linked pair
on the card: the gradients call emitting bit for bit its walk, its list
against ``pair_link.neighbours_reference``, and the acceleration call
on that hand-off bit for bit the walking acceleration call and within
``tol`` of the plain version.
``riemann_check(dtype, n, device)``: each of the eleven device Riemann
solvers (``gsph_pair.riemann``) against the torch solver on Toro's four
problems and ``n`` seeded states.  ``chip_smoke.py`` and
``tests/test_torch_gasd_cuda.py``, ``tests/test_torch_gsph_cuda.py`` use
them; on CPU tensors the kernel is its plain version, which the CPU
tests run through the same functions.
"""

import re

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import Gaussian, kernel_kind
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
    AccuracyTest2D)
from pysph_tpu_torch.examples.gas_dynamics.hydrostatic_box import (
    HydrostaticBox)
from pysph_tpu_torch.examples.gas_dynamics.sedov import SedovPointExplosion
from pysph_tpu_torch.examples.gas_dynamics.shocktube import ShockTube
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import pair_link as pl
from pysph_tpu_torch.ops import pair_sets
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.ops.sweeps import keep_sweeping
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics.basic import SummationDensity
from pysph_tpu_torch.sph.gas_dynamics.gsph import GSPHAcceleration
from pysph_tpu_torch.sph.gas_dynamics.riemann_solver import riemann_solve
from pysph_tpu_torch.tools_dev.common import linked_calls
from pysph_tpu_torch.tools_dev.time_walks import plan_calls
from pysph_tpu_torch.tools_dev.tvf_check import reference

#: {run: (application class, size argument)}
RUNS = {'shocktube': (ShockTube, '--nl'),
        'sedov': (SedovPointExplosion, '--nx'),
        'accuracy_test_2d': (AccuracyTest2D, '--nparticles'),
        'hydrostatic_box': (HydrostaticBox, '--nx')}
#: the Sedov blast at full width (nx=401) steps with the CFL dt of
#: ``MPMAccelerations``' ``dt_cfl`` at a CFL number of 0.1: the example's
#: fixed dt of 1e-4 is some ten times the CFL limit there (the blast's
#: sound speed ~120 at h = 0.003), and at 0.3 (the default) the
#: conduction switch's rate, 0.01 h |del2e| / sqrt(e) with e = 1e-9
#: around the blast, drives alpha2 past 1e28 within 5 steps (float32 on
#: an H100); at 0.1 the run keeps finite for its 200 steps
FULL_WIDTH = ('--adaptive-timestep', '--cfl', '0.1')
#: the ``--kernel`` choices other than the Gaussian (the scheme's
#: default) by the run that takes them, and that run's size: in 1D only
#: the splines have a shape function in the pair kernels
KINDS = {'sedov': (('WendlandQuintic', 'CubicSpline', 'QuinticSpline',
                    'WendlandQuinticC4', 'WendlandQuinticC6',
                    'SuperGaussian'), 21),
         'shocktube': (('CubicSpline', 'QuinticSpline'), 40)}


def app(run, size, dtype, steps=0, engine='kernel', device='cuda',
        extra=()):
    """``run``'s application at ``size`` on ``device``."""
    cls, arg = RUNS[run]
    argv = ['--disable-output', '-q', '--device', device, '--engine',
            engine, arg, str(size), *extra]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    a = cls()
    a.setup(argv)
    return a


def jitter(s, seed=2468):
    """The fluid's positions moved by up to a tenth of its spacing
    (m / rho)^(1/dim) and seeded velocities of a tenth of its largest
    sound speed (``cs`` where set, else from p and rho)."""
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n, dim = st['x'].shape[0], s.dim
    dx = (st['m'] / st['rho']) ** (1.0 / dim)
    cs = torch.sqrt(1.4 * st['p'].clamp(min=0.0) / st['rho'])
    scale = 0.1 * float(cs.max())

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    for c in 'xyz'[:dim]:
        st[c] = st[c] + 0.1 * dx * t(rng.uniform(-1, 1, n))
    for c in 'uvw'[:dim]:
        st[c] = st[c] + t(scale * rng.normal(size=n))


def calls(run, size, dtype, steps=0, jitter_start=True, device='cuda',
          extra=()):
    """(calls, particles, app): the ``gasd_pair`` calls of one evaluation
    of ``run`` at ``size``, after ``steps`` steps and one evaluation of
    its (jittered) start."""
    a = app(run, size, dtype, steps=steps, device=device, extra=extra)
    s = a.solver
    if jitter_start:
        jitter(s)
    if steps:
        s.solve()
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, [0]), n, a


def path_calls(run, size, dtype, steps=0, device='cuda', extra=()):
    """(calls, app): [(0, dest, plan, kernel arguments)] of each pair
    launch of one evaluation of evaluator 0, recorded as the evaluation
    makes them (the scaled density at its scaled h, each on its binning's
    cells), after ``steps`` steps of the run's start; the evaluation is
    run on the step's binning (its reuse test) with the torch engine's
    and the linked plans' arguments as they are."""
    a = app(run, size, dtype, steps=steps, device=device, extra=extra)
    s = a.solver
    if steps:
        a.solve()
    else:
        s.integrator.initial_acceleration(s.states, s.t, s.dt)
    a_eval = s.acceleration_evals[0]
    calls, kept = [], []
    for plan in a_eval._plans.values():
        if plan is None:
            continue

        def record(*args, plan=plan, op=plan.op, **kw):
            # the states as the call sees them: later phases replace
            # their entries (the tensors stay)
            calls.append((0, plan.dest, plan, (
                dict(args[0]), args[1], args[2], dict(args[3]),
                [(dict(st), c, sp) for st, c, sp in args[4]]) + args[5:]))
            return op(*args, **kw)
        kept.append((plan, plan.op))
        plan.op = record
    try:
        handle, _ = a_eval.prepare_reuse(s.states, s.integrator.handles[0])
        a_eval.compute(s.t, s.dt, s.states, handle)
    finally:
        for plan, op in kept:
            plan.op = op
    # each call's plan as the tools run it (its own op)
    return calls, a


def check(calls_, label, tol):
    """Each call's kernel against its plain version: raises where an
    output passes ``tol`` of max|ref| or a dest's pair count differs.
    Returns the largest absolute and scaled errors, the pairs in support
    of all the calls and the dests whose count differs (0)."""
    worst_abs = worst = 0.0
    pairs = 0
    failures = []
    for _, dest, plan, args in calls_:
        if plan.op in (gd.gasd_pair, gs.gsph_pair):
            got = plan.op(*args, counts=True)
            ref = reference(plan, args + (True,))
        else:
            # ADKE's plain summation density on wcsph_pair, which counts
            # no pairs: its outputs, and the pairs of the exact lists
            got = plan.op(*args)
            ref = reference(plan, args)
            got['nnbr'] = ref['nnbr'] = pair_sets.neighbour_counts(
                args[0], args[1], args[4], args[5])
        if args[0]['x'].is_cuda:
            torch.cuda.synchronize()
        for p in plan.outputs:
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p].double() - ref[p].double()).abs().max())
            if not err <= tol * scale:
                failures.append('%s %s.%s: error %.3g > %.0e * %.3g' % (
                    label, dest, p, err, tol, scale))
            worst_abs = max(worst_abs, err)
            worst = max(worst, err / scale)
        differ = int((got['nnbr'] != ref['nnbr']).sum())
        if differ:
            failures.append('%s %s: %d dests count other pairs than the '
                            'plain version' % (label, dest, differ))
        pairs += int(ref['nnbr'].sum())
    if failures:
        raise AssertionError('; '.join(failures))
    return dict(max_abs_err=worst_abs, max_scaled_err=worst, pairs=pairs,
                nnbr_differ=0)


#: the distances, in units of the dest's h, of ``gradient_h``'s neighbour
DISTANCES = (0.0, 0.3, 0.9, 1.7, 2.6, 2.95)


def gradient_h(dim, dtype, device='cuda'):
    """The density set's ``dwdh`` of a dest (h = 0.1, m = 1) with one
    neighbour (m = 1, h = 0.05, so that the support is the dest's) at
    each of ``DISTANCES`` x h along x, against ``Gaussian(dim).
    gradient_h`` at 0 and at that distance: the largest error scaled by
    the reference."""
    h = 0.1
    kernel = Gaussian(dim=dim)
    config = Config(device=device, dtype=dtype)
    worst = 0.0
    for q in DISTANCES:
        pa = get_particle_array_gasd(
            name='fluid', x=np.array([0.0, q * h]), m=1.0, rho=1.0,
            h=np.array([h, 0.5 * h]))
        grid = CellGrid.from_particles([pa], dim=dim,
                                       radius_scale=kernel.radius_scale)
        a_eval = AccelerationEval(
            [pa], [Group([SummationDensity('fluid', ['fluid'], dim=dim)])],
            kernel, config, grid)
        (plan,) = [p for p in a_eval._plans.values() if p is not None]
        states = {'fluid': pa.to_device(config)}
        cells = grid.bin_all(states)
        st = states['fluid']
        pre = {p: torch.zeros_like(st[p]) for p in plan.outputs}
        got = plan.op(*plan.args(st, states, cells, grid, None, pre))
        r = torch.tensor([0.0, q * h], dtype=torch.float64)
        want = float(kernel.gradient_h(None, r, torch.tensor(h,
                                       dtype=torch.float64)).sum())
        err = abs(float(got['dwdh'][0]) - want) / abs(want)
        worst = max(worst, err)
    return worst


def kinds(dtype, tol, device='cuda'):
    """{label: ``check``'s result and the kind} of both sets of one
    evaluation under each kernel of ``KINDS`` on its run (jittered)."""
    found = {}
    for run, (names, size) in KINDS.items():
        for name in names:
            c, _, _ = calls(run, size, dtype, device=device,
                            extra=('--kernel', name))
            label = '%s %s %d %s' % (name, run, size, str(dtype)[6:])
            found[label] = dict(check(c, label, tol),
                                kind=kernel_kind(c[0][3][6]))
    return found


#: the kernels' names in a library's log: the kernel, its sets
#: the ADKE sets' functors (in ``adke_pair``, and in ``gasd_pair`` before it)
ADKE_SETS = 'AdkeDensity|AdkeAccel'
_KERNELS = {'gasd_pair': 'Density|Momentum', 'adke_pair': ADKE_SETS,
            'gsph_pair': 'Gradients|Acceleration'}


def resources(lib, kind=2, kernel='gasd_pair', sets=None):
    """{'<dtype> <set> <open|periodic>': (registers, spill store bytes,
    spill load bytes)} of the kernels of shape ``kind`` in the built
    library ``lib`` of ``kernel`` (``gasd_pair``, ``adke_pair`` or
    ``gsph_pair``; ``build.resources``): its sets, or the functors
    ``sets`` (a regex alternation)."""
    from pysph_tpu_torch.ops import build
    pattern = re.compile(r'%s_kernelI([fd])Li(\d)ELb([01])EN\w*?\d(%s)I'
                         % (kernel, sets or _KERNELS[kernel]))
    out = {}
    for name, res in build.resources(lib).items():
        m = pattern.search(name)
        if m and int(m.group(2)) == kind:
            out['%s %s %s' % ('float32' if m.group(1) == 'f' else 'float64',
                              m.group(4).lower(),
                              'periodic' if m.group(3) == '1' else 'open')
                ] = res
    return dict(sorted(out.items()))


#: ``adke_calls``: the lattice's particles an axis, and its probe dests
#: (a count that fills no whole block: a block of 128 threads takes 16
#: dests at 8 lanes a dest)
ADKE_LATTICE = 24
ADKE_PROBES = 37


def adke_calls(cells, dtype, device='cuda', seed=7):
    """ADKE's two sets (``SummationDensityADKE``, ``ADKEAccelerations``
    with the accuracy test's constants) on a jittered ``ADKE_LATTICE``^2
    lattice in the unit square, h varying by 20% from particle to
    particle, its props seeded (numpy ``default_rng``): with ``cells`` an
    int, the square periodic in x and y and h sized so that the grid has
    ``cells`` cells on each axis, the lattice its own dests; with
    ``cells`` None, an open grid and also ``ADKE_PROBES`` probe particles
    as dests of the lattice, the last third of them far from it (no
    pair).  Returns the calls as ``time_walks.plan_calls`` gives them
    (density then accelerations, the lattice's first)."""
    from pysph_tpu_torch.base.domain import DomainManager
    from pysph_tpu_torch.sph.gas_dynamics.basic import (
        ADKEAccelerations, SummationDensityADKE)
    rng = np.random.default_rng(seed)
    n = ADKE_LATTICE
    dx = 1.0 / n
    g = (np.arange(n) + 0.5) * dx
    lx, ly = (c.ravel() for c in np.meshgrid(g, g))
    # the widest h of a grid of `cells` cells 1.1 times the support
    hmax = 1.0 / (3.3 * (cells + 0.5)) if cells else 1.5 * dx

    def array(name, x, y):
        k = x.size
        pa = get_particle_array_gasd(
            name=name, x=x, y=y, u=rng.normal(size=k), v=rng.normal(size=k),
            m=dx * dx, rho=1.0 + 0.1 * rng.random(k),
            p=1.0 + rng.random(k), cs=1.0 + rng.random(k),
            e=1.0 + rng.random(k), div=rng.normal(size=k),
            h=hmax * (1.0 - 0.2 * rng.random(k)))
        pa.add_property('logrho')
        pa.properties['h0'][:] = pa.properties['h']
        return pa

    k = lx.size
    arrays = [array('fluid', lx + 0.1 * dx * rng.uniform(-1, 1, k),
                    ly + 0.1 * dx * rng.uniform(-1, 1, k))]
    if cells is None:
        far = ADKE_PROBES // 3
        near = ADKE_PROBES - far
        px = np.concatenate([rng.uniform(0, 1, near),
                             rng.uniform(3, 4, far)])
        arrays.append(array('probe', px, rng.uniform(0, 1, ADKE_PROBES)))
    dests = [pa.name for pa in arrays]
    groups = [Group([SummationDensityADKE(d, ['fluid'], k=1.5, eps=0.0)
                     for d in dests]),
              Group([ADKEAccelerations(d, ['fluid'], alpha=1.0, beta=2.0,
                                       g1=0.2, g2=0.4, k=1.5, eps=0.0)
                     for d in dests])]
    domain = None if cells is None else DomainManager(
        xmin=0, xmax=1, ymin=0, ymax=1, periodic_in_x=True,
        periodic_in_y=True)
    kernel = Gaussian(dim=2)
    grid = CellGrid.from_particles(arrays, dim=2,
                                   radius_scale=kernel.radius_scale,
                                   domain=domain)
    if cells is not None and grid.dims[:2] != (cells, cells):
        raise AssertionError('adke_calls: a grid of %s cells for %d'
                             % (grid.dims, cells))
    config = Config(device=device, dtype=dtype)
    a_eval = AccelerationEval(arrays, groups, kernel, config, grid)
    states = {pa.name: pa.to_device(config) for pa in arrays}
    binned = grid.bin_all(states)
    calls = []
    for group in a_eval.leaf_groups():
        for dest in dests:
            plan = a_eval._plans.get((id(group), dest))
            store = states[dest]
            pre = {p: torch.zeros_like(store[p]) for p in plan.outputs}
            calls.append((0, dest, plan, plan.args(
                store, states, binned, grid, None, pre)))
    return calls


def double(obj):
    """``obj`` (a call's arguments) with every floating tensor in it,
    in dicts, lists and tuples, as float64."""
    if torch.is_tensor(obj):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: double(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*[double(v) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(double(v) for v in obj)
    return obj


#: the float32 kernel's error against the plain float64 version may be up
#: to this many times the plain float32 version's own (``against_float64``)
F32_ROUNDING_FACTOR = 4.0


def against_float64(got, ref32, ref64, outputs, label, tol=1e-4):
    """A float32 call's results ``got`` held to its plain version in
    float64 on the same inputs ``ref64``: each output's error within
    ``tol`` of max|ref| or within ``F32_ROUNDING_FACTOR`` times the plain
    float32 version's (``ref32``) own error against it.  ADKE's
    accelerations in a uniform pressure cancel to ~1/60 of their terms'
    sum, so float32 rounds both versions by more than 1e-4 of the sum; a
    wrong kernel errs by far more than the plain float32 version does.
    Returns {output: (the kernel's scaled error, the plain float32
    version's)}; raises where an output misses."""
    readings = {}
    for p in outputs:
        scale = max(float(ref64[p].abs().max()), 1e-300)
        kernel = float((got[p].double() - ref64[p]).abs().max())
        plain = float((ref32[p].double() - ref64[p]).abs().max())
        readings[p] = (float('%.3g' % (kernel / scale)),
                       float('%.3g' % (plain / scale)))
        if not kernel <= max(F32_ROUNDING_FACTOR * plain, tol * scale):
            raise AssertionError(
                '%s %s: the kernel is %.3g from the float64 plain version, '
                'the float32 plain version %.3g (max|ref| %.3g)' % (
                    label, p, kernel, plain, scale))
    return readings


def repeats(calls_):
    """Each ``gasd_pair`` call of ``calls_`` launched twice, with its
    counts: the dests whose outputs or count differ between the two
    (none: a launch's sums are one fixed order).  Returns the dests the
    calls compared."""
    dests = 0
    for _, dest, plan, args in calls_:
        if plan.op is not gd.gasd_pair:
            continue
        a, b = plan.op(*args, counts=True), plan.op(*args, counts=True)
        differ = [p for p in a if not torch.equal(a[p], b[p])]
        if differ:
            raise AssertionError('%s %s: two launches differ in %s' % (
                dest, plan.outputs, differ))
        dests += a['nnbr'].numel()
    return dests


#: float32: a dest whose converged flag the kernel and the plain version
#: decide apart must have taken a step within this fraction of htol of
#: htol (the sums' rounding moves the step by ~1e-4 of itself)
FLIP_BAR = 1e-3


#: each sweep op's module (its ``SWEEP_OUTPUTS``), the prefix of its work's
#: measures (``roofline``'s ``<prefix>_sweep_work``, ``_linked_work`` and
#: ``_work``) and its plain version
SWEEPS = {gd.gasd_sweep: (gd, 'gasd', gd.gasd_sweep_reference),
          ts.tsph_sweep: (ts, 'tsph', ts.tsph_sweep_reference)}


def sweep_start(run, size, dtype, steps=0, jitter_start=True, device='cuda',
                extra=(), scale=0.05, seed=1357, make=None):
    """A solver of ``run`` at ``size`` after ``steps`` steps of its
    (jittered) start whose fluid stands where an evaluation's density
    iteration starts (``GasDFluidStep.initialize``, TSPH's ``PECStep``'s:
    ``converged`` 0, ``omega`` 1 where the scheme has it, h0 = h), its h
    then moved by up to ``scale`` of itself (seeded); ``make``: the
    application's maker (default ``app``; ``tsph_check.app``)."""
    a = (make or app)(run, size, dtype, steps=steps, device=device,
                      extra=extra)
    s = a.solver
    if jitter_start:
        jitter(s)
    if steps:
        s.solve()
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]
    st['h0'] = st['h'].clone()
    st['h'] = st['h'] * torch.as_tensor(
        1.0 + scale * rng.uniform(-1, 1, n), dtype=st['h'].dtype,
        device=st['h'].device)
    st['converged'] = torch.zeros_like(st['h'])
    if 'omega' in st:
        st['omega'] = torch.ones_like(st['h'])
    return s


def _sweep_args(s, states):
    a_eval = s.acceleration_evals[0]
    plan, = a_eval.sweep_plans()
    cells = s.grid.bin_all(states)
    store = states[plan.dest]
    srcs = [(states[ps.name], cells[ps.name], ps) for ps in plan.plan.sources]
    return plan, cells, (store, cells[plan.dest],
                         plan.group.write_mask(store), srcs, s.grid,
                         plan.plan.kernel, plan.spec)


def _plain_sweep(args, op=gd.gasd_sweep):
    """The plain version of the sweep op ``op`` on ``args``; on the card
    with torch's deterministic algorithms."""
    reference = SWEEPS[op][2]
    dest = args[0]
    if not dest['x'].is_cuda:
        return reference(*args)
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return reference(*args)
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


def _iterate(s, states, sweep):
    """The sweeps of the density iteration from ``states`` (updated),
    each ``sweep(args)`` on a fresh binning; returns (sweeps, the last
    call's arguments, its cells, whether it ended converged)."""
    plan = s.acceleration_evals[0].sweep_plans()[0]
    it, conv = 0, False
    while keep_sweeping(it, conv, plan.min_iterations, plan.max_iterations):
        _, cells, args = _sweep_args(s, states)
        out, unconv = sweep(args)
        states[plan.dest].update(out)
        it += 1
        conv = not int(unconv)
    return it, args, cells, conv


def check_sweep(s, label, tol, capacity=None):
    """The sweep plan's op (``gasd_sweep``, ``tsph_sweep``) on the card
    against its plain version (module docstring), and each plan that
    reads its list (``MPMAccelerations``'; TSPH's velocity gradient and
    momentum) on the last sweep's list bit for bit the walk;
    ``capacity``: the list's entries (default the plan's).  Returns
    {sweeps, sweeps_kernel, sweeps_plain, max_abs_err, max_scaled_err,
    flags_differ, pairs, overflowed, max_count, capacity, linked, walked,
    flip_off}; raises where a bar is missed.  In float32 a dest may end
    converged on one side only where its step lies within ``FLIP_BAR`` of
    htol of htol: counted in ``flags_differ`` (none may in float64) and
    left out of the errors."""
    plan = s.acceleration_evals[0].sweep_plans()[0]
    mod, kernel = SWEEPS[plan.op][0], plan.plan.op.__name__
    dev = s.states[plan.dest]['x'].device
    if dev.type != 'cuda':
        raise ValueError('check_sweep: %s: states off the card' % label)
    start = {n: dict(st) for n, st in s.states.items()}
    failures = []
    found = dict(max_abs_err=0.0, max_scaled_err=0.0, flags_differ=0,
                 pairs=0, overflowed=0, max_count=0)
    # each sweep of the plain iteration, the kernel from the same state
    states = {n: dict(st) for n, st in start.items()}
    it, conv = 0, False
    while keep_sweeping(it, conv, plan.min_iterations, plan.max_iterations):
        _, cells, args = _sweep_args(s, states)
        store, srcs = args[0], args[3]
        buffers = gd.SweepBuffers(store, srcs, plan.plan.kernel.dim,
                                  capacity or plan.capacity)
        pl.reset_overflow(kernel, dev)
        got, gun = plan.op(*args, buffers=buffers)
        want, wun = _plain_sweep(args, plan.op)
        torch.cuda.synchronize()
        # a particle whose Newton step sits within rounding of htol may
        # end converged on one side only (float32: the sums' order)
        flip = got['converged'] != want['converged']
        flips = int(flip.sum())
        found['flags_differ'] += flips
        if flips:
            step = (got['h'].double() - want['h'].double()).abs()[flip] / \
                store['h0'].double()[flip]
            off = float((step / plan.spec.htol - 1.0).abs().max())
            found['flip_off'] = max(found.get('flip_off', 0.0), off)
            if store['x'].dtype == torch.float64 or not off <= FLIP_BAR:
                failures.append('%s sweep %d: %d converged flags differ, '
                                'their steps %.3g of htol off it' % (
                                    label, it, flips, off))
        keep = ~flip
        for p in mod.SWEEP_OUTPUTS:
            ref = want[p].double()[keep]
            scale = max(float(ref.abs().max()), 1e-300)
            err = float((got[p].double()[keep] - ref).abs().max())
            found['max_abs_err'] = max(found['max_abs_err'], err)
            found['max_scaled_err'] = max(found['max_scaled_err'],
                                          err / scale)
            if not err <= tol * scale:
                failures.append('%s sweep %d %s: error %.3g > %.0e * %.3g'
                                % (label, it, p, err, tol, scale))
        # the flags the kernel ends converged and the plain version not
        ends = int((got['converged'] == 1.0)[flip].sum())
        if int(gun) != int(wun) - ends + (flips - ends):
            failures.append('%s sweep %d: %d unconverged, the plain version '
                            '%d, %d flags apart' % (label, it, int(gun),
                                                    int(wun), flips))
        count, positions = pl.listed(buffers.handoff(None))
        want_count, where = pl.neighbours_reference(store, args[1], srcs,
                                                    s.grid)
        cap = buffers.nbr.shape[0]
        if not (torch.equal(count, want_count) and torch.equal(
                positions, pl.cut(want_count, where, cap))):
            failures.append('%s sweep %d: the neighbour list differs from '
                            'neighbours_reference' % (label, it))
        over = pl.overflowed(kernel, dev)
        if over != int((want_count > cap).sum()):
            failures.append('%s sweep %d: %d dests counted past the '
                            'capacity, %d are' % (label, it, over,
                                                  int((want_count > cap)
                                                      .sum())))
        found['pairs'] += int(want_count.sum())
        found['overflowed'] = max(found['overflowed'], over)
        found['max_count'] = max(found['max_count'], int(want_count.max()))
        found['capacity'] = cap
        states[plan.dest].update(want)
        it += 1
        conv = not int(wun)
    found['sweeps'] = it
    # the iteration on each alone
    kernel_states = {n: dict(st) for n, st in start.items()}
    buffers = gd.SweepBuffers(start[plan.dest], args[3],
                              plan.plan.kernel.dim, plan.capacity)
    kit, kargs, kcells, kconv = _iterate(
        s, kernel_states, lambda a: plan.op(*a, buffers=buffers))
    pit, _, _, _ = _iterate(s, {n: dict(st) for n, st in start.items()},
                            lambda a: _plain_sweep(a, plan.op))
    found['sweeps_kernel'], found['sweeps_plain'] = kit, pit
    # the linked launches on the kernel's last sweep
    link = plan.link
    if link is None:
        failures.append('%s: the sweep is linked to no plan' % label)
    else:
        found['linked'] = found['walked'] = 0
        for mplan in link.consumers:
            mstore = kernel_states[plan.dest]
            pre = {p: torch.zeros_like(mstore[p]) for p in mplan.outputs}
            margs = mplan.args(mstore, kernel_states, kcells, s.grid,
                               mplan_mask(s, mplan, mstore), pre)
            walked = mplan.op(*margs)
            for use in ((True, False) if kconv else (False,)):
                flag = torch.tensor(use, device=dev)
                got = mplan.op(*margs, handoff=buffers.handoff(flag))
                if any(not torch.equal(got[p], walked[p]) for p in walked):
                    failures.append('%s: the launch of %s on the list (use '
                                    '%s) differs from the walk' % (
                                        label, mplan.outputs, use))
                found['linked' if use else 'walked'] += 1
            ref = reference(mplan, margs)
            for p in mplan.outputs:
                r = ref[p].double()
                scale = max(float(r.abs().max()), 1e-300)
                err = float((walked[p].double() - r).abs().max())
                if not err <= tol * scale:
                    failures.append('%s reader %s: error %.3g > %.0e * %.3g'
                                    % (label, p, err, tol, scale))
    if failures:
        print('check_sweep %s: %s' % (label, found), flush=True)
        raise AssertionError('; '.join(failures))
    return found


def sweep_times(s, reps=20):
    """At the state of ``s`` (``sweep_start``'s), on the card: a gated
    sweep launch of the sweep plan's op as the path runs it (in place
    under its flag) in a CUDA graph and eager, its plain version and its
    work (``roofline``'s ``<kernel>_sweep_work``); the iteration on the
    kernel from that state, then the launches that read its last sweep's
    list (``MPMAccelerations``'; TSPH's velocity gradient and momentum),
    on the list and walking, each in a graph, with their work
    (``<kernel>_linked_work``, ``<kernel>_work``; by reader in
    ``readers``, summed in ``linked_ms``, ``walk_ms`` and the works), and
    the dests past the list's capacity in one sweep
    (``pair_link.overflowed``)."""
    from pysph_tpu_torch.tools_dev import common, roofline
    plan = s.acceleration_evals[0].sweep_plans()[0]
    mod, short, _ = SWEEPS[plan.op]
    kernel = plan.plan.op.__name__
    start = {n: dict(st) for n, st in s.states.items()}
    states = {n: dict(st) for n, st in start.items()}
    _, _, args = _sweep_args(s, states)
    store, srcs = args[0], args[3]
    dev = store['x'].device
    store.update({p: store[p].clone() for p in mod.SWEEP_OUTPUTS})
    buffers = gd.SweepBuffers(store, srcs, plan.plan.kernel.dim,
                              plan.capacity)
    run = torch.ones((), dtype=torch.bool, device=dev)
    work = getattr(roofline, short + '_sweep_work')(*args[:6])
    plain_ms = common.events_ms(lambda: _plain_sweep(args, plan.op), 3)

    def sweep():
        plan.op(*args, run=run, buffers=buffers)
    ms = common.graph_ms(sweep, reps)
    eager_ms = common.events_ms(sweep, reps)
    kernel_states = {n: dict(st) for n, st in start.items()}
    sweeps, kargs, kcells, conv = _iterate(
        s, kernel_states, lambda a: plan.op(*a, buffers=buffers))
    pl.reset_overflow(kernel, dev)
    plan.op(*kargs, buffers=buffers)
    overflowed = pl.overflowed(kernel, dev)
    mstore = kernel_states[plan.dest]
    use = torch.tensor(conv, device=dev)
    readers = []
    for mplan in plan.link.consumers:
        pre = {p: torch.zeros_like(mstore[p]) for p in mplan.outputs}
        margs = mplan.args(mstore, kernel_states, kcells, s.grid,
                           mplan_mask(s, mplan, mstore), pre)
        readers.append(dict(
            outputs=mplan.outputs,
            linked_ms=common.graph_ms(
                lambda: mplan.op(*margs, handoff=buffers.handoff(use)),
                reps),
            walk_ms=common.graph_ms(lambda: mplan.op(*margs), reps),
            linked_work=getattr(roofline, short + '_linked_work')(*margs),
            walk_work=getattr(roofline, short + '_work')(*margs)))
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, work=work,
                sweeps=sweeps, converged=conv,
                linked_ms=sum(r['linked_ms'] for r in readers),
                walk_ms=sum(r['walk_ms'] for r in readers),
                linked_work=roofline.add(*[r['linked_work']
                                           for r in readers]),
                walk_work=roofline.add(*[r['walk_work'] for r in readers]),
                readers=readers, overflowed=overflowed,
                dests=mstore['x'].shape[0],
                max_count=int(buffers.count.max()))


def mplan_mask(s, mplan, store):
    """The write mask of the group of the plan ``mplan``."""
    a_eval = s.acceleration_evals[0]
    group = next(g for g in a_eval.leaf_groups()
                 if a_eval._plans.get((id(g), mplan.dest)) is mplan)
    return group.write_mask(store)


def check_gsph_linked(calls_, label, tol, capacity=None):
    """The linked ``gsph_pair`` pair of a GSPH run's ``calls_`` on the
    card: the gradients call with ``emit`` (``capacity``: the list's, for
    tests) must be its walking call bit for bit, its list
    ``pair_link.neighbours_reference``'s exactly (each dest's cut at the
    capacity) and its overflow count the dests past it; the acceleration
    call on that hand-off must be the walking acceleration call bit for
    bit; both within ``tol`` of max|ref| of the plain version.  Returns
    {dests, pairs, max_count, capacity, overflowed, max_abs_err}; raises
    where a bar is missed."""
    (emitting, consuming), = linked_calls(calls_)
    gplan, gargs = emitting[2], emitting[3]
    aplan, aargs = consuming[2], consuming[3]
    dest = gargs[0]
    dev = dest['x'].device
    if dev.type != 'cuda':
        raise ValueError('check_gsph_linked: %s: calls off the card' % label)
    failures = []
    pl.reset_overflow('gsph_pair', dev)
    grads, handoff = gs.gsph_pair(*gargs, emit=True, capacity=capacity)
    overflowed = pl.overflowed('gsph_pair', dev)
    acc = gs.gsph_pair(*aargs, handoff=handoff)
    for what, got, walked in (('gradients', grads, gs.gsph_pair(*gargs)),
                              ('acceleration', acc, gs.gsph_pair(*aargs))):
        differ = [p for p in walked if not torch.equal(got[p], walked[p])]
        if differ:
            failures.append('%s: the linked %s call differs from the walk '
                            'in %s' % (label, what, differ))
    count, positions = pl.listed(handoff)
    want, where = pl.neighbours_reference(dest, gargs[1], gargs[4], gargs[5])
    cap = handoff.nbr.shape[0]
    if not (torch.equal(count, want) and
            torch.equal(positions, pl.cut(want, where, cap))):
        failures.append('%s: the neighbour list differs from '
                        'neighbours_reference' % label)
    if overflowed != int((want > cap).sum()):
        failures.append('%s: %d dests counted past the capacity, %d are'
                        % (label, overflowed, int((want > cap).sum())))
    worst = 0.0
    for plan, args, got in ((gplan, gargs, grads), (aplan, aargs, acc)):
        ref = reference(plan, args)
        for p in plan.outputs:
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p].double() - ref[p].double()).abs().max())
            worst = max(worst, err)
            if not err <= tol * scale:
                failures.append('%s %s: error %.3g > %.0e * %.3g' % (
                    label, p, err, tol, scale))
    if failures:
        raise AssertionError('; '.join(failures))
    return dict(dests=dest['x'].shape[0], pairs=int(want.sum()),
                max_count=int(want.max()), capacity=cap,
                overflowed=overflowed, max_abs_err=worst)


#: GSPHAcceleration's variants of ``branch_calls``: every Riemann solver
#: and every branch of the limiter, the interpolation, the interface, the
#: hybrid blend and the conduction
BRANCHES = dict(
    [('rsolver %d' % r, dict(rsolver=r, monotonicity=1)) for r in range(11)]
    + [('first order delta', dict(rsolver=2, monotonicity=0,
                                  interpolation=0)),
       ('iwin cubic', dict(rsolver=7, monotonicity=2, interpolation=2)),
       ('linear interface', dict(rsolver=3, interface_zero=False)),
       ('iwin cubic interface', dict(rsolver=4, monotonicity=2,
                                     interpolation=2,
                                     interface_zero=False)),
       ('hybrid', dict(rsolver=2, hybrid=True, blend_alpha=2.0)),
       ('conduction', dict(rsolver=2, g1=0.25, g2=0.5))])


def branch_calls(calls_):
    """{label: call}: the acceleration call of a GSPH run's ``calls_``
    (``calls``'s first item) under each of ``BRANCHES``, at t = 0.3."""
    (k, dest, plan, args), = [c for c in calls_
                              if c[2].sources[0].terms == gs.ACC]
    base = plan.sources[0][2][0]
    out = {}
    for label, kw in BRANCHES.items():
        eq = GSPHAcceleration(base.dest, base.sources, gamma=base.gamma,
                              niter=base.niter, **kw)
        srcs = [(st, cells, gs.GsphSource(ss.name, ss.terms, (eq,),
                                          gs.params_of(eq)))
                for st, cells, ss in args[4]]
        out[label] = (k, dest, plan, args[:4] + (srcs,) + args[5:7] +
                      (0.3, args[8]))
    return out


def riemann_states(n, dtype, device, seed=11):
    """Toro's four problems, then ``n`` seeded states (densities and
    pressures log-uniform over three and four decades, velocities in
    [-3, 3]), as (rhol, rhor, pl, pr, ul, ur) tensors."""
    toro = np.array([[1.0, 0.125, 1.0, 0.1, 0.0, 0.0],
                     [1.0, 1.0, 1000.0, 0.01, 0.0, 0.0],
                     [1.0, 1.0, 0.4, 0.4, -2.0, 2.0],
                     [1.0, 1.0, 0.01, 100.0, 0.0, 0.0]]).T
    rng = np.random.default_rng(seed)
    rand = np.concatenate([10.0 ** rng.uniform(-2, 1, (2, n)),
                           10.0 ** rng.uniform(-2, 2, (2, n)),
                           rng.uniform(-3, 3, (2, n))])
    return [torch.as_tensor(np.concatenate([a, b]), dtype=dtype,
                            device=device) for a, b in zip(toro, rand)]


def riemann_check(dtype, n=100000, device='cuda', gamma=1.4, niter=20):
    """{solver id: (largest error scaled by max|ref|, NaNs apart)} of each
    device solver against the torch solver on ``riemann_states``; raises
    where a NaN falls apart or an error passes 1e-10 (float64) or 1e-4
    (float32) of max|ref| over the finite values."""
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    states = riemann_states(n, dtype, device)
    found, failures = {}, []
    for method in range(gs.RSOLVERS):
        got = gs.riemann(method, *states, gamma, niter)
        want = riemann_solve(method, *states, gamma, niter)
        worst, apart = 0.0, 0
        for g, w in zip(got, want):
            nan = torch.isnan(w)
            apart += int((torch.isnan(g) != nan).sum())
            fin = ~nan & torch.isfinite(w)
            scale = max(float(w[fin].abs().max()), 1e-300)
            err = float((g[fin].double() - w[fin].double()).abs().max())
            worst = max(worst, err / scale)
        found[method] = (worst, apart)
        if apart or not worst <= tol:
            failures.append('solver %d: scaled error %.3g, %d NaNs apart'
                            % (method, worst, apart))
    if failures:
        raise AssertionError('; '.join(failures))
    return found
