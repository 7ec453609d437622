"""CRKSPH's pair calls, for the card: ``crksph_pair``'s six sets on the
accuracy test, the hydrostatic box and the Taylor-Green vortex (2D,
periodic), and on seeded boxes, an open 2D one and an open 3D one.

``RUNS``: ``examples/gas_dynamics/accuracy_test_2d.py --scheme crksph``
(``--nparticles``), ``examples/gas_dynamics/hydrostatic_box.py`` (its
default scheme, ``--nx``) and ``examples/taylor_green.py --scheme
crksph`` (``--nx``).  ``app(run, size, dtype, steps=0, device='cuda')``:
the run's application set up.  ``jitter(s)``: its fluid's positions
moved by up to a tenth of its spacing, its velocities seeded, and e
seeded near 1 where the example leaves it 0 (the Taylor-Green vortex:
its seeded velocities would take e below 0, where cs is NaN).
``calls(run, size, dtype, steps=1, device='cuda')``: (calls, particles,
app): the ``crksph_pair`` calls of both evaluators (six), on the run's
jittered state after ``steps`` steps and one evaluation
(``time_walks.plan_calls``).  ``lattice(case)``: the seeded props of
``CASES`` (``'periodic'``, a 16^2 box periodic in x and y; ``'open'``, a
12^2 box and one particle far from it, whose system is singular;
``'3d'``, a 6^3 box), h varied by 10%; ``box_calls(case, dtype,
device)``: the calls of both evaluators of ``CRKSPHScheme`` on it, as
the evaluators make them.  ``check(calls, label, tol)``: each call's
kernel against its plain version (torch's deterministic algorithms on
the card): every output within ``tol`` of max|ref| and each dest's pairs
in support equal; returns the largest errors, by set too.
``check_linked(calls, label, tol, capacity)``: the first evaluator's
linked chain (``ops/pair_engine.py::link_pairs``: the number density
emitting, the moments, density, velocity gradient and momentum reading
its list) against the plain version and the unlinked calls, the list
against ``pair_link.neighbours_reference``.  ``solve_moments(state,
dim)``: ``crk_solve``'s arguments from a state's moments, as
``CRKSPHPreStep.post_loop`` hands them; ``check_solve(state, dim, tol)``:
the solve against its plain version, the same particles singular.
``set_times(calls)``: each set's kernel in a CUDA graph, eagerly and its
plain version, with its bound (``roofline.crksph_work``);
``chain_times(calls)``: the six launches as the path runs them (the
chain linked, the energy walking) and each launch of the chain alone.
``resources(lib)``: registers and spill bytes by dtype, dimension, grid,
set and lanes.  ``chip_smoke.py`` and ``tests/test_torch_crksph_cuda.py``
use them; ``tests/test_torch_crksph.py`` takes ``lattice`` from here.
"""

import re

import numpy as np
import torch

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
    AccuracyTest2D)
from pysph_tpu_torch.examples.gas_dynamics.hydrostatic_box import (
    HydrostaticBox)
from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import build, pair_link
from pysph_tpu_torch.ops import crk_solve as cs
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.sph.wc import crksph
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev.common import events_ms, graph_ms
from pysph_tpu_torch.tools_dev.time_walks import plan_calls
from pysph_tpu_torch.tools_dev.tvf_check import reference

#: {run: (application class, size argument, further arguments)}
RUNS = {'accuracy_test_2d': (AccuracyTest2D, '--nparticles',
                             ('--scheme', 'crksph')),
        'hydrostatic_box': (HydrostaticBox, '--nx', ()),
        'taylor_green': (TaylorGreen, '--nx', ('--scheme', 'crksph'))}
#: each set's name by its term mask
SET_NAMES = {cp.NDEN: 'number density', cp.MOMS: 'moments',
             cp.RHO: 'density', cp.GRADV: 'velocity gradient',
             cp.MOM: 'momentum', cp.MOM | cp.VISC: 'momentum',
             cp.ENERGY: 'energy'}
#: the CRKSPHScheme keywords of each seeded box
CASES = {'periodic': dict(nu=0.01), 'open': dict(nu=0.0, gy=-0.5),
         '3d': dict(nu=0.01)}
GAMMA = 1.4


def app(run, size, dtype, steps=0, device='cuda', extra=()):
    """``run``'s application at ``size`` on ``device``."""
    cls, arg, more = RUNS[run]
    argv = ['--disable-output', '-q', '--device', device, arg, str(size),
            *more, *extra]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    a = cls()
    a.setup(argv)
    return a


def jitter(s, seed=1357):
    """Move the fluid's positions by up to a tenth of its spacing, add
    seeded velocities of 0.1 and seed e near 1 where it is 0 everywhere."""
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]
    dx = torch.sqrt(st['m'] / st['rho'])

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    for c in 'xy':
        st[c] = st[c] + 0.1 * dx * t(rng.uniform(-1, 1, n))
    for c in 'uv':
        st[c] = st[c] + t(0.1 * rng.normal(size=n))
    if not bool(st['e'].any()):
        st['e'] = 1.0 + t(0.1 * rng.random(n))


def calls(run, size, dtype, steps=1, device='cuda'):
    """(calls, particles, app): the ``crksph_pair`` calls of both
    evaluators of ``run`` at ``size``, on its jittered start after
    ``steps`` steps and one evaluation."""
    a = app(run, size, dtype, steps=steps, device=device)
    s = a.solver
    jitter(s)
    if steps:
        s.solve()
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    n = s.states['fluid']['x'].shape[0]
    return plan_calls(s, [0, 1]), n, a


def lattice(case, seed=3):
    """(props, dim, periodic) of a case: a lattice of spacing dx on the
    unit square (cube) jittered by a tenth of dx, with h = 1.2 dx varied
    by 10% and seeded rho, e, u, u0 (v, w and v0, w0); the open box's
    last particle stands far from the others."""
    rng = np.random.default_rng(seed)
    nx, dim = {'periodic': (16, 2), 'open': (12, 2), '3d': (6, 3)}[case]
    dx = 1.0 / nx
    g = (np.arange(nx) + 0.5) * dx
    grids = np.meshgrid(*([g] * dim), indexing='ij')
    pos = [c.ravel() + 0.1 * dx * rng.uniform(-1, 1, c.size) for c in grids]
    if case == 'open':
        pos = [np.append(c, 3.0) for c in pos]
    n = pos[0].size
    props = dict(zip('xyz', pos))
    props['h'] = 1.2 * dx * (1.0 + 0.1 * rng.uniform(-1, 1, n))
    props['rho'] = 1.0 + 0.2 * rng.random(n)
    props['m'] = dx ** dim * props['rho']
    props['e'] = 1.0 + rng.random(n)
    for c, c0 in zip('uvw'[:dim], ('u0', 'v0', 'w0')):
        props[c] = 0.3 * rng.normal(size=n)
        props[c0] = props[c] + 0.05 * rng.normal(size=n)
    return props, dim, case == 'periodic'


def stages(case, dim):
    """The two evaluators' groups of ``CRKSPHScheme`` for ``case``."""
    scheme = crksph.CRKSPHScheme(['fluid'], dim=dim, rho0=0, c0=0, h0=0,
                                 p0=0, gamma=GAMMA, cl=2, **CASES[case])
    return scheme.get_equations().groups


def record(evaluator, run):
    """[(0, dest, plan, arguments)] of each planned pair call that
    ``run()`` makes through ``evaluator``'s ``AccelerationEval``, recorded
    as the calls are made (the states as each call sees them)."""
    out, kept = [], []
    for plan in evaluator._plans.values():
        if plan is None:
            continue

        def rec(*args, plan=plan, op=plan.op, **kw):
            out.append((0, plan.dest, plan, (
                dict(args[0]), args[1], args[2], dict(args[3]),
                [(dict(st), c, sp) for st, c, sp in args[4]]) + args[5:]))
            return op(*args, **kw)
        kept.append((plan, plan.op))
        plan.op = rec
    try:
        run()
    finally:
        for plan, op in kept:
            plan.op = op
    return out


def box_calls(case, dtype, device='cuda'):
    """The calls of both evaluators of ``CRKSPHScheme`` on the seeded box
    ``case`` (``lattice``), as they make them."""
    props, dim, periodic = lattice(case)
    pa = crksph.get_particle_array_crksph(name='fluid', **props)
    domain = DomainManager(xmin=0, xmax=1, ymin=0, ymax=1,
                           periodic_in_x=True,
                           periodic_in_y=True) if periodic else None
    out = []
    for eqs in stages(case, dim):
        ev = SPHEvaluator([pa], eqs, dim=dim, kernel=QuinticSpline(dim=dim),
                          domain_manager=domain,
                          config=Config(device=device, dtype=dtype))
        out += record(ev.func_eval, lambda: ev.evaluate(t=0.0, dt=1e-3))
    return out


def check(calls_, label, tol):
    """Each call's kernel against its plain version: raises where an
    output passes ``tol`` of max|ref| or a dest's pair count differs.
    Returns the largest absolute and scaled errors, by set the largest
    scaled error, and the pairs in support of all the calls."""
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
                pairs=pairs, nnbr_differ=0)


def _errors(got, ref, outputs, tol, label, failures):
    """The largest scaled error of ``got`` against ``ref`` over
    ``outputs``, each beyond ``tol`` of max|ref| added to ``failures``."""
    worst = 0.0
    for p in outputs:
        scale = max(float(ref[p].abs().max()), 1e-300)
        err = float((got[p].double() - ref[p].double()).abs().max())
        if not err <= tol * scale:
            failures.append('%s %s: error %.3g > %.0e * %.3g' % (
                label, p, err, tol, scale))
        worst = max(worst, err / scale)
    return worst


def chain(calls_):
    """The calls of the linked chain among ``calls_`` (the emitting
    number density call first, then its readers in order), or []."""
    for c in calls_:
        link = c[2].link
        if link is not None and c[2] is link.emitter:
            return [c] + [d for d in calls_ if d[0] == c[0] and
                          d[2] in link.consumers]
    return []


def check_linked(calls_, label, tol, capacity=None):
    """The linked chain of ``calls_`` (``chain``), the emitting call with
    the list's ``capacity`` (default ``crksph_pair.CAPACITY``), against
    the plain version (every output within ``tol`` of max|ref|, each
    dest's pairs equal) and each reading call against the same call
    unlinked (within ``tol`` of max|ref|: the lanes take other pairs than
    the walk's, so the sums round otherwise); the hand-off's list against
    ``neighbours_reference`` cut at the capacity, its counts equal, and
    the overflow counter equal to the dests past the capacity.  Raises on
    a failure; returns the largest scaled errors (against the plain
    version and against the walk), the most pairs a dest and the dests
    that overflowed."""
    calls_ = chain(calls_)
    if len(calls_) != 5:
        raise AssertionError('%s: a chain of %d calls, not 5' % (
            label, len(calls_)))
    failures = []
    worst = worst_walk = 0.0
    (_, _, emitter, first), readers = calls_[0], calls_[1:]
    dev = first[0]['x'].device
    if dev.type == 'cuda':
        cp.reset_overflow(dev)
    got, handoff = emitter.op(*first, counts=True, emit=True,
                              capacity=capacity)
    ref = reference(emitter, first + (True,))
    worst = _errors(got, ref, emitter.outputs, tol, label + ' emit',
                    failures)
    count, positions = pair_link.neighbours_reference(
        first[0], first[1], first[4], first[5])
    most = int(count.max()) if count.numel() else 0
    overflowed = 0
    if dev.type == 'cuda':
        torch.cuda.synchronize()
        cap = handoff.nbr.shape[0]
        overflowed = cp.overflowed(dev)
        listed = pair_link.listed(handoff)[1]
        if not torch.equal(handoff.count, count) or not torch.equal(
                listed, pair_link.cut(count, positions, cap)):
            failures.append('%s: the list differs from neighbours_reference'
                            % label)
        if overflowed != int((count > cap).sum()):
            failures.append('%s: %d dests counted past the capacity %d, %d '
                            'are' % (label, overflowed, cap,
                                     int((count > cap).sum())))
    for _, dest, plan, args in readers:
        name = '%s %s' % (label, SET_NAMES[plan.sources[0].terms])
        got = plan.op(*args, counts=True, handoff=handoff)
        ref = reference(plan, args + (True,))
        walked = plan.op(*args)
        worst = max(worst, _errors(got, ref, plan.outputs, tol, name,
                                   failures))
        worst_walk = max(worst_walk, _errors(
            got, walked, plan.outputs, tol, name + ' against the walk',
            failures))
        if not torch.equal(got['nnbr'], ref['nnbr']):
            failures.append('%s: pair counts differ' % name)
    if failures:
        raise AssertionError('; '.join(failures))
    return dict(max_scaled_err=worst, against_walk=worst_walk,
                most_pairs=most, overflowed=overflowed)


def solve_moments(state, dim):
    """``crk_solve``'s arguments from ``state``'s moments, as
    ``CRKSPHPreStep.post_loop`` hands them."""
    n, d = state['x'].shape[0], dim
    return (state['crk_m0'], state['crk_m1'][:, :d],
            state['crk_m2'][:, :d * d].reshape(n, d, d),
            state['crk_gm0'][:, :d],
            state['crk_gm1'][:, :d * d].reshape(n, d, d),
            state['crk_gm2'][:, :d ** 3].reshape(n, d, d, d),
            state['crk_nnbr'], d)


def check_solve(state, dim, tol, label):
    """``crk_solve`` (the kernel on CUDA tensors) against its plain
    version on ``state``'s moments: every output within ``tol`` of
    max|ref|, and the same particles singular or with fewer than two
    neighbours (A = 1 and zeros).  Raises; returns (the largest absolute
    and scaled errors, the singular particles)."""
    args = solve_moments(state, dim)
    got = cs.crk_solve(*args)
    ref = cs.crk_solve_reference(*args)
    names = ('ai', 'gradai', 'bi', 'gradbi')
    failures = []
    worst = _errors(dict(zip(names, got)), dict(zip(names, ref)), names,
                    tol, label + ' crk_solve', failures)
    worst_abs = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(got, ref))

    def flagged(out):
        ai, gradai, bi, gradbi = out
        n = ai.shape[0]
        return (ai == 1) & (gradai.reshape(n, -1) == 0).all(1) & \
            (bi.reshape(n, -1) == 0).all(1) & \
            (gradbi.reshape(n, -1) == 0).all(1)
    det = cs._inverse(args[2], dim)[0]
    want = (det.abs() < cs.SINGULAR) | (args[6] < 2)
    if not torch.equal(flagged(got) & want, want):
        failures.append('%s crk_solve: %d singular particles, %d flagged' % (
            label, int(want.sum()), int((flagged(got) & want).sum())))
    if failures:
        raise AssertionError('; '.join(failures))
    return worst_abs, worst, int(want.sum())


def chain_times(calls_, reps=20):
    """{what: ms in a CUDA graph} of the six launches as the path runs
    them (``six``: the first evaluator's chain linked, the energy
    walking), the chain alone (``chain``), its emitting launch alone and
    each reading launch alone on a hand-off emitted before."""
    from pysph_tpu_torch.tools_dev.time_walks import run_as_path
    links = chain(calls_)
    (_, _, emitter, first) = links[0]
    out = dict(six=graph_ms(lambda: run_as_path(calls_), reps),
               chain=graph_ms(lambda: run_as_path(links), reps),
               emit=graph_ms(lambda: emitter.op(*first, emit=True), reps))
    handoff = emitter.op(*first, emit=True)[1]
    for _, _, plan, args in links[1:]:
        out[SET_NAMES[plan.sources[0].terms]] = graph_ms(
            lambda plan=plan, args=args: plan.op(*args, handoff=handoff),
            reps)
    return out


def set_times(calls_, plain_reps=3):
    """{set: ms in a CUDA graph, eagerly, the plain version's, the bound
    and its work} of each call."""
    out = {}
    for _, _, plan, args in calls_:
        w = roofline.crksph_work(*args)
        bound_ms, bound_by = roofline.bound(w)
        out[SET_NAMES[plan.sources[0].terms]] = dict(
            ms=graph_ms(lambda: plan.op(*args), 20),
            eager_ms=events_ms(lambda: plan.op(*args), 20),
            plain_ms=events_ms(lambda: reference(plan, args), plain_reps),
            bound_ms=bound_ms, bound_by=bound_by, work=w)
    return out


_KERNEL = re.compile(r'crksph_pair_kernelI([fd])Li\d+ELb([01])ENS_\d+'
                     r'([A-Za-z]+)I[fd]Li\d+ELi(\d)EE+(?:Li(\d)E)?')


def resources(lib=None):
    """{'float32 2D periodic Moments G8': (registers, spill store bytes,
    spill load bytes)} of the default library's kernels (or of ``lib``);
    G: the lanes a dest."""
    lib = build.build('crksph_pair') if lib is None else lib
    out = {}
    for name, res in build.resources(lib).items():
        m = _KERNEL.search(name)
        if m is None:
            continue
        dtype, periodic, cls, dim, lanes = m.groups()
        out['%s %sD %s %s G%s' % (
            'float32' if dtype == 'f' else 'float64', dim,
            'periodic' if periodic == '1' else 'open', cls, lanes)] = res
    return out


def lanes():
    """{set: (lanes a dest in float32, in float64)} of the default
    library."""
    return {SET_NAMES[t]: tuple(cp.lanes(k, dt) for dt in (
        torch.float32, torch.float64)) for k, t in enumerate(
            (cp.NDEN, cp.MOMS, cp.RHO, cp.GRADV, cp.MOM, cp.ENERGY))}
