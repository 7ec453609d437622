"""IISPH's pair calls, for the card: ``iisph_pair``'s on the scheme's
three runs.

``RUNS``: the reference's three IISPH runs, ``examples/taylor_green.py``
(a box periodic in x and y), ``examples/elliptical_drop.py`` and
``examples/dam_break_2d.py`` (walls) with ``--scheme iisph``, each with
its size argument.

``calls(run, size, dtype, edges=False, steps=3, engine='kernel',
device='cuda', solve=False)``: every pair call of one evaluation of
``run`` at ``size`` (``--nx`` or ``--dx``), as the evaluator makes it, on
its own inputs (``record``: the density, advection and advected-density
calls, each sweep's ``dijpj`` and pressure calls (the evaluator's host
loop, the per-launch chain), the force call; with ``solve``, the
``iisph_solve`` call of the pressure group in place of the sweeps'
calls, as the path runs it), from the
run's state after ``steps`` steps of a start whose fluid positions are
jittered by up to a tenth of dx and velocities seeded (numpy
``default_rng``); with ``edges``, a seeded tenth of the fluid is then
moved onto the edges and corners of its box (the periodic box of the
Taylor-Green vortex, the fluid's lattice box else), so that the split x
ranges at a periodic grid's ends and the wrapped rows, or the cells at
the walls, are walked by many lanes.

``run_as_path(calls)`` runs the calls as the evaluator does;
``check_linked(calls, label, tol)`` runs each link of the calls as the
path runs it (the emitting call, then every later call of the dest on
its hand-off): each output the walking call's bit for bit, the list
``pair_link.neighbours_reference``'s exactly (up to the capacity), the
overflow counter the dests past it, each output within ``tol`` of
max|ref| of the plain version, and one pack a call.  ``resources(lib,
kind, periodic)``: the kernels' registers and spills.
``check_solve(call, label, tol)`` holds a recorded ``iisph_solve`` call
to its plain version (within ``tol`` of max|ref|, the same sweeps) and,
where the sweeps agree, to the per-launch chain bit for bit
(``iisph_solve_reference`` over ``iisph_pair`` on the hand-off), each at
the call's tolerance and at ones that force ``max_iterations`` sweeps and
stop at ``min_iterations``.  ``chip_smoke.py`` and
``tests/test_torch_iisph_cuda.py`` use them.
"""

import importlib
import re

import numpy as np
import torch

from pysph_tpu_torch.ops import cell_pack, pair_link
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops import iisph_solve as isv
from pysph_tpu_torch.ops.pair_engine import SolvePlan
from pysph_tpu_torch.tools_dev.tvf_check import _within, reference

#: {run: (module, application class, size argument, wall array or None)}
RUNS = {
    'taylor_green': ('taylor_green', 'TaylorGreen', '--nx', None),
    'elliptical_drop': ('elliptical_drop', 'EllipticalDrop', '--nx', None),
    'dam_break_2d': ('dam_break_2d', 'DamBreak2D', '--dx', 'boundary'),
}


def app(run, size, dtype, steps=0, engine='kernel', device='cuda',
        extra=()):
    """``run``'s application with ``--scheme iisph`` at ``size`` on
    ``device``."""
    module, name, arg, _ = RUNS[run]
    cls = getattr(importlib.import_module('pysph_tpu_torch.examples.'
                                          + module), name)
    argv = ['--scheme', 'iisph', '--disable-output', '-q', '--device',
            device, '--engine', engine, arg, str(size), *extra]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    a = cls()
    a.setup(argv)
    return a


def _box(st, domain):
    """The box of the fluid: the domain's where there is one, else its
    lattice's extreme positions widened by half its spacing; and dx."""
    dx = float(torch.sqrt(st['m'][0] / st['rho'][0]))
    if domain is not None:
        return [(domain.mins[d], domain.mins[d] + domain.lengths[d])
                for d in range(2)], dx
    return [(float(st[c].min()) - 0.5 * dx, float(st[c].max()) + 0.5 * dx)
            for c in 'xy'], dx


def jitter(s, seed=1357):
    """The fluid's positions moved by up to a tenth of dx and its
    velocities by a seeded tenth of their largest magnitude (1 m/s where
    they are 0: the dam break's start)."""
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]
    _, dx = _box(st, None)

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    scale = float(torch.sqrt(st['u'] ** 2 + st['v'] ** 2).max()) or 1.0
    for c in ('x', 'y'):
        st[c] = st[c] + t(0.1 * dx * rng.uniform(-1, 1, n))
    for c in ('u', 'v'):
        st[c] = st[c] + t(0.1 * scale * rng.normal(size=n))


def on_edges(s, seed=97531, share=0.1):
    """A seeded ``share`` of the fluid moved onto its box's edges and
    corners (``_box``): each of x and y set to the box's lower end, upper
    end, or upper end less one part in 1e7, or kept."""
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]
    box, _ = _box(st, s.domain)
    pick = rng.random(n) < share
    for d, c in enumerate('xy'):
        lo, hi = box[d]
        where = rng.integers(0, 4, n)
        vals = np.choose(np.minimum(where, 2),
                         [lo, hi, hi - (hi - lo) * 1e-7])
        x = st[c].cpu().numpy().copy()
        sel = pick & (where < 3)
        x[sel] = vals[sel]
        st[c] = torch.as_tensor(x, dtype=st[c].dtype, device=st[c].device)
    return int(pick.sum())


def record(a_eval):
    """Record every planned pair call of ``a_eval`` as it runs: returns
    the list it fills with (index, dest, plan, arguments), the arguments
    those of the call (the dest's and sources' states as they were, the
    outputs' values before the phase, the step's dt); an ``iisph_solve``
    call as (index, dest, ``SolvePlan``, its arguments, no log);
    ``forget`` ends the recording."""
    calls = []
    for plan in a_eval._solves.values():
        def solve(states, cells, grid, dt, active=None, log=None,
                  plan=plan, run=plan.execute):
            snap = {name: dict(st) for name, st in states.items()}
            calls.append((len(calls), plan.dest, plan,
                          plan.args(snap, cells, grid, dt, active)))
            run(states, cells, grid, dt, active, log)
        plan.execute = solve
    for plan in a_eval._plans.values():
        if plan is None:
            continue

        def execute(store, states, cells, grid, write_mask, dt=0.0, t=0.0,
                    plan=plan, run=plan.execute):
            pre = {p: store[p] for p in plan.outputs}
            snap = {name: dict(st) for name, st in states.items()}
            calls.append((len(calls), plan.dest, plan, plan.args(
                dict(store), snap, cells, grid, write_mask, pre, dt, t)))
            run(store, states, cells, grid, write_mask, dt, t=t)
        plan.execute = execute
    return calls


def forget(a_eval):
    for plan in list(a_eval._plans.values()) + list(a_eval._solves.values()):
        if plan is not None:
            plan.__dict__.pop('execute', None)


def calls(run, size, dtype, edges=False, steps=3, engine='kernel',
          device='cuda', solve=False):
    """(calls, particles, particles moved onto the edges, sweeps of the
    eval) of one evaluation of ``run`` at ``size`` (``record``), from
    its state after ``steps`` steps of a ``jitter``ed start, with
    ``edges`` a tenth of the fluid then ``on_edges``; the pressure
    group's sweeps as the per-launch chain, or with ``solve`` as the
    path's ``iisph_solve`` call."""
    s = app(run, size, dtype, steps=steps, engine=engine,
            device=device).solver
    jitter(s)
    if steps:
        s.solve()
    moved = on_edges(s) if edges else 0
    a_eval = s.acceleration_evals[0]
    found = record(a_eval)
    a_eval.solve_iterated = solve
    try:
        a_eval.update_and_compute(s.t, s.dt, s.states)
    finally:
        forget(a_eval)
        a_eval.solve_iterated = True
    n = sum(st['x'].shape[0] for st in s.states.values())
    return found, n, moved, a_eval.sweeps[-1]


def solve_calls(calls_):
    """The ``iisph_solve`` calls among ``calls_``."""
    return [c for c in calls_ if isinstance(c[2], SolvePlan)]


def pair_calls(calls_):
    """The ``iisph_pair`` calls among ``calls_``."""
    return [c for c in calls_ if not isinstance(c[2], SolvePlan)]


def _deterministic(fn):
    """``fn()`` with torch's deterministic algorithms on (the plain
    versions' ``index_add_`` on the card, as ``tvf_check.reference``)."""
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


#: the tolerances of ``check_solve`` beside the call's own: one no mean
#: compression meets (below 0: ``max_iterations`` sweeps; a small positive
#: one is met where the mean rounds to rho0 exactly) and one every one
#: meets (the loop stops at ``min_iterations``)
FORCED = {'max': -1.0, 'min': 1e3}
#: how near its tolerance, relative, a mean compression may lie where the
#: kernel's sweeps and its plain version's differ: their sums of
#: ``compression`` run in another order
MARGIN = {torch.float32: 1e-5, torch.float64: 1e-12}


def with_tolerance(args, tolerance):
    """An ``iisph_solve`` call's arguments with another tolerance."""
    spec = args[8]._replace(tolerance=tolerance)
    return args[:8] + (spec,) + args[9:]


def chain(args):
    """The per-launch chain of an ``iisph_solve`` call on the card:
    ``iisph_pair``'s ``dijpj`` and pressure launches on the call's
    hand-off each sweep, the torch ``post_loop`` and ``reduce`` between,
    ``converged`` read on the host."""
    return isv.iisph_solve_reference(*args[:12], pair=ip.iisph_pair)


def _margin(out, spec):
    """The distance of the last sweep's mean compression from the
    tolerance."""
    count, total = out['tmp_comp'].double().tolist()
    return abs(total / max(count, 1.0) - spec.rho0) / spec.rho0 - \
        spec.tolerance


def check_solve(call, label, tol, blocks=0):
    """A recorded ``iisph_solve`` call (``calls(..., solve=True)``) at its
    own tolerance and at those of ``FORCED``: the kernel (``blocks``: its
    grid, 0 as it chooses) against its plain version (every output within
    ``tol`` of max|ref|, the same sweeps; at its own tolerance the sweeps
    may differ only where the mean compression lies within ``MARGIN`` of
    it, which is printed), and against the per-launch chain (``chain``):
    where the sweeps agree ``p``, ``piter``, ``compression`` and
    ``dijpj`` bit for bit, where they differ the mean compression's
    distance from the tolerance printed; raises where a bar is missed.
    Returns {case: {sweeps, reference_sweeps, chain_sweeps, max_abs_err,
    bitwise, tmp_comp_err, margin}}."""
    _, dest, plan, args = call
    if not args[0]['x'].is_cuda:
        raise ValueError('check_solve: %s: a call off the card' % label)
    out, failures = {}, []
    cases = {'own': args[8].tolerance, **FORCED}
    for case, tolerance in cases.items():
        a = with_tolerance(args, tolerance)
        before = isv.iisph_solve.launches
        got, k = isv.iisph_solve(*a, blocks=blocks)
        if isv.iisph_solve.launches != before + 1:
            failures.append('%s: %d launches' % (case, isv.iisph_solve.launches
                                                 - before))
        ref, kr = _deterministic(
            lambda: isv.iisph_solve_reference(*a[:12]))
        got_chain, kc = chain(a)
        k, kr, kc = int(k), int(kr), int(kc)
        row = dict(sweeps=k, reference_sweeps=kr, chain_sweeps=kc)
        if k != kr:
            row['margin'] = margin = _margin(got, a[8])
            print('%s %s: %d sweeps, the plain version %d: the mean '
                  'compression %.6g from the tolerance' % (
                      label, case, k, kr, margin), flush=True)
            if case != 'own' or not abs(margin) <= MARGIN[got['p'].dtype]:
                failures.append('%s: %d sweeps, the plain version %d'
                                % (case, k, kr))
        else:
            row['max_abs_err'] = _within('%s %s' % (dest, case), got, ref,
                                         tol, failures)
        if k == kc:
            row['bitwise'] = all(torch.equal(got[p], got_chain[p])
                                 for p in isv.OUTPUTS[:-1])
            row['tmp_comp_err'] = float((got['tmp_comp'] -
                                         got_chain['tmp_comp']).abs().max())
            if not row['bitwise']:
                failures.append('%s: %s differ from the per-launch chain' % (
                    case, [p for p in isv.OUTPUTS[:-1]
                           if not torch.equal(got[p], got_chain[p])]))
        else:
            row['margin'] = margin = _margin(got, a[8])
            print('%s %s: %d sweeps, the per-launch chain %d: the mean '
                  'compression %.6g from the tolerance' % (
                      label, case, k, kc, margin), flush=True)
        if case == 'max' and k != args[8].max_iterations or \
                case == 'min' and k != max(1, args[8].min_iterations):
            failures.append('%s: %d sweeps' % (case, k))
        out[case] = row
    print('iisph_solve, %s: %s' % (label, out), flush=True)
    if failures:
        raise AssertionError('%s: %s' % (label, '; '.join(failures)))
    return out


def chains(calls_):
    """[(emitting call, [every later call of its link])] of the links
    among ``calls_``, in order."""
    out = []
    for c in calls_:
        link = c[2].link
        if link is not None and c[2] is link.emitter:
            plans = set(map(id, link.consumers))
            out.append((c, [d for d in calls_ if d[0] > c[0] and
                            id(d[2]) in plans]))
    return out


def run_as_path(calls_, capacity=None):
    """The outputs of ``calls_`` (``calls``') as the evaluator runs their
    plans: each link's emitting call emits, every later call of the link
    reads its hand-off, the others walk, an ``iisph_solve`` call reads
    the hand-off of its link; in order."""
    out, handoffs = [], {}
    for _, _, plan, args in calls_:
        if isinstance(plan, SolvePlan):
            handoff = handoffs[id(plan.solve.link)]
            out.append(isv.iisph_solve(*args[:9], handoff, *args[10:]))
            continue
        link = plan.link
        if link is None:
            out.append(plan.op(*args))
        elif plan is link.emitter:
            got, handoffs[id(link)] = plan.op(*args, emit=True,
                                              capacity=capacity)
            out.append(got)
        else:
            out.append(plan.op(*args, handoff=handoffs[id(link)]))
    return out


def check_linked(calls_, label, tol, capacity=None):
    """Each link of ``calls_`` run as the path runs it: the emitting call
    (``capacity``: the list's, for tests), then every later call of the
    link on its hand-off.  Every output must be the walking call's bit
    for bit, the counts and the listed positions those of
    ``pair_link.neighbours_reference`` exactly (up to the capacity), the
    overflow counter the dests past it, every output within ``tol`` of
    max|ref| of the plain version, and each call one pack.  Returns
    {linked, consumers, dests, pairs, overflowed, max_count, capacity,
    packs, max_abs_err}; raises where a bar is missed, after printing
    what it found, and for calls off the card."""
    if not all(c[3][0]['x'].is_cuda for c in calls_):
        raise ValueError('check_linked: %s: calls off the card' % label)
    found = dict(linked=0, consumers=0, dests=0, pairs=0, overflowed=0,
                 max_count=0, capacity=0, packs=0, max_abs_err=0.0)
    failures = []
    op = ip.iisph_pair
    for (_, dest, eplan, eargs), later in chains(calls_):
        n, dev = eargs[0]['x'].shape[0], eargs[0]['x'].device
        ip.reset_overflow(dev)
        packs = cell_pack.pack.launches
        first, handoff = op(*eargs, emit=True, capacity=capacity)
        got = [(c, op(*c[3], handoff=handoff)) for c in later]
        found['packs'] += cell_pack.pack.launches - packs
        overflowed = ip.overflowed(dev)
        for (k, _, plan, args), out in [((0, dest, eplan, eargs), first)] \
                + got:
            walked = op(*args)
            if any(not torch.equal(out[p], walked[p]) for p in walked):
                failures.append('%s: linked call %d (terms %#x) differs from '
                                'the walk' % (dest, k, sum(
                                    ps.terms for ps in plan.sources)))
            found['max_abs_err'] = max(found['max_abs_err'], _within(
                '%s call %d' % (dest, k), out, reference(plan, args), tol,
                failures))
        count, positions = pair_link.listed(handoff)
        want, where = pair_link.neighbours_reference(eargs[0], eargs[1],
                                                     eargs[4], eargs[5])
        cap = handoff.nbr.shape[0]
        if not (torch.equal(count, want) and
                torch.equal(positions, pair_link.cut(want, where, cap))):
            failures.append('%s: the neighbour list differs from '
                            'neighbours_reference' % dest)
        if overflowed != int((want > cap).sum()):
            failures.append('%s: %d dests counted past the capacity, %d '
                            'are' % (dest, overflowed,
                                     int((want > cap).sum())))
        found['linked'] += 1
        found['consumers'] += len(later)
        found['dests'] += n
        found['pairs'] += int(want.sum())
        found['overflowed'] += overflowed
        found['max_count'] = max(found['max_count'], int(want.max()))
        found['capacity'] = cap
    if found['packs'] != found['linked'] + found['consumers']:
        failures.append('%d packs for %d links with %d consuming calls'
                        % (found['packs'], found['linked'],
                           found['consumers']))
    print('iisph_pair linked, %s: %d links (%d consuming calls), %d dests, '
          '%d pairs; the list equal to neighbours_reference, every call '
          'equal to the walk bit for bit, max abs err %.3g against the '
          'plain version; capacity %d, largest count %d, %d dests past it; '
          '%d packs' % (
              label, found['linked'], found['consumers'], found['dests'],
              found['pairs'], found['max_abs_err'], found['capacity'],
              found['max_count'], found['overflowed'], found['packs']),
          flush=True)
    if not found['linked']:
        failures.append('no link among the calls')
    if failures:
        raise AssertionError('%s: %s' % (label, '; '.join(failures)))
    return found


#: the phase sets' functors, as csrc/iisph_pair.cu names them
SETS = ('Density', 'Advection', 'RhoAdv', 'Dijpj', 'Solve', 'Force')
_KERNEL = re.compile(r'iisph_pair_kernelI([fd])Li(\d)ELb([01])E\w*?'
                     r'(%s)I[fd](?:Lb0E)?EELi(\d)E' % '|'.join(SETS))
_SOLVE = re.compile(r'iisph_solve_kernelI([fd])Li(\d)ELb([01])E')
_MODES = {ip.WALK: 'walk', ip.CONSUME: 'consume'}


def resources(lib, kind=3, periodic=False):
    """{'<dtype> <phase set> <mode>': (registers, spill store bytes,
    spill load bytes)} of the kernels of the shape ``kind``
    (``kernel_kind``; 3: ``QuinticSpline``) on a periodic grid
    (``periodic``; else on an open one) in the built ``iisph_pair``
    library ``lib`` (``build.resources``)."""
    from pysph_tpu_torch.ops import build
    out = {}
    for name, res in build.resources(lib).items():
        m = _KERNEL.search(name)
        if not m or int(m.group(2)) != kind or \
                m.group(3) != str(int(periodic)):
            continue
        out['%s %s %s' % ('float32' if m.group(1) == 'f' else 'float64',
                          m.group(4).lower(), _MODES[int(m.group(5))])] = res
    return dict(sorted(out.items()))


def solve_resources(lib):
    """{'<dtype> kind <k> <periodic|open>': (registers, spill store
    bytes, spill load bytes)} of the built ``iisph_solve`` library's
    kernels."""
    from pysph_tpu_torch.ops import build
    out = {}
    for name, res in build.resources(lib).items():
        m = _SOLVE.search(name)
        if m:
            out['%s kind %s %s' % (
                'float32' if m.group(1) == 'f' else 'float64', m.group(2),
                'periodic' if m.group(3) == '1' else 'open')] = res
    return dict(sorted(out.items()))
