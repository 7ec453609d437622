"""The Taylor-Green vortex's pair calls, for the card: ``tvf_pair``'s,
and those of its other schemes (``wcsph_pair``, ``dense_pair``,
``gtvf_pair``).

``calls(nx, dtype, edges=False, scheme='tvf', engine='kernel')``: the
pair calls of one eval of ``examples/taylor_green.py --scheme <scheme>``
at ``nx`` (for ``tvf`` the density and the momentum launch; for
``gtvf`` those of both evaluators), as ``time_walks.plan_calls`` gives
them, on the card, from a state with seeded perturbations of the
velocities, the transport velocities, the density, the number density
and the pressure (numpy ``default_rng``; the props the scheme's arrays
hold).  With ``edges``, a seeded tenth of the particles is
moved onto the box's edges and corners (x and y each 0, L, or L less one
part in 1e7), so that the split x ranges at the grid's ends and the
wrapped rows are walked by many lanes.  ``compare(calls, tol)`` holds
the kernel to its plain version on them; ``check_linked(calls, label)``
holds the linked pair (the density call emitting its neighbour list,
the momentum call consuming it) to the two walking calls bit for bit,
the list to ``pair_link.neighbours_reference`` exactly and both outputs
to the plain version.  ``chip_smoke.py``, ``tests/test_torch_tvf_cuda.py``
and ``tests/test_torch_tg_schemes_cuda.py`` use them.
"""

import re

import numpy as np
import torch

from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import cell_pack, pair_link
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev.common import linked_calls
from pysph_tpu_torch.tools_dev.time_walks import make_app, plan_calls


def perturb(states, seed=12345):
    """Seeded velocities, transport velocities and 1-2% jitters of rho,
    V and p of the fluid; where the fluid holds GTVF's ``rho0`` and
    ``p0``, the values its groups' ``initialize`` give them (``rho0 =
    rho``, ``p0 = min(10 |p|, p_ref)``, ``p_ref`` the example's 100), so
    that ``CorrectDensity`` divides by no 0 and the h/2 gradient counts."""
    st = states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    for p in ('u', 'v', 'uhat', 'vhat'):
        draw = t(rng.normal(0.0, 0.5, n))
        if p in st:
            st[p] = draw
    st['rho'] = t(1.0 + 0.01 * rng.normal(size=n))
    draw = t(1.0 + 0.02 * rng.normal(size=n))
    if 'V' in st:
        st['V'] = st['V'] * draw
    st['p'] = t(2.0 * rng.normal(size=n))
    if 'rho0' in st:
        st['rho0'] = st['rho'].clone()
    if 'p0' in st:
        st['p0'] = torch.clamp(10.0 * st['p'].abs(), max=100.0)


def on_edges(states, domain, seed=54321, share=0.1):
    """A seeded ``share`` of the fluid moved onto the box's edges and
    corners: each of x and y set to its box's lower end, upper end, or
    upper end less one part in 1e7, or kept."""
    st = states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]
    pick = rng.random(n) < share
    for d, c in enumerate('xy'):
        lo, L = domain.mins[d], domain.lengths[d]
        where = rng.integers(0, 4, n)
        vals = np.choose(np.minimum(where, 2),
                         [lo, lo + L, lo + L * (1.0 - 1e-7)])
        x = st[c].cpu().numpy().copy()
        sel = pick & (where < 3)
        x[sel] = vals[sel]
        st[c] = torch.as_tensor(x, dtype=st[c].dtype, device=st[c].device)
    return int(pick.sum())


def calls(nx, dtype, edges=False, scheme='tvf', engine='kernel', flags=(),
          evaluate=False):
    """(calls, particles, particles moved onto the edges) of one eval of
    every evaluator of ``scheme`` (with the example's further arguments
    ``flags``, such as ``--delta-sph``) on ``engine`` at ``nx`` on the
    card (``perturb``ed; ``on_edges`` with ``edges``; with ``evaluate``,
    after one initial evaluation, so that what the groups derive before
    the pair phases, delta-SPH's ``m_mat`` and ``gradrho``, is the
    path's).  The schemes but ``tvf`` start from positions jittered by a
    tenth of dx (``--perturb 0.1``): on the lattice GTVF's ``auhat``, a
    sum of kernel gradients under factors of the dest's alone, cancels to
    rounding."""
    jitter = () if scheme == 'tvf' else ('--perturb', '0.1')
    s = make_app(None, dtype, cls=TaylorGreen, engine=engine,
                 extra=('--nx', str(nx), '--scheme', scheme) + jitter +
                 tuple(flags)).solver
    perturb(s.states)
    moved = on_edges(s.states, s.domain) if edges else 0
    if evaluate:
        s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    n = s.states['fluid']['x'].shape[0]
    return plan_calls(s, range(len(s.acceleration_evals))), n, moved


def compare(calls_, tol, op=None):
    """The largest absolute and scaled errors of the kernel (``op``, else
    the plan's) against its plain version over the calls' outputs (over
    the finite entries of the plain version, whose infinities the kernel
    must match exactly); raises past ``tol`` of max|ref|."""
    worst_abs = worst = 0.0
    for _, dest, plan, args in calls_:
        kernel = op or plan.op
        got = kernel(*args)
        ref = plan.reference(*args)
        torch.cuda.synchronize()
        for p in plan.outputs:
            fin = torch.isfinite(ref[p])
            if not (torch.equal(torch.isfinite(got[p]), fin) and
                    torch.equal(got[p][~fin], ref[p][~fin])):
                raise AssertionError('%s %s.%s: non-finite entries differ'
                                     % (kernel.__name__, dest, p))
            if not bool(fin.any()):
                continue
            scale = max(float(ref[p][fin].abs().max()), 1e-300)
            err = float((got[p][fin] - ref[p][fin]).abs().max())
            if not err <= tol * scale:
                raise AssertionError('%s %s.%s: error %.3g > %.0e * %.3g'
                                     % (kernel.__name__, dest, p, err, tol,
                                        scale))
            worst_abs, worst = max(worst_abs, err), max(worst, err / scale)
    return worst_abs, worst


_KERNEL = re.compile(r'tvf_pair_kernelI([fd])Li3ELb1E\w*?(Density|Momentum)'
                     r'I[fd]EELi(\d)E')
_MODES = {tp.WALK: 'walk', tp.EMIT: 'emit', tp.CONSUME: 'consume'}


def resources(lib):
    """{'<dtype> <phase set> <mode>': (registers, spill store bytes, spill
    load bytes)} of the path's kernels (``QuinticSpline``, periodic) in
    the built ``tvf_pair`` library ``lib`` (``build.resources``)."""
    from pysph_tpu_torch.ops import build
    out = {}
    for name, res in build.resources(lib).items():
        m = _KERNEL.search(name)
        if m:
            out['%s %s %s' % ('float32' if m.group(1) == 'f' else 'float64',
                              m.group(2).lower(),
                              _MODES[int(m.group(3))])] = res
    return dict(sorted(out.items()))


def _within(label, got, ref, tol, failures):
    """The largest absolute error of ``got`` against ``ref`` over their
    outputs; a failure where one passes ``tol`` of max|ref|."""
    worst = 0.0
    for p, want in ref.items():
        scale = max(float(want.abs().max()), 1e-300)
        err = float((got[p] - want).abs().max())
        if not err <= tol * scale:
            failures.append('%s.%s: error %.3g > %.0e * %.3g' % (
                label, p, err, tol, scale))
        worst = max(worst, err)
    return worst


def check_linked(calls, label, tol, capacity=None):
    """Each linked pair of ``calls`` run as the path runs it: the
    density call emitting (``capacity``: the list's, for tests), then
    the momentum call consuming its hand-off.  The density output must
    be the walking call's bit for bit, the counts and the listed
    positions those of ``pair_link.neighbours_reference`` exactly (up to
    the capacity), the overflow counter the dests past it, the momentum
    output the walking momentum call's bit for bit, both within ``tol``
    of max|ref| of the plain version, and each call one pack.  Returns
    {linked, dests, pairs, overflowed, max_count, capacity, packs,
    max_abs_err}; raises where a bar is missed, after printing what it
    found, and for calls on the CPU, where the consuming call runs the
    plain version, which walks."""
    if not all(c[3][0]['x'].is_cuda for c in calls):
        raise ValueError('check_linked: %s: calls off the card' % label)
    found = dict(linked=0, dests=0, pairs=0, overflowed=0, max_count=0,
                 capacity=0, packs=0, max_abs_err=0.0)
    failures = []
    for (_, dest, dplan, dargs), (_, _, mplan, margs) in linked_calls(calls):
        n, dev = dargs[0]['x'].shape[0], dargs[0]['x'].device
        tp.reset_overflow(dev)
        packs = cell_pack.pack.launches
        density, handoff = tp.tvf_pair(*dargs, emit=True, capacity=capacity)
        momentum = tp.tvf_pair(*margs, handoff=handoff)
        found['packs'] += cell_pack.pack.launches - packs
        overflowed = tp.overflowed(dev)
        for what, got, walked in (
                ('density', density, tp.tvf_pair(*dargs)),
                ('momentum', momentum, tp.tvf_pair(*margs))):
            if any(not torch.equal(got[p], walked[p]) for p in walked):
                failures.append('%s: the linked %s call differs from the '
                                'walk' % (dest, what))
        count, positions = pair_link.listed(handoff)
        want, where = pair_link.neighbours_reference(dargs[0], dargs[1],
                                                     dargs[4], dargs[5])
        cap = handoff.nbr.shape[0]
        if not (torch.equal(count, want) and
                torch.equal(positions, pair_link.cut(want, where, cap))):
            failures.append('%s: the neighbour list differs from '
                            'neighbours_reference' % dest)
        if overflowed != int((want > cap).sum()):
            failures.append('%s: %d dests counted past the capacity, %d '
                            'are' % (dest, overflowed,
                                     int((want > cap).sum())))
        for plan, args, got in ((dplan, dargs, density),
                                (mplan, margs, momentum)):
            found['max_abs_err'] = max(found['max_abs_err'], _within(
                dest, got, plan.reference(*args), tol, failures))
        found['linked'] += 1
        found['dests'] += n
        found['pairs'] += int(want.sum())
        found['overflowed'] += overflowed
        found['max_count'] = max(found['max_count'], int(want.max()))
        found['capacity'] = cap
    if found['packs'] != 2 * found['linked']:
        failures.append('%d packs for %d linked pairs' % (found['packs'],
                                                          found['linked']))
    print('tvf_pair linked, %s: %d linked pairs, %d dests, %d pairs; the '
          'list equal to neighbours_reference, both calls equal to the '
          'walk bit for bit, max abs err %.3g against the plain version; '
          'capacity %d, largest count %d, %d dests past it; %d packs' % (
              label, found['linked'], found['dests'], found['pairs'],
              found['max_abs_err'], found['capacity'], found['max_count'],
              found['overflowed'], found['packs']), flush=True)
    if not found['linked']:
        failures.append('no linked pair among the calls')
    if failures:
        raise AssertionError('%s: %s' % (label, '; '.join(failures)))
    return found
