"""The delta-SPH kernels against their plain versions on the card.

``check(calls, label)`` takes the pair calls of one eval of a delta-SPH
path (``time_walks.plan_calls``) and holds each ``delta_pair`` call, and
each ``wcsph_pair`` call whose sources take the delta-SPH terms, to its
plain version on the same inputs: scaled error <= 1e-10 in float64,
error <= 1e-4 of max|ref| in float32.  The gradient correction's accept
test is a step function, so for each corrected ``delta_pair`` call it
also compares the pairs each dest accepts, kernel (``accepted``) against
the plain version (``delta_pair.accepted_reference``): ``flips`` is the
sum over dests of the difference of the two counts (a lower bound on the
pairs that decide differently) and ``flipped_dests`` the dests whose
counts differ.  Raises where a bar is missed, after printing what it
found.

``check_linked(calls, label)`` runs each linked pair of ``delta_pair``
calls as the path runs it (the moment call emitting its neighbour list,
the gradient call consuming it) and holds it to the two walking calls
bit for bit, the list to ``pair_link.neighbours_reference`` exactly,
and the accept decisions to the plain version's.

``terms_calls(calls)`` gives each ``wcsph_pair`` call with delta-SPH
terms three times: with them, without them, and with them alone (its
plain version then computes only the terms), for timing the terms.
"""

import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import pair_link
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev.common import linked_calls

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DELTA_TERMS = wp.DCONT | wp.DMOM


def has_delta_terms(plan):
    return plan.op is wp.wcsph_pair and any(
        ps.terms & DELTA_TERMS for ps in plan.sources)


def delta_calls_of(calls):
    """The calls of ``calls`` that run delta-SPH: every ``delta_pair``
    call and every ``wcsph_pair`` call with delta-SPH terms."""
    return [c for c in calls
            if c[2].op is dl.delta_pair or has_delta_terms(c[2])]


def terms_calls(calls):
    """[(with the delta terms, without, the terms alone)] argument tuples
    of each ``wcsph_pair`` call with delta-SPH terms."""
    out = []
    for _, _, plan, args in calls:
        if not has_delta_terms(plan):
            continue
        pre = args[3]
        without = [(st, cells, ps._replace(terms=ps.terms & ~DELTA_TERMS))
                   for st, cells, ps in args[4]]
        alone = [(st, cells, ps._replace(terms=ps.terms & DELTA_TERMS))
                 for st, cells, ps in args[4] if ps.terms & DELTA_TERMS]
        only = {p: pre[p] for p in wp.outputs_for(DELTA_TERMS)}
        out.append((args, args[:4] + (without,) + args[5:],
                    args[:3] + (only, alone) + args[5:]))
    return out


def check(calls, label):
    """Holds the delta-SPH calls of ``calls`` to their plain versions;
    returns {max_abs_err, max_scaled_err, flips, flipped_dests, accepted,
    pairs, by_kernel: {name: max abs err}}."""
    found = dict(max_abs_err=0.0, max_scaled_err=0.0, flips=0,
                 flipped_dests=0, accepted=0, pairs=0,
                 by_kernel={'delta_pair': 0.0, 'wcsph_pair': 0.0})
    failures = []
    for k, dest, plan, args in delta_calls_of(calls):
        dtype = args[0]['x'].dtype
        got = plan.op(*args)
        ref = plan.reference(*args)
        torch.cuda.synchronize()
        for p in ref:
            if not bool(torch.isfinite(got[p]).all()) or \
                    not bool(torch.isfinite(ref[p]).all()):
                failures.append('%s.%s not finite' % (dest, p))
                continue
            err = float((got[p] - ref[p]).abs().max())
            scale = max(float(ref[p].abs().max()), 1e-300)
            found['max_abs_err'] = max(found['max_abs_err'], err)
            found['max_scaled_err'] = max(found['max_scaled_err'],
                                          err / scale)
            name = plan.op.__name__
            found['by_kernel'][name] = max(found['by_kernel'][name], err)
            if not err <= TOL[dtype] * scale:
                failures.append('%s %s.%s: error %.3g > %.0e * %.3g' % (
                    name, dest, p, err, TOL[dtype], scale))
        if plan.op is dl.delta_pair and plan.sources[0].terms & dl.CORR:
            n = args[0]['x'].shape[0]
            mine = torch.zeros(n, dtype=torch.int32, device='cuda')
            plan.op(*args, accepted=mine)
            theirs = dl.accepted_reference(args[0], args[1], args[4],
                                           args[5], args[6])
            diff = (mine - theirs).abs()
            found['flips'] += int(diff.sum())
            found['flipped_dests'] += int((diff > 0).sum())
            found['accepted'] += int(theirs.sum())
            src, cells = args[4][0][0], args[4][0][1]
            found['pairs'] += sum(
                int(args[5].neighbor_pairs(args[0], args[1], src, cells, (
                    a, min(n, a + 16384)))[0].numel())
                for a in range(0, n, 16384))
    print('delta-SPH kernels, %s: max abs err %.3g (delta_pair %.3g, '
          'wcsph_pair %.3g), max scaled err %.3g; the correction accepted '
          'in %d of %d pairs by the plain version, %d flips over %d dests'
          % (label, found['max_abs_err'], found['by_kernel']['delta_pair'],
             found['by_kernel']['wcsph_pair'], found['max_scaled_err'],
             found['accepted'], found['pairs'], found['flips'],
             found['flipped_dests']), flush=True)
    if failures:
        raise AssertionError('%s: %s' % (label, '; '.join(failures)))
    return found


def check_linked(calls, label, capacity=None):
    """Each linked pair of ``calls`` run as the path runs it: the moment
    call emitting (``capacity``: the list's, for tests), then the
    gradient call consuming its hand-off.  The moment's output must be
    the walking call's bit for bit, the counts and the listed positions
    those of ``pair_link.neighbours_reference`` exactly (up to the
    capacity), the overflow counter the dests past it, the gradient the
    walking gradient call's bit for bit and within ``TOL`` of the plain
    version, the accepted pairs the walk's and the plain version's (0
    flips), and the pair one pack.  Returns {linked, dests, pairs,
    overflowed, max_count, capacity, flips, packs}; raises where a bar
    is missed, after printing what it found, and for calls on the CPU,
    where the linked gradient runs the plain version, which walks."""
    if not all(c[3][0]['x'].is_cuda for c in calls):
        raise ValueError('check_linked: %s: calls off the card' % label)
    found = dict(linked=0, dests=0, pairs=0, overflowed=0, max_count=0,
                 capacity=0, flips=0, packs=0)
    failures = []
    for (_, dest, _, margs), (_, _, gplan, gargs) in linked_calls(calls):
        n, dev = margs[0]['x'].shape[0], margs[0]['x'].device
        dl.reset_overflow(dev)
        packs = cell_pack.pack.launches
        moment, handoff = dl.delta_pair(*margs, emit=True,
                                        capacity=capacity)
        mine = torch.zeros(n, dtype=torch.int32, device=dev)
        grad = dl.delta_pair(*gargs, handoff=handoff, accepted=mine)
        found['packs'] += cell_pack.pack.launches - packs
        overflowed = dl.overflowed(dev)
        walked = torch.zeros_like(mine)
        same = (torch.equal(moment['m_mat'], dl.delta_pair(*margs)['m_mat'])
                and torch.equal(grad['gradrho'], dl.delta_pair(
                    *gargs, accepted=walked)['gradrho'])
                and torch.equal(mine, walked))
        if not same:
            failures.append('%s: the linked pair differs from the walk'
                            % dest)
        count, positions = pair_link.listed(handoff)
        want, where = pair_link.neighbours_reference(margs[0], margs[1],
                                                     margs[4], margs[5])
        cap = handoff.nbr.shape[0]
        if not (torch.equal(count, want) and
                torch.equal(positions, pair_link.cut(want, where, cap))):
            failures.append('%s: the neighbour list differs from '
                            'neighbours_reference' % dest)
        if overflowed != int((want > cap).sum()):
            failures.append('%s: %d dests counted past the capacity, %d '
                            'are' % (dest, overflowed,
                                     int((want > cap).sum())))
        ref = gplan.reference(*gargs)['gradrho']
        err = float((grad['gradrho'] - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-300)
        if not err <= TOL[ref.dtype] * scale:
            failures.append('%s gradrho: error %.3g > %.0e * %.3g' % (
                dest, err, TOL[ref.dtype], scale))
        theirs = dl.accepted_reference(gargs[0], gargs[1], gargs[4],
                                       gargs[5], gargs[6])
        found['flips'] += int((mine - theirs).abs().sum())
        found['linked'] += 1
        found['dests'] += n
        found['pairs'] += int(want.sum())
        found['overflowed'] += overflowed
        found['max_count'] = max(found['max_count'], int(want.max()))
        found['capacity'] = cap
    if found['packs'] != found['linked']:
        failures.append('%d packs for %d linked pairs' % (found['packs'],
                                                          found['linked']))
    if found['flips']:
        failures.append('%d flipped accept decisions' % found['flips'])
    print('delta_pair linked, %s: %d linked pairs, %d dests, %d pairs; the '
          'list equal to neighbours_reference, the pair equal to the walk '
          'bit for bit; capacity %d, largest count %d, %d dests past it; '
          '%d flips; %d packs' % (
              label, found['linked'], found['dests'], found['pairs'],
              found['capacity'], found['max_count'], found['overflowed'],
              found['flips'], found['packs']), flush=True)
    if failures:
        raise AssertionError('%s: %s' % (label, '; '.join(failures)))
    return found
