"""``tvf_pair`` on the Taylor-Green vortex's calls, for the card.

``calls(nx, dtype, edges=False)``: the two pair calls of one eval of
``examples/taylor_green.py`` at ``nx`` (the density and the momentum
launch, as ``time_walks.plan_calls`` gives them) on the card, from a
state with seeded perturbations of the velocities, the transport
velocities, the density, the number density and the pressure (numpy
``default_rng``).  With ``edges``, a seeded tenth of the particles is
moved onto the box's edges and corners (x and y each 0, L, or L less one
part in 1e7), so that the split x ranges at the grid's ends and the
wrapped rows are walked by many lanes.  ``compare(calls, tol)`` holds
the kernel to its plain version on them.  ``chip_smoke.py`` and
``tests/test_torch_tvf_cuda.py`` use them.
"""

import numpy as np
import torch

from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.tools_dev.time_walks import make_app, plan_calls


def perturb(states, seed=12345):
    """Seeded velocities, transport velocities and 1-2% jitters of rho,
    V and p of the fluid."""
    st = states['fluid']
    rng = np.random.default_rng(seed)
    n = st['x'].shape[0]

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    for p in ('u', 'v', 'uhat', 'vhat'):
        st[p] = t(rng.normal(0.0, 0.5, n))
    st['rho'] = t(1.0 + 0.01 * rng.normal(size=n))
    st['V'] = st['V'] * t(1.0 + 0.02 * rng.normal(size=n))
    st['p'] = t(2.0 * rng.normal(size=n))


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


def calls(nx, dtype, edges=False):
    """(calls, particles, particles moved onto the edges) of one eval at
    ``nx`` on the card (``perturb``ed; ``on_edges`` with ``edges``)."""
    s = make_app(None, dtype, cls=TaylorGreen,
                 extra=('--nx', str(nx))).solver
    perturb(s.states)
    moved = on_edges(s.states, s.domain) if edges else 0
    n = s.states['fluid']['x'].shape[0]
    return plan_calls(s, [0]), n, moved


def compare(calls_, tol):
    """The largest absolute and scaled errors of the kernel against its
    plain version over the calls' outputs; raises past ``tol`` of
    max|ref|."""
    worst_abs = worst = 0.0
    for _, dest, plan, args in calls_:
        got = plan.op(*args)
        ref = plan.reference(*args)
        torch.cuda.synchronize()
        for p in plan.outputs:
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p] - ref[p]).abs().max())
            if not err <= tol * scale:
                raise AssertionError('tvf_pair %s.%s: error %.3g > %.0e * '
                                     '%.3g' % (dest, p, err, tol, scale))
            worst_abs, worst = max(worst_abs, err), max(worst, err / scale)
    return worst_abs, worst
