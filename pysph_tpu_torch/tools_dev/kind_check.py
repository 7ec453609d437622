"""The later smoothing-kernel kinds in every pair kernel on the card.

    python3 -m pysph_tpu_torch.tools_dev.kind_check

``check(kernel, dtype)`` runs, for one of ``NEW_KINDS`` (a ``--kernel``
choice), the calls of one eval of each path that reaches a pair kernel
that takes kinds, each kernel against its plain version on the same
inputs (scaled error <= 1e-10 in float64, <= 1e-4 of max|ref| in
float32; ``delta_pair``'s flipped accept decisions counted, its linked
pair bit for bit the walk and its list ``neighbours_reference``'s):

- the Taylor-Green vortex at ``nx`` (2D, periodic, from ``--perturb
  0.1`` and perturbed): ``--scheme
  tvf`` (``tvf_pair``), ``gtvf`` (``gtvf_pair``), ``wcsph`` (``wcsph_pair``
  and, on the same calls, ``dense_pair``) and ``wcsph --delta-sph``
  (``delta_pair`` and ``wcsph_pair``'s delta terms, after one eval);
- dam_break_3d at ``dx`` (3D, three sources, perturbed): ``wcsph_pair``
  and ``dense_pair``, and ``--delta-sph``.

``SuperGaussian`` is kind 6 on the Taylor-Green vortex and 7 on the dam
break.  Each kind's library is built at its first launch
(``ops/build.py``), unless built before.
"""

import json
import sys

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.tools_dev import common, delta_check, tvf_check
from pysph_tpu_torch.tools_dev.time_walks import delta_calls, pair_calls

NEW_KINDS = ('WendlandQuinticC4', 'WendlandQuinticC6', 'SuperGaussian')
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _held(found, label, calls, tol, op=None):
    """Each call's kernel (``op``, else the plan's) against its plain
    version, into ``found[label]``."""
    worst_abs, worst = tvf_check.compare(calls, tol, op)
    found[label] = dict(max_abs_err=worst_abs, max_scaled_err=worst,
                        kinds=sorted({kernel_kind(c[3][6]) for c in calls}))


def _delta(found, label, calls):
    err = delta_check.check(calls, label)
    linked = delta_check.check_linked(calls, label)
    found[label] = dict(max_abs_err=err['max_abs_err'],
                        max_scaled_err=err['max_scaled_err'],
                        flips=err['flips'] + linked['flips'],
                        linked=linked['linked'],
                        kinds=sorted({kernel_kind(c[3][6]) for c in calls}))
    if found[label]['flips']:
        raise AssertionError('%s: %d flipped accept decisions'
                             % (label, found[label]['flips']))


def check(kernel, dtype, nx=50, dx=0.04):
    """{label: {max_abs_err, max_scaled_err, kinds[, flips, linked]}} of
    the ``--kernel kernel`` calls above in ``dtype``; raises where a bar
    is missed."""
    flags = ('--kernel', kernel)
    tol = TOL[dtype]
    name = '%s %s' % (kernel, str(dtype)[6:])
    found = {}
    for scheme in ('tvf', 'gtvf', 'wcsph'):
        # every scheme from the jittered lattice (tvf_check.calls jitters
        # all but tvf): on the exact one at h = dx the neighbours three
        # spacings away sit at q = 3, where SuperGaussian is cut with w
        # != 0, and whether they are in support turns on r2's last bit,
        # which the kernel (FMA) and its plain version round apart
        jitter = ('--perturb', '0.1') if scheme == 'tvf' else ()
        calls, _, _ = tvf_check.calls(nx, dtype, scheme=scheme,
                                      flags=flags + jitter)
        label = '%s taylor_green %s nx=%d' % (name, scheme, nx)
        _held(found, label, calls, tol)
        if scheme == 'wcsph':
            _held(found, label + ' dense_pair', calls, tol, dp.dense_pair)
        del calls
    calls, _, _ = tvf_check.calls(nx, dtype, scheme='wcsph',
                                  flags=flags + ('--delta-sph',),
                                  evaluate=True)
    _delta(found, '%s taylor_green wcsph --delta-sph nx=%d' % (name, nx),
           calls)
    calls, _ = pair_calls(dx, dtype, extra=flags)
    label = '%s dam_break_3d dx=%g' % (name, dx)
    _held(found, label, calls, tol)
    _held(found, label + ' dense_pair', calls, tol, dp.dense_pair)
    calls, _, _ = delta_calls(dx, dtype, extra=flags)
    _delta(found, '%s dam_break_3d --delta-sph dx=%g' % (name, dx), calls)
    return found


def main():
    smi = common.require_cuda()
    for kernel in NEW_KINDS:
        for dtype in (torch.float64, torch.float32):
            print(json.dumps(dict(card=smi, kernel=kernel,
                                  dtype=str(dtype)[6:],
                                  found=check(kernel, dtype))), flush=True)


if __name__ == '__main__':
    sys.exit(main())
