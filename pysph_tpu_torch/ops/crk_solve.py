"""``CRKSPHPreStep``'s ``post_loop`` solve: wrapper, launch counter and
plain version.

``crk_solve(m0, m1, m2, gm0, gm1, gm2, nnbr, d)`` gives, from each
particle's reproducing-kernel moments (``m1``, ``gm0`` ``(n, d)``;
``m2`` ``(n, d, d)``; ``gm1[n, g, a]``; ``gm2[n, g, a, b]``), the
correction's ``(ai, gradai, bi, gradbi)``, ``gradbi[n, g, a]``, in closed
form (the cofactors: no ``torch.linalg`` call, whose ``info`` check reads
the card and would break a chunk's CUDA graph); a particle whose ``|det
m2| < SINGULAR`` or that has fewer than 2 neighbours gets ``A = 1`` and
zeros.

For CUDA tensors it launches ``csrc/crk_solve.cu`` once (one thread a
particle, ``d`` 1 to 3, float32 and float64; counted in
``crk_solve.launches``): each moment may be a row-strided view of its
strided prop (the first values of each row, d-packed, as
``CRKSPHPreStep.post_loop`` hands them); another layout or dtype, or a
refused launch, raises.  For CPU tensors it calls
``crk_solve_reference``, ~30 batched torch ops.
"""

import ctypes

import torch

from pysph_tpu_torch.ops import build

#: ``|det m2|`` below which a particle's system is singular
SINGULAR = 1e-14


def _inverse(m, d):
    """(det, inverse) of the ``(n, d, d)`` matrices ``m``, d <= 3, from
    the cofactors."""
    if d == 1:
        det = m[:, 0, 0]
        return det, 1.0 / m
    if d == 2:
        a, b, c, e = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
        det = a * e - b * c
        adj = torch.stack([torch.stack([e, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return det, adj / det[:, None, None]
    if d == 3:
        a = [[m[:, i, j] for j in range(3)] for i in range(3)]
        cof = [[a[(i + 1) % 3][(j + 1) % 3] * a[(i + 2) % 3][(j + 2) % 3] -
                a[(i + 1) % 3][(j + 2) % 3] * a[(i + 2) % 3][(j + 1) % 3]
                for j in range(3)] for i in range(3)]
        det = a[0][0] * cof[0][0] + a[0][1] * cof[0][1] + \
            a[0][2] * cof[0][2]
        # inverse[i][j] = cof[j][i] / det
        adj = torch.stack([torch.stack([cof[j][i] for j in range(3)], -1)
                           for i in range(3)], -2)
        return det, adj / det[:, None, None]
    raise ValueError('CRKSPH solves dim 1 to 3, not %r' % d)


def crk_solve_reference(m0, m1, m2, gm0, gm1, gm2, nnbr, d):
    """Plain torch version of ``crk_solve``: the batched solve."""
    det, _ = _inverse(m2, d)
    singular = torch.abs(det) < SINGULAR
    eye = torch.eye(d, dtype=m2.dtype, device=m2.device).expand(m2.shape)
    _, m2inv = _inverse(torch.where(singular[:, None, None], eye, m2), d)
    c = torch.einsum('nab,nb->na', m2inv, m1)
    ai = 1.0 / (m0 - torch.einsum('na,na->n', c, m1))
    bi = -c
    t1 = (gm0 - torch.einsum('nab,nb,nga->ng', m2inv, m1, gm1) -
          torch.einsum('nab,na,ngb->ng', m2inv, m1, gm1) +
          torch.einsum('ngfs,nf,ns->ng', gm2, c, c))
    gradai = -ai[:, None] * ai[:, None] * t1
    gradbi = (-torch.einsum('nab,ngb->nga', m2inv, gm1) +
              torch.einsum('naf,ngfs,ns->nga', m2inv, gm2, c))
    bad = singular | (nnbr < 2)
    return (torch.where(bad, 1.0, ai),
            torch.where(bad[:, None], 0.0, gradai),
            torch.where(bad[:, None], 0.0, bi),
            torch.where(bad[:, None, None], 0.0, gradbi))


_INPUTS = ('m0', 'm1', 'm2', 'gm0', 'gm1', 'gm2', 'nnbr')


class _Args(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _INPUTS] +
                [(p, ctypes.c_void_p) for p in ('ai', 'gradai', 'bi',
                                                 'gradbi')] +
                [('s_' + p, ctypes.c_int64) for p in _INPUTS] +
                [(k, ctypes.c_int32) for k in ('n', 'dim', 'dtype')])


def _row_stride(t, name, n, d, dtype, dev):
    """The row stride of the moment ``t``: ``(n,)`` or ``(n,) + (d,) *
    k``, its rows' values d-packed; raises for another layout."""
    rank = t.dim() - 1
    if t.shape[:1] != (n,) or t.shape[1:] != (d,) * rank or \
            t.dtype != dtype or t.device != dev or \
            any(t.stride(1 + k) != d ** (rank - 1 - k) for k in range(rank)):
        raise ValueError('crk_solve: %s must be a (%d,) + (%d,) * k %s view '
                         'on %s with its rows d-packed, got %s strides %s '
                         '%s on %s' % (name, n, d, dtype, dev,
                                       tuple(t.shape), t.stride(), t.dtype,
                                       t.device))
    return t.stride(0) if n else 0


def _launch(m0, m1, m2, gm0, gm1, gm2, nnbr, d):
    n, dev, fdt = m0.shape[0], m0.device, m0.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('crk_solve: dtype %s' % fdt)
    if d not in (1, 2, 3):
        raise ValueError('CRKSPH solves dim 1 to 3, not %r' % d)
    args = _Args()
    for name, t in zip(_INPUTS, (m0, m1, m2, gm0, gm1, gm2, nnbr)):
        setattr(args, 's_' + name, _row_stride(t, name, n, d, fdt, dev))
        setattr(args, name, t.data_ptr())
    out = (torch.empty(n, dtype=fdt, device=dev),
           torch.empty((n, d), dtype=fdt, device=dev),
           torch.empty((n, d), dtype=fdt, device=dev),
           torch.empty((n, d, d), dtype=fdt, device=dev))
    for name, t in zip(('ai', 'gradai', 'bi', 'gradbi'), out):
        setattr(args, name, t.data_ptr())
    args.n, args.dim = n, d
    args.dtype = 1 if fdt == torch.float64 else 0
    if n:
        build.launch('crk_solve', args, dev)
        crk_solve.launches += 1
    return out


def crk_solve(m0, m1, m2, gm0, gm1, gm2, nnbr, d):
    """(ai, gradai, bi, gradbi) of the moments (see the module's
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    dev = m0.device
    if dev.type == 'cpu':
        return crk_solve_reference(m0, m1, m2, gm0, gm1, gm2, nnbr, d)
    if dev.type != 'cuda':
        raise ValueError('crk_solve: no kernel for device %s' % dev)
    return _launch(m0, m1, m2, gm0, gm1, gm2, nnbr, d)


#: kernel launches since the last reset
crk_solve.launches = 0
