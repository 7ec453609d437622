"""Small linear-algebra helpers for equations (port of
``pysph_tpu/sph/wc/linalg.py``).

``mat`` arguments are tensors whose *last* one or two axes are the
matrix axes, with any leading batch shape.  ``small_solve_cols`` is the
closed-form adjugate solve of the per-pair gradient correction: plain
multiplications, subtractions and divisions in a fixed order, which
``csrc/delta_pair.cu`` repeats operation for operation.
"""

import torch


def identity(n, batch_shape=(), dtype=torch.float64, device=None):
    """n x n identity, optionally batched."""
    return torch.eye(n, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (n, n))


def dot(a, b, n=None):
    """Dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def mat_mult(a, b, n=None):
    """Matrix multiply over the trailing axes."""
    return a @ b


def mat_vec_mult(a, b, n=None):
    """Matrix-vector multiply over the trailing axes."""
    return torch.einsum('...ij,...j->...i', a, b)


def augmented_matrix(A, b, n=None, na=1, nmax=None):
    """[A | b]."""
    if b.dim() == A.dim() - 1:
        b = b[..., None]
    return torch.cat([A, b], dim=-1)


def gj_solve(A, b=None, n=None, nb=1):
    """Solve A x = b, batched; a singular system (|det| <= 1e-30) gives
    zeros.  Without ``b``, ``A`` is the augmented [A | b]."""
    if b is None:
        m = A.shape[-1] - 1
        b = A[..., m]
        A = A[..., :m]
    det = torch.linalg.det(A)
    ok = torch.abs(det) > 1e-30
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    A_safe = torch.where(ok[..., None, None], A, eye)
    x = torch.linalg.solve_ex(A_safe, b[..., None])[0][..., 0]
    return torch.where(ok[..., None], x, 0.0)


def small_solve_cols(a, w, n, tiny=1e-30):
    """Solve ``A x = w`` for n in (1, 2, 3) with the closed-form adjugate.

    ``a``: nested list ``a[i][j]`` of broadcast-compatible tensors; ``w``:
    list of n tensors.  Where ``|det| <= tiny`` the result is ``w``
    unchanged (the callers' tolerance test then keeps the uncorrected
    gradient)."""
    if n == 1:
        det = a[0][0]
        ok = torch.abs(det) > tiny
        d = torch.where(ok, det, 1.0)
        return [torch.where(ok, w[0] / d, w[0])]
    if n == 2:
        det = a[0][0] * a[1][1] - a[0][1] * a[1][0]
        ok = torch.abs(det) > tiny
        d = torch.where(ok, det, 1.0)
        x0 = (a[1][1] * w[0] - a[0][1] * w[1]) / d
        x1 = (a[0][0] * w[1] - a[1][0] * w[0]) / d
        return [torch.where(ok, x0, w[0]), torch.where(ok, x1, w[1])]
    if n == 3:
        c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
        c01 = -(a[1][0] * a[2][2] - a[1][2] * a[2][0])
        c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
        c10 = -(a[0][1] * a[2][2] - a[0][2] * a[2][1])
        c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
        c12 = -(a[0][0] * a[2][1] - a[0][1] * a[2][0])
        c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
        c21 = -(a[0][0] * a[1][2] - a[0][2] * a[1][0])
        c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
        det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
        ok = torch.abs(det) > tiny
        d = torch.where(ok, det, 1.0)
        # inv(A)_ij = C_ji / det
        x0 = (c00 * w[0] + c10 * w[1] + c20 * w[2]) / d
        x1 = (c01 * w[0] + c11 * w[1] + c21 * w[2]) / d
        x2 = (c02 * w[0] + c12 * w[1] + c22 * w[2]) / d
        return [torch.where(ok, x0, w[0]), torch.where(ok, x1, w[1]),
                torch.where(ok, x2, w[2])]
    raise ValueError('small_solve_cols supports n <= 3')
