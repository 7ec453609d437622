"""SPH smoothing kernels on torch tensors.

Port of ``pysph_tpu/base/kernels.py`` for the kernels of the ported
paths: ``CubicSpline``, ``WendlandQuintic``, ``Gaussian`` and
``QuinticSpline``.  Each
kernel is one shape function ``_shape(q) -> (w, dw)`` evaluated with
``torch.where`` over whole pair tensors, with the shared identities

    W(r, h)   = fac(h) * w(q),  q = r / h,  fac(h) = sigma / h^dim
    grad_a W  = fac(h) * dw(q) / h * x_ij / r

The CUDA pair kernels (``csrc/shapes.cuh``) carry the same four shape
functions; ``KERNEL_KIND`` names them there.
"""

import math

import torch

M_1_PI = 1.0 / math.pi
M_2_SQRTPI = 2.0 / math.sqrt(math.pi)


class SmoothingKernel(object):
    """Base class: subclasses define ``_sigma``, ``radius_scale`` and
    ``_shape(q) -> (w, dw)``."""

    radius_scale = 2.0

    def __init__(self, dim=1):
        if dim not in (1, 2, 3):
            raise ValueError('dim must be 1, 2 or 3, got %r' % dim)
        self.dim = dim
        self.fac = self._sigma(dim)

    def __repr__(self):
        return '%s(dim=%d)' % (self.__class__.__name__, self.dim)

    def _sigma(self, dim):
        raise NotImplementedError()

    def _shape(self, q):
        """Return (w(q), dw(q)) without normalization."""
        raise NotImplementedError()

    def _fac(self, h):
        h1 = 1.0 / h
        if self.dim == 1:
            return self.fac * h1
        elif self.dim == 2:
            return self.fac * h1 * h1
        return self.fac * h1 * h1 * h1

    def kernel(self, xij=None, rij=1.0, h=1.0):
        """W(rij, h).  ``xij`` is accepted for API parity and ignored."""
        w, _ = self._shape(rij / h)
        return w * self._fac(h)

    def dwdq(self, rij=1.0, h=1.0):
        """sigma(h) * dw/dq at q = rij/h."""
        _, dw = self._shape(rij / h)
        return dw * self._fac(h)

    def gradient(self, xij, rij, h):
        """grad_a W as a (3, ...) stack; zero where rij <= 1e-12."""
        wdash = self.dwdq(rij, h)
        near = rij > 1e-12
        tmp = torch.where(near, wdash / (h * torch.where(near, rij, 1.0)),
                          0.0)
        return torch.stack([tmp * xij[0], tmp * xij[1], tmp * xij[2]])


class CubicSpline(SmoothingKernel):
    """Cubic spline kernel [Monaghan1992]."""

    radius_scale = 2.0

    def _sigma(self, dim):
        return (2.0 / 3.0, 10.0 * M_1_PI / 7.0, M_1_PI)[dim - 1]

    def _shape(self, q):
        tmp2 = 2.0 - q
        w_in = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
        w_mid = 0.25 * tmp2 * tmp2 * tmp2
        w = torch.where(q > 2.0, 0.0, torch.where(q > 1.0, w_mid, w_in))
        dw_in = -3.0 * q * (1.0 - 0.75 * q)
        dw_mid = -0.75 * tmp2 * tmp2
        dw = torch.where(q > 2.0, 0.0, torch.where(q > 1.0, dw_mid, dw_in))
        return w, dw


class WendlandQuintic(SmoothingKernel):
    """Wendland C2 kernel for 2D/3D; support q in [0, 2)."""

    radius_scale = 2.0

    def __init__(self, dim=2):
        if dim == 1:
            raise ValueError('WendlandQuintic is 2D/3D; use '
                             'WendlandQuinticC2_1D in 1D')
        super(WendlandQuintic, self).__init__(dim)

    def _sigma(self, dim):
        return (None, 7.0 * M_1_PI / 4.0, M_1_PI * 21.0 / 16.0)[dim - 1]

    def _shape(self, q):
        tmp = 1.0 - 0.5 * q
        w = tmp ** 4 * (2.0 * q + 1.0)
        dw = -5.0 * q * tmp ** 3
        inside = q < 2.0
        return torch.where(inside, w, 0.0), torch.where(inside, dw, 0.0)


class Gaussian(SmoothingKernel):
    """Gaussian kernel, truncated at q = 3."""

    radius_scale = 3.0

    def _sigma(self, dim):
        return (0.5 * M_2_SQRTPI) ** dim

    def _shape(self, q):
        inside = q < 3.0
        e = torch.exp(-torch.where(inside, q * q, 0.0))
        return torch.where(inside, e, 0.0), torch.where(inside, -2.0 * q * e,
                                                         0.0)


class QuinticSpline(SmoothingKernel):
    """Quintic spline, support q in [0, 3]."""

    radius_scale = 3.0

    def _sigma(self, dim):
        return (1.0 / 120.0, M_1_PI * 7.0 / 478.0, M_1_PI / 120.0)[dim - 1]

    def _shape(self, q):
        t3 = 3.0 - q
        t2 = 2.0 - q
        t1 = 1.0 - q
        w3 = t3 ** 5
        w2 = 6.0 * t2 ** 5
        w1 = 15.0 * t1 ** 5
        w = torch.where(
            q > 3.0, 0.0,
            torch.where(q > 2.0, w3,
                        torch.where(q > 1.0, w3 - w2, w3 - w2 + w1)))
        d3 = -5.0 * t3 ** 4
        d2 = 30.0 * t2 ** 4
        d1 = -75.0 * t1 ** 4
        dw = torch.where(
            q > 3.0, 0.0,
            torch.where(q > 2.0, d3,
                        torch.where(q > 1.0, d3 + d2, d3 + d2 + d1)))
        return w, dw


#: Shape-function ids shared with ``csrc/shapes.cuh``.
KERNEL_KIND = {WendlandQuintic: 0, CubicSpline: 1, Gaussian: 2,
               QuinticSpline: 3}
#: the kinds the WCSPH walks (``wcsph_pair``, ``dense_pair``,
#: ``delta_pair``) are built for: every kind, as ``tvf_pair`` and
#: ``gtvf_pair``
WCSPH_KINDS = frozenset((0, 1, 2, 3))
