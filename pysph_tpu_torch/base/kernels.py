"""SPH smoothing kernels on torch tensors.

Port of ``pysph_tpu/base/kernels.py``: ``CubicSpline``, the Wendland
family (``WendlandQuinticC2_1D``, ``WendlandQuintic``,
``WendlandQuinticC4_1D``, ``WendlandQuinticC4``, ``WendlandQuinticC6_1D``,
``WendlandQuinticC6``), ``Gaussian``, ``SuperGaussian`` and
``QuinticSpline``.  Each kernel is one shape function ``_shape(q) -> (w,
dw)`` evaluated with ``torch.where`` over whole pair tensors, with the
shared identities

    W(r, h)   = fac(h) * w(q),  q = r / h,  fac(h) = sigma / h^dim
    grad_a W  = fac(h) * dw(q) / h * x_ij / r
    dW/dh     = -fac(h) / h * (q * dw(q) + dim * w(q))

and ``get_deltap()`` (``deltap``), the q of the tensile correction's
reference spacing.

The CUDA pair kernels (``csrc/shapes.cuh``) carry the shape functions of
the 2D/3D kernels; ``kernel_kind`` names them there (``SuperGaussian``'s
shape depends on ``dim``: one kind a dim).  The three ``_1D`` kernels
have no kind: the 1D problems are not ported yet (ROADMAP Queue 1 item
28), so the pair planners refuse them.
"""

import math

import torch

M_1_PI = 1.0 / math.pi
M_2_SQRTPI = 2.0 / math.sqrt(math.pi)


class SmoothingKernel(object):
    """Base class: subclasses define ``_sigma``, ``radius_scale`` and
    ``_shape(q) -> (w, dw)``."""

    radius_scale = 2.0
    _deltap = 1.0

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

    def get_deltap(self):
        return self._deltap

    @property
    def deltap(self):
        return self.get_deltap()

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

    def gradient_h(self, xij=None, rij=1.0, h=1.0):
        """dW/dh = -fac/h * (q*dw + dim*w)."""
        w, dw = self._shape(rij / h)
        return -self._fac(h) / h * (dw * (rij / h) + w * self.dim)


class CubicSpline(SmoothingKernel):
    """Cubic spline kernel [Monaghan1992]."""

    radius_scale = 2.0
    _deltap = 2.0 / 3.0

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


class _Wendland(SmoothingKernel):
    """The Wendland family: support q in [0, 2)."""

    radius_scale = 2.0

    def _poly(self, q):
        raise NotImplementedError()

    def _shape(self, q):
        w, dw = self._poly(q)
        inside = q < 2.0
        return torch.where(inside, w, 0.0), torch.where(inside, dw, 0.0)


class _Wendland1D(_Wendland):
    """A 1D member of the family."""

    def __init__(self, dim=1):
        if dim != 1:
            raise ValueError('%s is 1D only' % type(self).__name__)
        super(_Wendland1D, self).__init__(dim)


class _Wendland23D(_Wendland):
    """A 2D/3D member of the family; ``_name_1d`` is its 1D sibling."""

    _name_1d = None

    def __init__(self, dim=2):
        if dim == 1:
            raise ValueError('%s is 2D/3D; use %s in 1D'
                             % (type(self).__name__, self._name_1d))
        super(_Wendland23D, self).__init__(dim)


class WendlandQuinticC2_1D(_Wendland1D):
    """Wendland C2 kernel, 1D."""

    _deltap = 2.0 / 3.0

    def _sigma(self, dim):
        return 5.0 / 8.0

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        return tmp ** 3 * (1.5 * q + 1.0), -3.0 * q * tmp * tmp


class WendlandQuintic(_Wendland23D):
    """Wendland C2 kernel for 2D/3D."""

    _deltap = 0.5
    _name_1d = 'WendlandQuinticC2_1D'

    def _sigma(self, dim):
        return (None, 7.0 * M_1_PI / 4.0, M_1_PI * 21.0 / 16.0)[dim - 1]

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        return tmp ** 4 * (2.0 * q + 1.0), -5.0 * q * tmp ** 3


class WendlandQuinticC4_1D(_Wendland1D):
    """Wendland C4 kernel, 1D."""

    _deltap = 0.55195628

    def _sigma(self, dim):
        return 0.75

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        w = tmp ** 5 * (2.0 * q * q + 2.5 * q + 1.0)
        dw = -3.5 * q * (2.0 * q + 1.0) * tmp ** 4
        return w, dw


class WendlandQuinticC4(_Wendland23D):
    """Wendland C4 kernel for 2D/3D."""

    _deltap = 0.47114274
    _name_1d = 'WendlandQuinticC4_1D'

    def _sigma(self, dim):
        return (None, 9.0 * M_1_PI / 4.0, M_1_PI * 495.0 / 256.0)[dim - 1]

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        w = tmp ** 6 * ((35.0 / 12.0) * q * q + 3.0 * q + 1.0)
        dw = (-14.0 / 3.0) * q * (1.0 + 2.5 * q) * tmp ** 5
        return w, dw


class WendlandQuinticC6_1D(_Wendland1D):
    """Wendland C6 kernel, 1D."""

    _deltap = 0.47996698

    def _sigma(self, dim):
        return 55.0 / 64.0

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        w = tmp ** 7 * (2.625 * q ** 3 + 4.75 * q * q + 3.5 * q + 1.0)
        dw = -0.5 * q * (26.25 * q * q + 27.0 * q + 9.0) * tmp ** 6
        return w, dw


class WendlandQuinticC6(_Wendland23D):
    """Wendland C6 kernel for 2D/3D."""

    _deltap = 0.4305720757
    _name_1d = 'WendlandQuinticC6_1D'

    def _sigma(self, dim):
        return (None, 78.0 * M_1_PI / 28.0, M_1_PI * 1365.0 / 512.0)[dim - 1]

    def _poly(self, q):
        tmp = 1.0 - 0.5 * q
        w = tmp ** 8 * (4.0 * q ** 3 + 6.25 * q * q + 4.0 * q + 1.0)
        dw = -5.5 * q * tmp ** 7 * (1.0 + 3.5 * q + 4.0 * q * q)
        return w, dw


class Gaussian(SmoothingKernel):
    """Gaussian kernel, truncated at q = 3."""

    radius_scale = 3.0
    # the inflection point q = 1/sqrt(2)
    _deltap = 0.70710678118654746

    def _sigma(self, dim):
        return (0.5 * M_2_SQRTPI) ** dim

    def _shape(self, q):
        inside = q < 3.0
        e = torch.exp(-torch.where(inside, q * q, 0.0))
        return torch.where(inside, e, 0.0), torch.where(inside, -2.0 * q * e,
                                                         0.0)


class SuperGaussian(SmoothingKernel):
    """Super-Gaussian kernel, W(q) = sigma/h^d exp(-q^2) (d/2 + 1 - q^2),
    truncated at q = 3."""

    radius_scale = 3.0

    def _sigma(self, dim):
        return (0.5 * M_2_SQRTPI) ** dim

    def get_deltap(self):
        return (0.584540507426389, 0.6021141014644256,
                0.615369528365158)[self.dim - 1]

    def _shape(self, q):
        d = self.dim
        inside = q < 3.0
        q2 = torch.where(inside, q * q, 0.0)
        e = torch.exp(-q2)
        w = torch.where(inside, e * (1.0 + 0.5 * d - q2), 0.0)
        dw = torch.where(inside, q * (2.0 * q2 - d - 4.0) * e, 0.0)
        return w, dw


class QuinticSpline(SmoothingKernel):
    """Quintic spline, support q in [0, 3]."""

    radius_scale = 3.0
    _deltap = 0.759298480738450

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


#: Shape-function ids shared with ``csrc/shapes.cuh``, by class
KERNEL_KIND = {WendlandQuintic: 0, CubicSpline: 1, Gaussian: 2,
               QuinticSpline: 3, WendlandQuinticC4: 4, WendlandQuinticC6: 5}
#: ``SuperGaussian``'s ids, by dim: its shape depends on it
SUPER_GAUSSIAN_KIND = {2: 6, 3: 7}


def kernel_kind(kernel):
    """The id of ``kernel``'s shape function in ``csrc/shapes.cuh``, or
    None where the pair kernels have none (the ``_1D`` kernels, ROADMAP
    Queue 1 item 28)."""
    if type(kernel) is SuperGaussian:
        return SUPER_GAUSSIAN_KIND.get(kernel.dim)
    return KERNEL_KIND.get(type(kernel))
