"""Port smoothing kernels against pysph_tpu.base.kernels on seeded
inputs (float64, relative tolerance 1e-12)."""

import numpy as np
import pytest
import torch

import pysph_tpu.base.kernels as jk
import pysph_tpu_torch.base.kernels as tk
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

CASES = [('WendlandQuintic', 2), ('WendlandQuintic', 3),
         ('CubicSpline', 1), ('CubicSpline', 2), ('CubicSpline', 3)]


def _inputs(seed=3, n=4000, qmax=2.3):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.01, 0.2, n)
    xij = rng.normal(size=(3, n))
    # r from exactly 0 through past the support radius
    r = np.concatenate([[0.0, 0.0], rng.uniform(0.0, qmax, n - 2)]) * h
    xij *= r / np.maximum(np.linalg.norm(xij, axis=0), 1e-300)
    return xij, np.linalg.norm(xij, axis=0), h


def _close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize('name,dim', CASES)
def test_kernel_and_gradient_match_jax(name, dim):
    xij, rij, h = _inputs()
    jkern = getattr(jk, name)(dim=dim)
    tkern = getattr(tk, name)(dim=dim)
    assert tkern.fac == jkern.fac
    assert tkern.radius_scale == jkern.radius_scale
    t = torch.as_tensor
    _close(tkern.kernel(rij=t(rij), h=t(h)), jkern.kernel(rij=rij, h=h))
    _close(tkern.gradient(t(xij), t(rij), t(h)),
           jkern.gradient(xij, rij, h))
    q = np.linspace(0.0, 2.5, 501)
    for got, want in zip(tkern._shape(t(q)), jkern._shape(q)):
        _close(got, want)


@pytest.mark.parametrize('dim', [1, 2, 3])
def test_gaussian_matches_jax(dim):
    """Values, dW/dq and gradients from r = 0 through past the q = 3
    cut, and the cut itself."""
    xij, rij, h = _inputs(seed=5, qmax=3.4)
    jkern = jk.Gaussian(dim=dim)
    tkern = tk.Gaussian(dim=dim)
    assert tkern.fac == jkern.fac
    assert tkern.radius_scale == jkern.radius_scale == 3.0
    t = torch.as_tensor
    _close(tkern.kernel(rij=t(rij), h=t(h)), jkern.kernel(rij=rij, h=h))
    _close(tkern.dwdq(rij=t(rij), h=t(h)), jkern.dwdq(rij=rij, h=h))
    _close(tkern.gradient(t(xij), t(rij), t(h)),
           jkern.gradient(xij, rij, h))
    q = np.concatenate([np.linspace(0.0, 3.5, 701),
                        np.nextafter(3.0, [0.0, 4.0])])
    for got, want in zip(tkern._shape(t(q)), jkern._shape(q)):
        _close(got, want)
    w, dw = tkern._shape(t(np.array([np.nextafter(3.0, 0.0), 3.0])))
    assert w[0] > 0 and dw[0] < 0 and w[1] == 0 and dw[1] == 0


#: every kernel of the JAX package with the dims it takes
ALL_CASES = [(name, dim) for name, dims in (
    ('CubicSpline', (1, 2, 3)), ('WendlandQuinticC2_1D', (1,)),
    ('WendlandQuintic', (2, 3)), ('WendlandQuinticC4_1D', (1,)),
    ('WendlandQuinticC4', (2, 3)), ('WendlandQuinticC6_1D', (1,)),
    ('WendlandQuinticC6', (2, 3)), ('Gaussian', (1, 2, 3)),
    ('SuperGaussian', (1, 2, 3)), ('QuinticSpline', (1, 2, 3)))
    for dim in dims]


@pytest.mark.parametrize('name,dim', ALL_CASES)
def test_every_kernel_matches_jax(name, dim):
    """Values, dW/dq, gradients and dW/dh from r = 0 through past the
    support, the shape over q in [0, support] and just either side of the
    support's edge, and deltap."""
    jkern = getattr(jk, name)(dim=dim)
    tkern = getattr(tk, name)(dim=dim)
    support = jkern.radius_scale
    assert tkern.fac == jkern.fac
    assert tkern.radius_scale == support
    assert tkern.get_deltap() == tkern.deltap == jkern.get_deltap()
    xij, rij, h = _inputs(seed=7, qmax=support + 0.4)
    t = torch.as_tensor
    _close(tkern.kernel(rij=t(rij), h=t(h)), jkern.kernel(rij=rij, h=h))
    _close(tkern.dwdq(rij=t(rij), h=t(h)), jkern.dwdq(rij=rij, h=h))
    _close(tkern.gradient(t(xij), t(rij), t(h)),
           jkern.gradient(xij, rij, h))
    _close(tkern.gradient_h(t(xij), t(rij), t(h)),
           jkern.gradient_h(xij, rij, h))
    q = np.concatenate([np.linspace(0.0, support, 601),
                        np.nextafter(support, [0.0, 2 * support])])
    for got, want in zip(tkern._shape(t(q)), jkern._shape(q)):
        _close(got, want)


@pytest.mark.parametrize('name', ['WendlandQuinticC2_1D',
                                  'WendlandQuinticC4_1D',
                                  'WendlandQuinticC6_1D'])
def test_1d_kernels_have_no_kind(name):
    """The 1D problems are not ported yet (ROADMAP Queue 1 item 28): the
    pair kernels have no shape for the ``_1D`` kernels, and a 2D one
    refuses to be built."""
    assert tk.kernel_kind(getattr(tk, name)(dim=1)) is None
    with pytest.raises(ValueError, match='1D only'):
        getattr(tk, name)(dim=2)


def test_kernel_kinds():
    kinds = {(name, dim): tk.kernel_kind(getattr(tk, name)(dim=dim))
             for name, dim in ALL_CASES if not name.endswith('_1D')}
    assert kinds[('SuperGaussian', 2)] == 6
    assert kinds[('SuperGaussian', 3)] == 7
    assert kinds[('SuperGaussian', 1)] is None
    assert {k for k in kinds.values() if k is not None} == set(range(8))
