"""The port's ``fused_continuity_momentum`` (plain version, on the CPU)
against pysph_tpu's ``fused_continuity_momentum`` (``_row_kernel`` in
interpret mode, the kernel ``csrc/fused_pair.cu`` replaces) and against
``wcsph_pair_reference``.

Input: the case of ``tests/test_pallas_pair.py`` (seed 0, 120 particles
in the unit cube, float32, CubicSpline, unit mass), and the same cloud
flattened to 2D.  The port in float32 agrees with the JAX function to
5e-6 of ``max|ref|`` (that test's own bar against its O(N^2) oracle),
and in float64 to 1e-12.  At unit mass, a constant h and a sound speed
equal to c0, the fused rates are ``wcsph_pair``'s Continuity + Momentum
terms (float64, 1e-12).
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops.pair_engine import PairSource
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

C0, ALPHA, BETA = 10.0, 0.1, 0.0


def _cloud(dim, seed=0, n=120, dx=0.2):
    """test_pallas_pair.py's particles (z = w = 0 in 2D)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1.0, (n, 3)).astype(np.float32)
    u = rng.randn(n, 3).astype(np.float32) * 0.1
    rho = (1 + 0.05 * rng.randn(n)).astype(np.float32)
    p = (10 + rng.randn(n)).astype(np.float32)
    h = np.full(n, 1.3 * dx, np.float32)
    if dim == 2:
        pts[:, 2] = 0.0
        u[:, 2] = 0.0
    return dict(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], u=u[:, 0],
                v=u[:, 1], w=u[:, 2], rho=rho, p=p, h=h)


def _port(props, dim, dtype, extra=None):
    """(state, cells, grid) of the port for ``props``."""
    pa = get_particle_array(name='f', **props, **(extra or {}))
    grid = CellGrid.from_particles([pa], dim=dim, radius_scale=2.0)
    state = pa.to_device(Config(device='cpu', dtype=dtype))
    return state, grid.bin_all({'f': state})['f'], grid


def _jax_fused(dim):
    """pysph_tpu's fused_continuity_momentum on the cloud, in interpret
    mode, mapped back from its slots to the particles."""
    from pysph_tpu.base.cell_grid import GridSpec, build_layout, to_slots
    from pysph_tpu.base.utils import get_particle_array as jax_array
    from pysph_tpu.ops.pallas_pair import fused_continuity_momentum
    props = _cloud(dim)
    n = props['x'].size
    pa = jax_array(name='f', **props)
    spec = GridSpec.from_particles([pa], dim=dim, radius_scale=2.0)
    state, _ = pa.to_device()
    origin, widths, _ = spec.geometry({'f': state})
    lay = build_layout(spec, state, origin, widths,
                       capacity=spec.capacity_for('f'))
    M = lay.slot_to_particle.shape[0] // spec.n_cells
    slot = {k: to_slots(lay, state[k]) for k in fp.PROPS}
    outs = fused_continuity_momentum(slot, spec.dims, M, dim=dim, c0=C0,
                                     alpha=ALPHA, beta=BETA, interpret=True)
    s2p = np.asarray(lay.slot_to_particle)
    valid = s2p >= 0
    ref = []
    for o in outs:
        a = np.zeros(n)
        a[s2p[valid]] = np.asarray(o)[valid]
        ref.append(a)
    return ref


@pytest.fixture(scope='module')
def jax_fused():
    return {dim: _jax_fused(dim) for dim in (2, 3)}


@pytest.mark.parametrize('dim', [3, 2])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 5e-6),
                                       (torch.float64, 1e-12)])
def test_fused_matches_jax_row_kernel(jax_fused, dim, dtype, tol):
    ref = jax_fused[dim]
    state, cells, grid = _port(_cloud(dim), dim, dtype)
    launches = fp.fused_continuity_momentum.launches
    got = fp.fused_continuity_momentum(state, cells, grid, dim=dim, c0=C0,
                                       alpha=ALPHA, beta=BETA)
    # CPU tensors take the plain version: nothing was launched
    assert fp.fused_continuity_momentum.launches == launches
    assert np.abs(ref[0]).max() > 10.0 and np.abs(ref[1]).max() > 1e3
    for name, g, r in zip(('arho', 'au', 'av', 'aw'), got, ref):
        g = g.numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        scale = max(np.abs(r).max(), 1e-9)
        err = np.abs(g - r).max() / scale
        assert err <= tol, '%s: scaled error %.3g' % (name, err)


@pytest.mark.parametrize('dim', [3, 2])
def test_fused_is_wcsph_continuity_momentum_at_unit_mass(dim):
    props = {k: v.astype(np.float64) for k, v in _cloud(dim).items()}
    n = props['x'].size
    state, cells, grid = _port(props, dim, torch.float64,
                               {'m': np.ones(n), 'cs': np.full(n, C0)})
    got = fp.fused_continuity_momentum_reference(
        state, cells, grid, dim=dim, c0=C0, alpha=ALPHA, beta=BETA)
    terms = wp.CONT | wp.MOM
    pre = {p: torch.zeros(n, dtype=torch.float64)
           for p in wp.outputs_for(terms)}
    want = wp.wcsph_pair_reference(
        state, cells, None, pre,
        [(state, cells, PairSource('f', terms, c0=C0, alpha=ALPHA,
                                   beta=BETA))],
        grid, CubicSpline(dim=dim))
    for name, g in zip(('arho', 'au', 'av', 'aw'), got):
        w = want[name].numpy()
        scale = max(np.abs(w).max(), np.finfo(float).tiny)
        err = np.abs(g.numpy() - w).max() / scale
        assert err <= 1e-12, '%s: scaled error %.3g' % (name, err)


def test_fused_zero_h_rows_and_grid_check():
    """A dest with h <= 0 gives 0 and is no one's neighbour (an empty
    slot in the JAX kernel); cells narrower than 2 hmax are refused."""
    props = {k: v.astype(np.float64) for k, v in _cloud(3).items()}
    props['h'][::7] = 0.0
    state, cells, grid = _port(props, 3, torch.float64)
    got = fp.fused_continuity_momentum(state, cells, grid)
    keep = props['h'] > 0
    sub = {k: v[keep] for k, v in props.items()}
    s2, c2, g2 = _port(sub, 3, torch.float64)
    want = fp.fused_continuity_momentum(s2, c2, g2)
    for g, w in zip(got, want):
        assert bool((g[::7] == 0).all())
        np.testing.assert_allclose(g.numpy()[keep], w.numpy(), rtol=1e-12,
                                   atol=1e-12 * np.abs(w.numpy()).max())
    grid.radius_scale = 1.5
    with pytest.raises(ValueError, match='2 hmax'):
        fp.fused_continuity_momentum(state, cells, grid)
