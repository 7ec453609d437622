"""The fused continuity + momentum kernel (``fused_pair``) against its
plain torch version, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_pair_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import fused_pair as fp


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_fused_kernel_matches_plain_version_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    app = EllipticalDrop()
    app.setup(['-q', '--disable-output', '--nx', '40'] +
              (['--use-double'] if dtype == torch.float64 else []))
    st = dict(app.solver.states['fluid'])
    n = st['x'].shape[0]
    rng = np.random.default_rng(8)
    for p, scale in (('u', 10.0), ('v', 10.0), ('p', 100.0)):
        st[p] = st[p] + torch.as_tensor(rng.normal(0.0, scale, n),
                                        dtype=dtype, device='cuda')
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n),
                                dtype=dtype, device='cuda')
    st['h'] = st['h'].clone()
    st['h'][::97] = 0.0            # rows that give 0 and are skipped
    # a fat edge cell beyond the initial extent
    for c in 'xy':
        st[c] = st[c].clone()
        st[c][:200] = st[c].max() + 0.01 * torch.as_tensor(
            rng.uniform(size=200), dtype=dtype, device='cuda')
    grid = CellGrid.from_particles(app.particles, dim=2, radius_scale=2.0)
    cells = grid.bin_all({'fluid': st})['fluid']
    kw = dict(dim=2, c0=1400.0, alpha=0.1, beta=0.0)
    before = fp.fused_continuity_momentum.launches
    got = fp.fused_continuity_momentum(st, cells, grid, **kw)
    assert fp.fused_continuity_momentum.launches == before + 1
    ref = fp.fused_continuity_momentum_reference(st, cells, grid, **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(('arho', 'au', 'av'), got, ref):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert scale > 0 and err <= tol * scale, (name, err / scale)
        assert bool((g[::97] == 0).all())
    assert bool((got[3] == 0).all())
