"""The fused continuity + momentum kernel (``fused_pair``) against its
plain torch version, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_pair_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.tools_dev import walk_cases as wc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize('radius_scale', [2.0, 2.5])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_fused_kernel_matches_plain_version_on_the_card(dtype, tol,
                                                        radius_scale):
    """The perturbed drop at nx=40 with rows of h 0 and negative (which
    give 0) and 100 particles clamped into the corner cell, on cells 2
    and 2.5 hmax wide (the kernel's support radius stays 2): its pack
    equal to its plain version, one walk and one pack launched, every
    output within ``tol`` of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    st, cells, grid, kw = wc.fused_case('cuda', dtype,
                                        radius_scale=radius_scale, nx=40)
    assert torch.equal(fp.pack(st, cells), fp.pack_reference(st, cells))
    before = fp.fused_continuity_momentum.launches, cell_pack.pack.launches
    got = fp.fused_continuity_momentum(st, cells, grid, **kw)
    assert (fp.fused_continuity_momentum.launches,
            cell_pack.pack.launches) == (before[0] + 1, before[1] + 1)
    ref = fp.fused_continuity_momentum_reference(st, cells, grid, **kw)
    torch.cuda.synchronize()
    idle = st['h'] <= 0
    assert bool(idle.any()) and bool((st['h'] < 0).any())
    for name, g, r in zip(('arho', 'au', 'av'), got, ref):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert scale > 0 and err <= tol * scale, (name, err / scale)
        assert bool((g[idle] == 0).all())
    assert bool((got[3] == 0).all())
