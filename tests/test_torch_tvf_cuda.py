"""The TVF pair kernel against its plain torch version, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tvf_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev import tvf_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('nx', [20, 50])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_tvf_kernel_matches_plain_version_on_the_card(dtype, tol, nx,
                                                      edges):
    """Both launches of a Taylor-Green eval (the density and the
    momentum phase set) on the periodic grid (5 x 5 cells at nx=20),
    with ``edges`` a tenth of the particles on the box's edges and
    corners: one walk and one pack launched a call, the pack equal to
    its plain version, every output within ``tol`` of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    calls, _, moved = tvf_check.calls(nx, dtype, edges)
    assert bool(moved) == edges
    assert len(calls) == 2
    for _, _, plan, args in calls:
        assert args[5].is_periodic
        srcs = args[4]
        for got, want in zip(tp.pack_sources(srcs),
                             tp.pack_sources_reference(srcs)):
            assert got.shape == want.shape and torch.equal(got, want)
        before = tp.tvf_pair.launches, cell_pack.pack.launches
        plan.op(*args)
        assert (tp.tvf_pair.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
    _, worst = tvf_check.compare(calls, tol)
    assert worst <= tol
