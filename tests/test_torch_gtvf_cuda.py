"""The GTVF pair kernel against its plain torch version, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gtvf_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.tools_dev import walk_cases as wc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize('crowd', [False, True])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_gtvf_kernel_matches_plain_version_on_the_card(dtype, tol, crowd):
    """Every phase set of both evaluators of the GTVF dam break at
    dx=0.02 (with ``crowd``, 300 fluid particles clamped into the grid's
    corner cell): one walk and one pack launched a call, the pack equal
    to its plain version, every output within ``tol`` of max|ref| over
    the finite entries, the infinities (``rhodiv`` next to the walls)
    matched exactly, and ``pre`` outside the write mask."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    phases = set()
    for _, dest, plan, args in wc.gtvf_calls('cuda', dtype, crowd=crowd,
                                             dx=0.02):
        wm, pre, srcs = args[2], args[3], args[4]
        for got, want in zip(gp.pack_sources(srcs),
                             gp.pack_sources_reference(srcs)):
            assert got.shape == want.shape and torch.equal(got, want)
        before = gp.gtvf_pair.launches, cell_pack.pack.launches
        got = gp.gtvf_pair(*args)
        assert (gp.gtvf_pair.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
        ref = gp.gtvf_pair_reference(*args)
        torch.cuda.synchronize()
        terms = 0
        for ps in plan.sources:
            terms |= ps.terms
        phases.add(gp.phase_of(terms))
        for p in plan.outputs:
            fin = torch.isfinite(ref[p])
            assert torch.equal(torch.isfinite(got[p]), fin), p
            assert torch.equal(got[p][~fin], ref[p][~fin]), p
            scale = float(ref[p][fin].abs().max())
            err = float((got[p][fin] - ref[p][fin]).abs().max())
            assert err <= tol * scale, (dest, p, err / scale)
            if wm is not None:
                assert torch.equal(got[p][~wm], pre[p][~wm])
    assert phases == set(range(len(gp.PHASE_SETS)))
