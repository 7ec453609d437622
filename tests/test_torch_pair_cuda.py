"""The CUDA pair kernel and the source pack against their plain torch
versions, on the card: dam_break_3d's calls and the walk's edge cases
(``tools_dev/walk_cases.py``: a clamped cell longer than one stage, a 2D
grid, four sources, write masks, an empty dest array).

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import walk_cases as wc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOLS = [(torch.float64, 1e-10), (torch.float32, 1e-4)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', TOLS)
def test_kernel_matches_plain_version_on_the_card(dtype, tol):
    _need_card()
    app = DamBreak3D()
    app.setup(['-q', '--disable-output', '--dx', '0.06'] +
              (['--use-double'] if dtype == torch.float64 else []))
    s = app.solver
    rng = np.random.default_rng(3)
    for st in s.states.values():
        n = st['x'].shape[0]
        for p in 'uvw':
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n), dtype=dtype,
                                    device='cuda')
        st['tag'][::5] = 1      # rows outside the write mask keep pre
    a_eval = s.acceleration_evals[0]
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    cells = a_eval.grid.bin_all(s.states)
    launched = 0
    for group in a_eval.groups:
        for dest in a_eval._dest_order(group):
            plan = a_eval._plans.get((id(group), dest))
            if plan is None:
                continue
            store = s.states[dest]
            pre = {p: torch.as_tensor(rng.normal(size=store['x'].shape[0]),
                                      dtype=dtype, device='cuda')
                   for p in plan.outputs}
            srcs = [(s.states[ps.name], cells[ps.name], ps)
                    for ps in plan.sources]
            args = (store, cells[dest], store['tag'] == 0, pre, srcs,
                    a_eval.grid, a_eval.kernel)
            before = wp.wcsph_pair.launches
            got = wp.wcsph_pair(*args)
            launched += wp.wcsph_pair.launches - before
            ref = wp.wcsph_pair_reference(*args)
            torch.cuda.synchronize()
            for p in plan.outputs:
                scale = float(ref[p].abs().max())
                err = float((got[p] - ref[p]).abs().max()) / scale
                assert err <= tol, (dest, p, err)
                masked = store['tag'] != 0
                assert torch.equal(got[p][masked], pre[p][masked])
    assert launched == 3


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('case', wc.CASES)
def test_kernel_matches_plain_version_on_walk_cases(case, dtype, tol):
    _need_card()
    args = wc.make_case(case, 'cuda', dtype, seed=11)
    wc.check_kernel(wp.wcsph_pair, args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', wc.CASES)
def test_pack_kernel_is_exactly_its_plain_version(case, dtype):
    _need_card()
    sources = wc.make_case(case, 'cuda', dtype, seed=12)[4]
    before = cell_pack.pack.launches
    got = wp.pack_sources(sources)
    assert cell_pack.pack.launches == before + 1
    for g, r in zip(got, wp.pack_sources_reference(sources)):
        assert g.shape == r.shape and torch.equal(g, r)
