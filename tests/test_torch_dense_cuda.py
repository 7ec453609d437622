"""The cell-tiled pair kernel (``dense_pair``) against its plain torch
version, on the card: the drop's and dam_break_3d's calls with a fat
clamped edge cell, and the walk's edge cases (``tools_dev/walk_cases.py``).

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import walk_cases as wc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

CASES = {'elliptical_drop': (EllipticalDrop, ['--nx', '40']),
         'dam_break_3d': (DamBreak3D, ['--dx', '0.04'])}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_dense_kernel_matches_plain_version_on_the_card(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    cls, argv = CASES[case]
    app = cls()
    app.setup(['-q', '--disable-output', '--engine', 'dense'] + argv +
              (['--use-double'] if dtype == torch.float64 else []))
    s = app.solver
    rng = np.random.default_rng(6)
    for st in s.states.values():
        n = st['x'].shape[0]
        for p in ('u', 'v', 'w'):
            st[p] = st[p] + torch.as_tensor(rng.normal(0.0, 1.0, n),
                                            dtype=dtype, device='cuda')
        st['tag'][::5] = 1      # rows outside the real=True write mask
    # a fat edge cell: particles beyond the initial extent are clamped
    # into the last cell, which then holds several staging chunks
    fluid = s.states['fluid']
    for c in 'xyz'[:s.dim]:
        fluid[c][:300] = fluid[c].max() + 0.01 * torch.as_tensor(
            rng.uniform(size=300), dtype=dtype, device='cuda')
    a_eval = s.acceleration_evals[0]
    a_eval.update_and_compute(0.0, s.dt, s.states)
    cells = a_eval.grid.bin_all(s.states)
    assert int((cells['fluid'].end - cells['fluid'].start).max()) > 128
    checked = 0
    for group in a_eval.groups:
        for dest in a_eval._dest_order(group):
            plan = a_eval._plans.get((id(group), dest))
            if plan is None:
                continue
            assert plan.op is dp.dense_pair
            store = s.states[dest]
            wm = group.write_mask(store)
            pre = {p: torch.as_tensor(
                rng.normal(size=store['x'].shape[0]), dtype=dtype,
                device='cuda') for p in plan.outputs}
            srcs = [(s.states[ps.name], cells[ps.name], ps)
                    for ps in plan.sources]
            args = (store, cells[dest], wm, pre, srcs, a_eval.grid,
                    a_eval.kernel)
            before = dp.dense_pair.launches
            got = dp.dense_pair(*args)
            assert dp.dense_pair.launches == before + 1
            ref = wp.wcsph_pair_reference(*args)
            torch.cuda.synchronize()
            for p in plan.outputs:
                scale = float(ref[p].abs().max())
                err = float((got[p] - ref[p]).abs().max())
                assert err <= tol * scale, (dest, p, err / scale)
                if wm is not None:
                    assert torch.equal(got[p][~wm], pre[p][~wm])
            checked += 1
    assert checked == len(a_eval._plans)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('case', wc.CASES)
def test_dense_kernel_matches_plain_version_on_walk_cases(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    args = wc.make_case(case, 'cuda', dtype, seed=11)
    wc.check_kernel(dp.dense_pair, args, tol)
