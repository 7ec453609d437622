"""The GTVF pair kernel against its plain torch version, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gtvf_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.ops import gtvf_pair as gp


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_gtvf_kernel_matches_plain_version_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')
    app = DamBreak2D()
    app.setup(['-q', '--disable-output', '--scheme', 'gtvf', '--dx', '0.02']
              + (['--use-double'] if dtype == torch.float64 else []))
    s = app.solver
    rng = np.random.default_rng(4)
    for st in s.states.values():
        n = st['x'].shape[0]
        for p in ('u', 'v', 'uhat', 'vhat'):
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n), dtype=dtype,
                                    device='cuda')
        st['tag'][::5] = 1      # rows outside the real=True write mask
    for a_eval in s.acceleration_evals:
        a_eval.compute(0.0, s.dt, s.states)
    phases = set()
    for a_eval in s.acceleration_evals:
        cells = a_eval.grid.bin_all(s.states)
        for group in a_eval.groups:
            for dest in a_eval._dest_order(group):
                plan = a_eval._plans.get((id(group), dest))
                if plan is None:
                    continue
                store = s.states[dest]
                wm = group.write_mask(store)
                pre = {p: torch.as_tensor(
                    rng.normal(size=store['x'].shape[0]), dtype=dtype,
                    device='cuda') for p in plan.outputs}
                srcs = [(s.states[ps.name], cells[ps.name], ps)
                        for ps in plan.sources]
                args = (store, cells[dest], wm, pre, srcs, a_eval.grid,
                        a_eval.kernel)
                before = gp.gtvf_pair.launches
                got = gp.gtvf_pair(*args)
                assert gp.gtvf_pair.launches == before + 1
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
