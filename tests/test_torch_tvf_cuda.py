"""The TVF pair kernel against its plain torch version, on the card, and
its linked pair (the density call emitting its neighbour list, the
momentum call consuming it): the list equal to
``pair_link.neighbours_reference``, both calls the walking ones' bit for
bit, also with a capacity so small that some or all warps walk, and a
few steps of the path with the link and without it, bit for bit.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tvf_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev import tvf_check
from pysph_tpu_torch.tools_dev.time_walks import make_app
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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('nx', [20, 50])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_linked_pair_is_the_walk(dtype, tol, nx, edges):
    """The linked pair of a Taylor-Green eval: the density launch's list
    equal to ``neighbours_reference`` on the periodic grid, the dests
    past the capacity counted (none but with ``edges``, whose corners
    stack particles), both launches equal to the walking ones bit for
    bit, within ``tol`` of the plain version, one pack each."""
    _need_card()
    calls, _, _ = tvf_check.calls(nx, dtype, edges)
    before = tp.tvf_pair.launches
    found = tvf_check.check_linked(calls, 'nx=%d %s' % (nx, dtype), tol)
    # emit, consume, the two walking calls
    assert tp.tvf_pair.launches - before == 4
    assert found['linked'] == 1 and found['packs'] == 2
    if not edges:
        assert found['overflowed'] == 0
        assert found['max_count'] <= found['capacity']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_overflowing_warps_walk(dtype, tol):
    """A capacity one short of the largest count (the warps holding such
    a dest walk, the others read the list) and a capacity of 1 (every
    warp walks): the momentum launch still equals the walk bit for
    bit."""
    _need_card()
    calls, _, _ = tvf_check.calls(50, dtype)
    most = tvf_check.check_linked(calls, 'nx=50', tol)['max_count']
    some = tvf_check.check_linked(calls, 'nx=50, capacity %d' % (most - 1),
                                  tol, capacity=most - 1)
    assert 0 < some['overflowed'] < 0.5 * some['dests']
    every = tvf_check.check_linked(calls, 'nx=50, capacity 1', tol,
                                   capacity=1)
    assert every['overflowed'] == every['dests']


@pytest.mark.cuda
def test_linked_path_steps_as_the_walking_path():
    """Taylor-Green at nx=20, 6 steps per step and in chunks of 3, with
    the link and with it removed: every prop bit for bit."""
    _need_card()
    runs = []
    for linked in (True, False):
        app = make_app(None, torch.float32, steps=6, cls=TaylorGreen,
                       extra=('--nx', '20', '--perturb', '0.1'))
        s = app.solver
        s.chunk_steps = 3
        plans = [p for a in s.acceleration_evals for p in a._plans.values()
                 if p is not None]
        assert sum(p.link is not None for p in plans) == 2
        if not linked:
            for p in plans:
                p.link = None
        app.solve()
        assert s.count == 6 and s.replays >= 1
        runs.append(s.states)
    for name, st in runs[1].items():
        for p, v in st.items():
            assert torch.equal(runs[0][name][p], v), (name, p)
