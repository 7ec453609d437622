"""The TVF pair kernel with the Adami walls (``tvf_pair``'s no-slip term,
the ``WALL`` instantiations) against its plain torch version, on the
card: the wall examples' calls (``tvf_check.wall_calls``) on the open
grid of the cavity and the grid of Poiseuille's channel, periodic in x,
and on Rayleigh-Taylor's two fluids; the linked pair (the list, the bits
of the walk), and a few steps of the cavity with the link and without
it, bit for bit.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tvf_walls_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev import tvf_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
CASES = [('cavity', ('--nx', '20')), ('poiseuille', ()),
         ('rayleigh_taylor', ())]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('example,extra', CASES)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_wall_kernels_match_plain_versions_on_the_card(dtype, example,
                                                       extra, edges):
    """Every pair call of a wall example's eval (each fluid's density
    and momentum on ``tvf_pair``, the no-slip wall among its terms; the
    wall's on ``gtvf_pair``), with ``edges`` a tenth of each fluid on its
    box's edges and corners: the packs exact, one launch a call, every
    output within the tolerance of max|ref| (infinities exactly)."""
    _need_card()
    calls, _, moved = tvf_check.wall_calls(example, dtype, edges, extra)
    assert bool(moved) == edges
    wall = tvf_check.WALL_EXAMPLES[example][1]
    assert {c[2].op for c in calls} == {tp.tvf_pair, gp.gtvf_pair}
    assert any(ts.terms & tp.NOSLIP for c in calls if c[2].op is tp.tvf_pair
               for ts in c[2].sources if ts.name == wall)
    for _, _, plan, args in calls:
        pack, ref = ((tp.pack_sources, tp.pack_sources_reference)
                     if plan.op is tp.tvf_pair else
                     (gp.pack_sources, gp.pack_sources_reference))
        for got, want in zip(pack(args[4]), ref(args[4])):
            assert got.shape == want.shape and torch.equal(got, want)
        before = plan.op.launches, cell_pack.pack.launches
        plan.op(*args)
        assert (plan.op.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
    tvf_check.compare(calls, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('example,extra', CASES)
def test_wall_linked_pair_is_the_walk(example, extra):
    """Each fluid's linked pair on the wall state: the list equal to
    ``neighbours_reference``, both calls the walking ones bit for bit,
    no dest past the capacity; and with capacity 1, every warp walking,
    the same bits."""
    _need_card()
    calls, _, _ = tvf_check.wall_calls(example, torch.float64, False,
                                       extra)
    found = tvf_check.check_linked(calls, example, TOL[torch.float64])
    assert found['linked'] == (2 if example == 'rayleigh_taylor' else 1)
    assert found['overflowed'] == 0
    small = tvf_check.check_linked(calls, example + ', capacity 1',
                                   TOL[torch.float64], capacity=1)
    assert small['overflowed'] > 0


@pytest.mark.cuda
def test_cavity_steps_linked_and_unlinked_agree():
    """Six steps of the cavity at nx=20 in float64 with the linked pair
    and with each call walking: every state bit for bit."""
    _need_card()
    runs = []
    for linked in (True, False):
        app = tvf_check.wall_app('cavity', torch.float64, steps=6,
                                 extra=('--nx', '20'))
        s = app.solver
        if not linked:
            for a_eval in s.acceleration_evals:
                for plan in a_eval._plans.values():
                    if plan is not None:
                        plan.link = None
        app.solve()
        runs.append(s.states)
    for name, st in runs[0].items():
        for p, v in st.items():
            assert torch.equal(v, runs[1][name][p]), (name, p)
