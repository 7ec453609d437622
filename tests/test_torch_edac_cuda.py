"""EDAC's terms on the hand-written pair kernels against their plain torch
versions, on the card: ``tvf_pair``'s EDAC instantiations (the mean
pressure, EDAC's pressure gradients, ``EDACEquation``, XSPH; a library
of their own) and ``gtvf_pair``'s EDAC wall set, on the calls of the
three EDAC runs (``taylor_green`` periodic, ``cavity`` with its walls,
``dam_break_2d``'s external flow; perturbed, the pressure seeded, and
with a tenth of the fluid on its box's edges and corners); the linked
calls (the density call's list read by the cavity's mean-pressure call
and by each momentum call) bit for bit the walk, also with capacity 1;
no dest whose ``nnbr`` differs; a few steps of each run linked and
unlinked bit for bit; and the default library refusing an EDAC term.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_edac_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev import tvf_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: the runs at a small size: {run: the example's arguments}
RUNS = {'taylor_green': ('--nx', '20'), 'cavity': ('--nx', '20'),
        'dam_break_2d': ('--dx', '0.05')}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


def _calls(run, dtype, edges):
    if run == 'taylor_green':
        return tvf_check.calls(int(RUNS[run][1]), dtype, edges,
                               scheme='edac')
    return tvf_check.wall_calls(run, dtype, edges,
                                RUNS[run] + ('--scheme', 'edac'))


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('run', list(RUNS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_edac_kernels_match_plain_versions_on_the_card(dtype, run, edges):
    """Every pair call of one eval of an EDAC run: the EDAC terms on
    ``tvf_pair`` (and the walls' EDAC set on ``gtvf_pair``), the packs
    exact, one launch a call, every output within the tolerance of
    max|ref|, no dest's ``nnbr`` differing."""
    _need_card()
    calls, _, moved = _calls(run, dtype, edges)
    assert bool(moved) == edges
    terms = 0
    for _, _, plan, args in calls:
        for ps in plan.sources:
            terms |= ps.terms if plan.op is tp.tvf_pair else 0
        pack, ref = ((tp.pack_sources, tp.pack_sources_reference)
                     if plan.op is tp.tvf_pair else
                     (gp.pack_sources, gp.pack_sources_reference))
        for got, want in zip(pack(args[4]), ref(args[4])):
            assert got.shape == want.shape and torch.equal(got, want)
        before = plan.op.launches, cell_pack.pack.launches
        plan.op(*args)
        assert (plan.op.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
    assert terms & tp.EDACEQ
    assert {c[2].op for c in calls} == (
        {tp.tvf_pair} if run == 'taylor_green' else
        {tp.tvf_pair, gp.gtvf_pair})
    tvf_check.compare(calls, TOL[dtype])
    avgp, flips = tvf_check.nnbr_flips(calls)
    assert avgp == (0 if run == 'dam_break_2d' else 1) and flips == 0


@pytest.mark.cuda
@pytest.mark.parametrize('run', list(RUNS))
def test_edac_linked_calls_are_the_walk(run):
    """The linked calls of an EDAC run on its state: the list equal to
    ``neighbours_reference``, every consuming call (the cavity's mean
    pressure and the momentum) the walking one bit for bit, no dest past
    the capacity; and with capacity 1, every warp walking, the same
    bits."""
    _need_card()
    calls, _, _ = _calls(run, torch.float64, False)
    found = tvf_check.check_linked(calls, run, TOL[torch.float64])
    assert found['linked'] == 1 and found['overflowed'] == 0
    assert found['consumers'] == (2 if run == 'cavity' else 1)
    small = tvf_check.check_linked(calls, run + ', capacity 1',
                                   TOL[torch.float64], capacity=1)
    assert small['overflowed'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('run', list(RUNS))
def test_edac_steps_linked_and_unlinked_agree(run):
    """Six steps of an EDAC run in float64 with the link and with each
    call walking: every state bit for bit."""
    _need_card()
    from pysph_tpu_torch.tools_dev.time_walks import make_app
    mod = {'taylor_green': 'TaylorGreen', 'cavity': 'LidDrivenCavity',
           'dam_break_2d': 'DamBreak2D'}[run]
    cls = getattr(__import__('pysph_tpu_torch.examples.' + run,
                             fromlist=[mod]), mod)
    states = []
    for linked in (True, False):
        app = make_app(None, torch.float64, steps=6, cls=cls,
                       extra=RUNS[run] + ('--scheme', 'edac'))
        s = app.solver
        if not linked:
            for a_eval in s.acceleration_evals:
                for plan in a_eval._plans.values():
                    if plan is not None:
                        plan.link = None
        app.solve()
        states.append(s.states)
    for name, st in states[0].items():
        for p, v in st.items():
            assert torch.equal(v, states[1][name][p]), (name, p)


@pytest.mark.cuda
def test_default_library_refuses_an_edac_term():
    """A launch with an EDAC term from the default ``tvf_pair`` library
    (built without ``-DTVF_EDAC``) is refused."""
    _need_card()
    calls, _, _ = _calls('taylor_green', torch.float32, False)
    (_, _, plan, args), = [c for c in calls
                           if 'ap' in c[2].outputs]
    flags = tp.EDAC_FLAGS
    try:
        tp.EDAC_FLAGS = ()
        with pytest.raises(RuntimeError, match='launch failed'):
            plan.op(*args)
    finally:
        tp.EDAC_FLAGS = flags
    assert build.load_library('tvf_pair', tp._Args) is not None
