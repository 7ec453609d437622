"""IISPH's pair phases on the hand-written ``iisph_pair`` against their
plain torch versions, on the card: the six phase sets on the calls of
one evaluation of the three IISPH runs (``taylor_green`` periodic,
``elliptical_drop``, ``dam_break_2d`` with its walls), from the runs'
own state after a few steps of a jittered start, with and without a
tenth of the fluid on its box's edges and corners (the pressure solve
then sweeps up to 30 times); every linked call (the dest's first call
that sees all its later sources emitting, every later call reading its
list, the ``dijpj`` call over fewer sources than the emitter) bit for
bit the walk, also with capacity 1; a few steps of each run linked and
unlinked bit for bit, with the launches the sweeps imply.  And
``iisph_solve``, the pressure group in one launch: against its plain
version and bit for bit against the per-launch chain
(``iisph_check.check_solve``) at the call's tolerance and at ones that
force 30 sweeps and stop at 2, also on one block and on three; a grid
larger than the card holds refused; a few steps of each run through it,
per step and in captured chunks, bit for bit the per-launch chain's
linked steps with the same sweeps.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_iisph_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops import iisph_solve as isv
from pysph_tpu_torch.tools_dev import iisph_check, tvf_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: the runs at a small size
RUNS = {'taylor_green': 20, 'elliptical_drop': 20, 'dam_break_2d': 0.05}
#: the pair launches of an evaluation: the walking ones and 2 a sweep
FIXED = {'taylor_green': 4, 'elliptical_drop': 4, 'dam_break_2d': 6}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('run', list(RUNS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_iisph_pair_matches_plain_version_on_the_card(dtype, run, edges):
    """Every pair call of one evaluation of an IISPH run: the packs
    exact, one launch and one pack a call, every output within the
    tolerance of max|ref|, as many calls as the sweeps imply."""
    _need_card()
    calls, _, moved, sweeps = iisph_check.calls(run, RUNS[run], dtype,
                                                edges=edges)
    assert bool(moved) == edges
    assert len(calls) == FIXED[run] + 2 * sweeps
    for _, _, plan, args in calls:
        assert plan.op is ip.iisph_pair
        for got, want in zip(ip.pack_sources(args[4]),
                             ip.pack_sources_reference(args[4])):
            assert got.shape == want.shape and torch.equal(got, want)
        before = ip.iisph_pair.launches, cell_pack.pack.launches
        plan.op(*args)
        assert (ip.iisph_pair.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
    tvf_check.compare(calls, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('run', list(RUNS))
def test_iisph_linked_calls_are_the_walk(run):
    """The linked calls of an IISPH run: the list equal to
    ``neighbours_reference``, every consuming call the walking one bit
    for bit, no dest past the capacity; and with capacity 1, every warp
    walking, the same bits."""
    _need_card()
    calls, _, _, sweeps = iisph_check.calls(run, RUNS[run], torch.float64)
    found = iisph_check.check_linked(calls, run, TOL[torch.float64])
    later = FIXED[run] - (4 if run == 'dam_break_2d' else 1) + 2 * sweeps
    assert found['linked'] == 1 and found['overflowed'] == 0
    assert found['consumers'] == later
    small = iisph_check.check_linked(calls, run + ', capacity 1',
                                     TOL[torch.float64], capacity=1)
    assert small['overflowed'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('chunk', [1, 10])
@pytest.mark.parametrize('run', list(RUNS))
def test_iisph_steps_linked_and_unlinked_agree(run, chunk):
    """Five steps of an IISPH run in float64 as the path runs them (the
    links, the pressure group in one ``iisph_solve`` launch; per step or
    in a captured chunk) and with each pair call walking and the sweeps
    on the host: every state bit for bit but ``tmp_comp`` (reduce's sums,
    taken in another order: 1e-12 of it), the same sweeps, and the
    launches those sweeps imply."""
    _need_card()
    states, sweeps = [], []
    for linked in (True, False):
        app = iisph_check.app(run, RUNS[run], torch.float64, steps=5)
        s = app.solver
        s.chunk_steps = chunk if linked else 1
        a_eval, = s.acceleration_evals
        if not linked:
            a_eval.solve_iterated = False
            for plan in a_eval._plans.values():
                if plan is not None:
                    plan.link = None
        ip.iisph_pair.launches = isv.iisph_solve.launches = 0
        s.solve()
        k = a_eval.sweeps
        if linked:
            # a capture counts its steps' launches once
            evals = 1 + (5 if chunk == 1 else 10 + 1)
            assert (ip.iisph_pair.launches, isv.iisph_solve.launches) == (
                FIXED[run] * evals, evals)
            assert s.captures == (chunk > 1) and a_eval.converged_reads == 0
        else:
            assert ip.iisph_pair.launches == sum(FIXED[run] + 2 * n
                                                 for n in k)
        states.append(s.states)
        sweeps.append(k)
    assert sweeps[0] == sweeps[1] and len(sweeps[0]) == 6
    for name, st in states[0].items():
        for p, v in st.items():
            if p == 'tmp_comp':
                assert torch.allclose(v, states[1][name][p], rtol=1e-12,
                                      atol=0.0), name
            else:
                assert torch.equal(v, states[1][name][p]), (name, p)


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('run', list(RUNS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_iisph_solve_matches_plain_version_and_chain(dtype, run, edges):
    """The pressure group's ``iisph_solve`` call of one evaluation: within
    the tolerance of its plain version with the same sweeps, and the
    per-launch chain bit for bit where the sweeps agree, at the call's
    tolerance, 30 sweeps and 2."""
    _need_card()
    calls, _, _, _ = iisph_check.calls(run, RUNS[run], dtype, edges=edges,
                                       solve=True)
    call, = iisph_check.solve_calls(calls)
    found = iisph_check.check_solve(call, run, TOL[dtype])
    assert found['max']['sweeps'] == 30 and found['min']['sweeps'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('blocks', [1, 3])
def test_iisph_solve_on_a_few_blocks(blocks):
    """The solve on one block and on three (each thread several tiles of
    dests, the partials of fewer blocks): the same results."""
    _need_card()
    calls, _, _, _ = iisph_check.calls('dam_break_2d', RUNS['dam_break_2d'],
                                       torch.float64, solve=True)
    call, = iisph_check.solve_calls(calls)
    iisph_check.check_solve(call, 'blocks=%d' % blocks, TOL[torch.float64],
                            blocks=blocks)


@pytest.mark.cuda
def test_iisph_solve_refuses_a_grid_the_card_cannot_hold():
    _need_card()
    calls, _, _, _ = iisph_check.calls('taylor_green', RUNS['taylor_green'],
                                       torch.float32, solve=True)
    (_, _, _, args), = iisph_check.solve_calls(calls)
    with pytest.raises(RuntimeError, match='iisph_solve launch failed'):
        isv.iisph_solve(*args, blocks=132 * 2048)
