"""``CRKSPHScheme``'s pair phases on the hand-written ``crksph_pair``
against their plain torch versions, on the card: the six sets of both
evaluators of the accuracy test, the hydrostatic box and the
Taylor-Green vortex (2D, periodic) from a jittered start after a step,
and of the seeded boxes (periodic 16^2 with ``LaminarViscosity``, open
12^2 with a particle whose system is singular, open 6^3), in float64 and
float32, each dest's pairs in support equal to the plain version's;
the first evaluator's linked chain (the number density emitting the
neighbour list, the moments, density, velocity gradient and momentum
reading it) against the plain version and the walking launches, the
list against ``neighbours_reference`` (``crksph_check.check_linked``),
also with the list's capacity forced small (every dest, or those past
it, walking: the overflow path, counted); ``crk_solve`` against its
plain version with singular particles, in 2D and 3D; another kernel kind
(its own library), walking and linked; a 1D dest on the card raising
rather than running on the plain version; and the accuracy test's run in
chunks against the per-step loop bit for bit.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_crksph_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import crk_solve as cs
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.tools_dev import crksph_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: (run, size) at a small size
RUNS = [('accuracy_test_2d', 24), ('hydrostatic_box', 20),
        ('taylor_green', 20)]
ORDER = ['number density', 'moments', 'density', 'velocity gradient',
         'momentum', 'energy']


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


def _sets(calls):
    return [crksph_check.SET_NAMES[c[2].sources[0].terms] for c in calls]


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_run_sets_match_plain_versions(dtype, run, size):
    _need_card()
    calls, _, _ = crksph_check.calls(run, size, dtype)
    assert _sets(calls) == ORDER
    cp.reset_launches()
    packs = cell_pack.pack.launches
    found = crksph_check.check(calls, '%s %d' % (run, size), TOL[dtype])
    assert cp.crksph_pair.by_set == [1] * 6
    assert cell_pack.pack.launches == packs + 6
    assert found['pairs'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['periodic', 'open', '3d'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_box_sets_match_plain_versions(dtype, case):
    _need_card()
    calls = crksph_check.box_calls(case, dtype)
    assert _sets(calls) == ORDER
    found = crksph_check.check(calls, case, TOL[dtype])
    assert set(found['by_set']) == set(ORDER)


@pytest.mark.cuda
def test_another_kind_matches_its_plain_version():
    """``--kernel WendlandQuintic`` (kind 0): a library of its own."""
    _need_card()
    app = crksph_check.app('hydrostatic_box', 20, torch.float64,
                           extra=('--kernel', 'WendlandQuintic'))
    s = app.solver
    crksph_check.jitter(s)
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    from pysph_tpu_torch.tools_dev.time_walks import plan_calls
    calls = plan_calls(s, [0, 1])
    assert calls[0][2].kernel.__class__.__name__ == 'WendlandQuintic'
    assert cp.kind_flags(calls[0][2].kernel) == ('-DPAIR_KIND=0',)
    crksph_check.check(calls, 'hydrostatic_box WendlandQuintic',
                       TOL[torch.float64])
    crksph_check.check_linked(calls, 'hydrostatic_box WendlandQuintic',
                              TOL[torch.float64])


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_the_linked_chain_matches_the_walk(dtype, run, size):
    _need_card()
    calls, _, _ = crksph_check.calls(run, size, dtype)
    cp.reset_launches()
    found = crksph_check.check_linked(calls, '%s %d' % (run, size),
                                      TOL[dtype])
    # the chain, and each reading call once more walking
    assert cp.crksph_pair.by_set == [1, 2, 2, 2, 2, 0]
    assert found['overflowed'] == 0 and found['most_pairs'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('capacity', [1, 24])
def test_dests_past_the_capacity_walk(capacity):
    """The overflow path: a dest past the list's capacity makes its warp
    walk, and the emitting launch counts it."""
    _need_card()
    calls, _, _ = crksph_check.calls('accuracy_test_2d', 24, torch.float64)
    found = crksph_check.check_linked(calls, 'capacity %d' % capacity,
                                      TOL[torch.float64], capacity=capacity)
    n = calls[0][3][0]['x'].shape[0]
    assert 0 < found['overflowed'] <= n


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['open', '3d'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_the_solve_kernel_matches_its_plain_version(dtype, case):
    """On the moments of the box's evaluation (the open box's far
    particle singular, with one neighbour), and on seeded moments whose
    systems are singular."""
    _need_card()
    calls = crksph_check.box_calls(case, dtype)
    dim = 3 if case == '3d' else 2
    cs.crk_solve.launches = 0
    _, _, singular = crksph_check.check_solve(calls[2][3][0], dim,
                                              TOL[dtype], case)
    assert singular == (1 if case == 'open' else 0)
    assert cs.crk_solve.launches == 1
    st = dict(calls[2][3][0])
    gen = torch.Generator(device='cuda').manual_seed(3)
    for p in ('crk_m2', 'crk_gm1', 'crk_gm2'):
        st[p] = torch.randn(st[p].shape, generator=gen, device='cuda',
                            dtype=dtype)
    # well-posed systems, five of them singular
    eye = torch.zeros(9, dtype=dtype, device='cuda')
    eye[:dim * dim] = torch.eye(dim, dtype=dtype, device='cuda').reshape(-1)
    st['crk_m2'] = 0.1 * st['crk_m2'] + eye
    st['crk_m2'][:5] = 0.0
    _, _, singular = crksph_check.check_solve(st, dim, TOL[dtype],
                                              case + ' seeded')
    assert singular >= 5


@pytest.mark.cuda
def test_a_1d_dest_on_the_card_raises():
    _need_card()
    calls = crksph_check.box_calls('open', torch.float64)
    _, _, plan, args = calls[0]
    args = args[:6] + (QuinticSpline(dim=1),)
    cp.reset_launches()
    with pytest.raises(NotImplementedError, match='item 27'):
        plan.op(*args)
    assert cp.crksph_pair.launches == 0


@pytest.mark.cuda
def test_chunks_equal_the_per_step_loop():
    _need_card()
    got = {}
    for k in (10, 1):
        app = crksph_check.app('accuracy_test_2d', 32, torch.float32,
                               steps=20)
        app.solver.chunk_steps = k
        app.solve()
        got[k] = app.solver
    a, b = got[10], got[1]
    assert a.replays and a.count == b.count == 20 and a.t == b.t
    for p, v in b.states['fluid'].items():
        assert torch.equal(v, a.states['fluid'][p]), p
