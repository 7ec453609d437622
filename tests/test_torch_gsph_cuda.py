"""``GSPHScheme``'s pair phases on the hand-written ``gsph_pair`` and
``ADKEScheme``'s on ``gasd_pair``'s ADKE sets against their plain torch
versions, on the card: every set of one evaluation of the accuracy test
(2D, periodic), the hydrostatic box and the shock tube (1D, h jumping at
the diaphragm) from a jittered start, in float64 and float32, each
dest's pairs in support equal to the plain version's; the acceleration
under every Riemann solver and every branch (``gasd_check.BRANCHES``);
the eleven device Riemann solvers against the torch ones; a CUDA tensor
with an unknown solver refused, not run on the plain version; the runs
in chunks against the per-step loop bit for bit; ADKE's sets
(``csrc/adke_pair.cu``, a group of lanes a dest) on periodic grids of 1,
2, 3, 5 and 8 cells an axis and on probe dests that fill no whole block,
a third of them without a pair, each launch repeated bit for bit; and
the linked pair:
the acceleration on the gradients launch's list bit for bit the walking
launch, on the accuracy test (periodic) and the shock tube (open), with
the list's capacity cut so that some warps walk.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gsph_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import gasd_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: (run, size) at a small size, by scheme
RUNS = [('accuracy_test_2d', 24), ('hydrostatic_box', 20),
        ('shocktube', 80)]
#: each scheme's pair calls: their kernels and term masks
SETS = {'gsph': [(gd.gasd_pair, gd.SDEN), (gd.gasd_pair, gd.SDEN),
                 (gs.gsph_pair, gs.GRAD), (gs.gsph_pair, gs.ACC)],
        'adke': [(gd.gasd_pair, gd.ADEN), (wp.wcsph_pair, wp.SDEN),
                 (gd.gasd_pair, gd.ADKE)]}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('scheme', list(SETS))
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_gas_scheme_sets_match_plain_versions(dtype, run, size, scheme):
    _need_card()
    calls, _, _ = gasd_check.calls(run, size, dtype,
                                   extra=('--scheme', scheme))
    assert [(c[2].op, c[2].sources[0].terms) for c in calls] == SETS[scheme]
    gs.gsph_pair.launches = gd.gasd_pair.launches = 0
    found = gasd_check.check(calls, '%s %s %s' % (run, scheme, dtype),
                             TOL[dtype])
    assert gs.gsph_pair.launches == (2 if scheme == 'gsph' else 0)
    assert found['pairs'] > 0 and found['nnbr_differ'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('cells', [1, 2, 3, 5, 8, None])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_adke_sets_on_few_cells_and_probes(dtype, cells):
    """ADKE's sets on a periodic grid of ``cells`` cells an axis (the
    image by the range's wrap and by the division both taken) or, at
    None, on an open grid with probe dests (``gasd_check.adke_calls``):
    one launch of the ADKE library a call, the pairs and each dest's
    count exactly the plain version's, every output within the
    tolerance."""
    _need_card()
    calls = gasd_check.adke_calls(cells, dtype)
    gd.gasd_pair.adke_launches = 0
    found = gasd_check.check(calls, 'adke cells %s %s' % (cells, dtype),
                             TOL[dtype])
    assert gd.gasd_pair.adke_launches == len(calls)
    assert found['pairs'] > 0 and found['nnbr_differ'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_adke_launches_repeat_bit_for_bit(dtype, run, size):
    _need_card()
    calls, n, _ = gasd_check.calls(run, size, dtype,
                                   extra=('--scheme', 'adke'))
    assert gasd_check.repeats(calls) == 2 * n
    assert gasd_check.repeats(gasd_check.adke_calls(None, dtype)) == 2 * (
        gasd_check.ADKE_LATTICE ** 2 + gasd_check.ADKE_PROBES)


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', [('accuracy_test_2d', 24),
                                      ('shocktube', 80)])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_every_branch_matches_plain_version(dtype, run, size):
    _need_card()
    calls, _, _ = gasd_check.calls(run, size, dtype,
                                   extra=('--scheme', 'gsph'))
    branches = gasd_check.branch_calls(calls)
    assert len(branches) == len(gasd_check.BRANCHES)
    for label, call in branches.items():
        gasd_check.check([call], '%s %s %s' % (run, label, dtype),
                         TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_device_riemann_solvers_match_torch(dtype):
    _need_card()
    found = gasd_check.riemann_check(dtype, n=20000)
    assert sorted(found) == list(range(11))


@pytest.mark.cuda
def test_unknown_solver_is_refused_on_the_card():
    _need_card()
    calls, _, _ = gasd_check.calls('accuracy_test_2d', 16, torch.float64,
                                   extra=('--scheme', 'gsph'))
    _, _, plan, args = calls[-1]
    srcs = [(st, cells, ss._replace(params=ss.params._replace(rsolver=11)))
            for st, cells, ss in args[4]]
    with pytest.raises(ValueError, match='no Riemann solver 11'):
        gs.gsph_pair(*args[:4], srcs, *args[5:])
    x = torch.ones(3, dtype=torch.float64, device='cuda')
    with pytest.raises(ValueError, match='no Riemann solver'):
        gs.riemann(11, x, x, x, x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize('run,size,scheme', [
    ('accuracy_test_2d', 24, 'gsph'), ('accuracy_test_2d', 24, 'adke'),
    ('hydrostatic_box', 20, 'gsph'), ('shocktube', 80, 'adke')])
def test_runs_in_chunks_equal_the_per_step_loop(run, size, scheme):
    """12 steps in float64 in chunks of 4 (CUDA graphs, t and dt on the
    card) and per step: every prop equal bit for bit, t, dt and the
    count too, every pair phase on a kernel."""
    _need_card()
    got = {}
    for k in (4, 1):
        app = gasd_check.app(run, size, torch.float64, steps=12,
                             extra=('--scheme', scheme))
        s = app.solver
        s.chunk_steps = k
        app.solve()
        assert set(s.acceleration_evals[0].engine_choices.values()) == {
            'kernel'}
        got[k] = s
    a, b = got[4], got[1]
    assert a.replays and a.count == b.count == 12
    assert a.t == b.t and a.dt == b.dt
    differ = [p for p, v in b.states['fluid'].items()
              if not torch.equal(v, a.states['fluid'][p])]
    assert not differ
    assert cell_pack.pack.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize('capacity', [None, 8])
@pytest.mark.parametrize('run,size', [('accuracy_test_2d', 24),
                                      ('shocktube', 80)])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_linked_acceleration_is_the_walk(dtype, run, size, capacity):
    """The gradients launch's list is ``neighbours_reference``'s and the
    acceleration launch on it is the walking launch bit for bit."""
    _need_card()
    calls, _, _ = gasd_check.calls(run, size, dtype,
                                   extra=('--scheme', 'gsph'))
    found = gasd_check.check_gsph_linked(
        calls, '%s %s' % (run, dtype), TOL[dtype], capacity)
    assert found['pairs'] > 0
    assert (found['overflowed'] > 0) == (capacity is not None)


@pytest.mark.cuda
def test_the_path_runs_the_linked_acceleration_on_fitted_cells():
    """The accuracy test's evaluation links its gradients launch to its
    acceleration launch; its binnings' periodic counts fit their own
    h."""
    _need_card()
    app = gasd_check.app('accuracy_test_2d', 32, torch.float32, steps=12,
                         extra=('--scheme', 'gsph'))
    s = app.solver
    app.solve()
    assert s.count == 12
    a_eval = s.acceleration_evals[0]
    grads, acc = [p for p in a_eval._plans.values()
                  if p is not None and p.op is gs.gsph_pair]
    assert grads.link is acc.link is not None
    for b in a_eval.kept_binnings():
        w = float(b.handle.width)
        cell = b.handle.grid.box_host(torch.float64)['stale']
        assert w <= cell < 2 * w, (b.name, w, cell)
