"""``crksph_pair``'s neighbour list and ``crk_solve`` on the CPU, float64.

- The planner links the first evaluator of ``CRKSPHScheme`` on the
  accuracy test, the hydrostatic box and the Taylor-Green vortex: the
  number density plan emits, the moments, density and velocity gradient
  plans read (``Link.middle``), the momentum plan consumes; the energy
  plan of the second evaluator walks, unlinked;
- a link is refused, and the refusal logged, where an equation that
  writes ``h`` lies between the sets, and in 3D, where the list has no
  capacity (the 3D box's sets all walk);
- the linked chain on the CPU runs the plain version for every call and
  hands an empty list over (``crksph_check.check_linked``), and the
  wrapper refuses a hand-off given to a set that does not read one;
- ``crk_solve`` on CPU tensors is its torch ops (``crk_solve_reference``)
  bit for bit and launches nothing, ``crksph.crk_solve`` is it, and the
  kernel's wrapper refuses moments whose rows are not d-packed;
- ``roofline.crksph_path_work`` counts the linked design: one walk's
  candidates for the emitter and the energy, none for the readers, whose
  list entries it reads; ``crk_solve_work`` the solve's bytes.

The card's side is ``tests/test_torch_crksph_cuda.py``.
"""

import logging

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import crk_solve as cs
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.ops import pair_link
from pysph_tpu_torch.sph.equation import Equation, Group
from pysph_tpu_torch.sph.wc import crksph
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import crksph_check, roofline
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

#: (run, size) of each example at a small size
RUNS = [('accuracy_test_2d', 12), ('hydrostatic_box', 12),
        ('taylor_green', 10)]


def _links(evaluator):
    return list({id(p.link): p.link for p in evaluator._plans.values()
                 if p is not None and p.link is not None}.values())


def _terms(plan):
    return plan.sources[0].terms


@pytest.mark.parametrize('run,size', RUNS)
def test_the_first_evaluator_runs_on_one_list(run, size):
    app = crksph_check.app(run, size, torch.float64, device='cpu')
    first, second = app.solver.acceleration_evals
    (link,) = _links(first)
    assert _terms(link.emitter) == cp.NDEN
    assert [_terms(p) for p in link.middle] == [cp.MOMS, cp.RHO, cp.GRADV]
    assert _terms(link.consumer) & ~cp.VISC == cp.MOM
    assert _links(second) == []
    (energy,) = [p for p in second._plans.values() if p is not None]
    assert _terms(energy) == cp.ENERGY and energy.link is None


class ScaleH(Equation):
    """Writes h: the pairs may move after it."""

    def initialize(self, d_idx, d_h):
        d_h[d_idx] = 1.0 * d_h[d_idx]


def _evaluator(case, groups):
    props, dim, _ = crksph_check.lattice(case)
    pa = crksph.get_particle_array_crksph(name='fluid', **props)
    return SPHEvaluator([pa], groups, dim=dim, kernel=QuinticSpline(dim=dim),
                        config=Config(device='cpu', dtype=torch.float64))


def test_a_group_that_writes_h_between_the_sets_refuses_the_link(caplog):
    stage1 = crksph_check.stages('open', 2)[0]
    # after the moments group, before the density group
    groups = stage1[:3] + [Group(equations=[ScaleH('fluid', None)])] + \
        stage1[3:]
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        ev = _evaluator('open', groups)
    assert _links(ev.func_eval) == []
    assert 'crksph_pair for fluid: no link: ScaleH is not among the ' \
        'equations that keep the pairs' in caplog.text
    # without it the same groups link
    assert len(_links(_evaluator('open', stage1).func_eval)) == 1


def test_3d_refuses_the_link_and_walks(caplog):
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        ev = _evaluator('3d', crksph_check.stages('3d', 3)[0])
    assert _links(ev.func_eval) == []
    assert 'crksph_pair for fluid: no link: no list capacity in 3D' in \
        caplog.text
    assert 3 not in cp.CAPACITY and cp.CAPACITY[2] >= 128


def test_the_chain_runs_the_plain_version_on_the_cpu():
    calls, _, _ = crksph_check.calls('accuracy_test_2d', 12, torch.float64,
                                     device='cpu')
    found = crksph_check.check_linked(calls, 'accuracy 12', 1e-10)
    assert found['max_scaled_err'] == 0.0 and found['against_walk'] == 0.0
    assert found['most_pairs'] > 100 and found['overflowed'] == 0
    chain = crksph_check.chain(calls)
    assert [_terms(c[2]) for c in chain][:4] == [cp.NDEN, cp.MOMS, cp.RHO,
                                                 cp.GRADV]
    (_, _, emitter, args) = chain[0]
    _, handoff = emitter.op(*args, emit=True)
    assert handoff.buf.numel() == 0 and handoff.count is None
    (_, _, energy, eargs) = calls[-1]
    with pytest.raises(ValueError, match='takes no hand-off'):
        energy.op(*eargs, handoff=handoff)
    with pytest.raises(ValueError, match='only a number density call emits'):
        chain[1][2].op(*chain[1][3], emit=True)


def _moments(d, n=200, seed=11):
    rng = np.random.default_rng(seed)
    m2 = rng.normal(size=(n, 9))
    m2[:7] = 0.0           # singular
    m2[7:12, :d * d] = 1.0  # singular too, but not in 1D
    full = dict(m0=1.0 + 0.1 * rng.normal(size=n),
                m1=0.1 * rng.normal(size=(n, 3)), m2=m2,
                gm0=rng.normal(size=(n, 3)), gm1=rng.normal(size=(n, 9)),
                gm2=rng.normal(size=(n, 27)),
                nnbr=rng.integers(0, 30, size=n).astype(float))
    t = {k: torch.as_tensor(v) for k, v in full.items()}
    return (t['m0'], t['m1'][:, :d], t['m2'][:, :d * d].reshape(n, d, d),
            t['gm0'][:, :d], t['gm1'][:, :d * d].reshape(n, d, d),
            t['gm2'][:, :d ** 3].reshape(n, d, d, d), t['nnbr'], d)


@pytest.mark.parametrize('d', [1, 2, 3])
def test_the_solve_on_the_cpu_is_its_torch_ops(d):
    args = _moments(d)
    cs.crk_solve.launches = 0
    got = crksph.crk_solve(*args)
    want = cs.crk_solve_reference(*args)
    assert crksph.crk_solve is cs.crk_solve and cs.crk_solve.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    singular = 7 if d == 1 else 12
    assert bool((got[0][:singular] == 1.0).all())


def test_the_solve_kernel_refuses_moments_it_cannot_read():
    m0, m1, m2, gm0, gm1, gm2, nnbr, d = _moments(2)
    with pytest.raises(ValueError, match='d-packed'):
        cs._row_stride(m2.transpose(1, 2), 'm2', m0.shape[0], d,
                       torch.float64, m0.device)
    assert cs._row_stride(m2, 'm2', m0.shape[0], d, torch.float64,
                          m0.device) == 9
    with pytest.raises(ValueError, match='no kernel for device meta'):
        cs.crk_solve(*(t.to('meta') for t in (m0, m1, m2, gm0, gm1, gm2,
                                                nnbr)), d)


def test_the_work_counter_counts_the_linked_design():
    calls, n, _ = crksph_check.calls('accuracy_test_2d', 12, torch.float64,
                                     device='cpu')
    walks = [roofline.crksph_work(*c[3]) for c in calls]
    path = roofline.crksph_path_work(calls)
    # the emitter's and the energy's walks, no reader's
    assert path['candidates'] == walks[0]['candidates'] + \
        walks[-1]['candidates']
    assert path['pairs'] == sum(w['pairs'] for w in walks)
    reads = roofline.crksph_work(*calls[1][3], mode='read')
    assert reads['flops'] == walks[1]['pair_flops']
    assert reads['bytes'] == walks[1]['bytes'] + 4 * (walks[1]['pairs'] + n)
    emit = roofline.crksph_work(*calls[0][3], mode='emit')
    assert emit['bytes'] == walks[0]['bytes'] + 4 * (walks[0]['pairs'] + n)
    assert path['flops'] < roofline.add(*walks)['flops']
    solve = roofline.crk_solve_work(n, 2, 8)
    assert solve['bytes'] == n * 8 * (22 + 9)
    assert roofline.bound(solve)[1] == 'bytes'


def test_the_list_of_an_empty_handoff_is_empty():
    calls = crksph_check.box_calls('open', torch.float64, device='cpu')
    (_, _, emitter, args) = calls[0]
    _, handoff = emitter.op(*args, emit=True)
    assert handoff.sources == pair_link.copies_of(args[4])
    assert handoff.nbr.shape == (0, args[0]['x'].shape[0])
