"""``TSPHScheme``'s pair phases on the hand-written ``tsph_pair`` against
their plain torch versions, on the card: the three sets of the accuracy
test, the hydrostatic box (2D, periodic), Sedov's blast (2D, open) and
Cheng-Shu's wave (1D, periodic) from a jittered start after a step, in
float64 and float32, each dest's pairs in support equal to the plain
version's, the launches counted; ``tsph_sweep`` on every sweep of an
iteration (``gasd_check.check_sweep``: the outputs, converged flags and
count, the emitted list against ``neighbours_reference``, the velocity
gradient and the momentum on the last sweep's list bit for bit their
walks), also with the list's capacity 1 (every dest walking, counted);
a sweep gated off writing nothing; a seeded open 3D box (its library
built at first use); another kernel kind (its own library); and the
accuracy test's run in chunks against the per-step loop bit for bit.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tsph_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.kernels import Gaussian
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.sph.gas_dynamics import tsph
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import gasd_check, tsph_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: (run, size) at a small size
RUNS = [('accuracy_test_2d', 24), ('hydrostatic_box', 20), ('sedov', 15),
        ('cheng_shu_1d', 200)]
ORDER = [ts.SDEN, ts.GRADV, ts.MOM]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_run_sets_match_plain_versions(dtype, run, size):
    _need_card()
    calls, _, _ = tsph_check.calls(run, size, dtype)
    assert [c[2].sources[0].terms for c in calls] == ORDER
    ts.reset_launches()
    packs = cell_pack.pack.launches
    found = tsph_check.check(calls, '%s %s' % (run, dtype), TOL[dtype])
    assert found['pairs'] > 0
    assert ts.tsph_pair.by_set == [1, 1, 1]
    assert cell_pack.pack.launches == packs + 3


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', RUNS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_sweeps_lists_and_readers(dtype, run, size):
    _need_card()
    # after two steps, where h has met hfact's (the accuracy test starts
    # at 2 dx, every dest past the list's capacity)
    s = tsph_check.sweep_start(run, size, dtype, steps=2)
    found = gasd_check.check_sweep(s, '%s %s' % (run, dtype), TOL[dtype])
    assert found['sweeps'] > 1 and found['linked'] == 2
    assert found['overflowed'] == 0
    if dtype == torch.float64:
        assert found['flags_differ'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('capacity', [1, 8])
def test_sweep_list_past_its_capacity(capacity):
    _need_card()
    s = tsph_check.sweep_start('accuracy_test_2d', 24, torch.float64)
    found = gasd_check.check_sweep(s, 'capacity %d' % capacity,
                                   TOL[torch.float64], capacity=capacity)
    assert found['overflowed'] > 0 and found['linked'] == 2


@pytest.mark.cuda
def test_a_sweep_gated_off_writes_nothing():
    _need_card()
    s = tsph_check.sweep_start('hydrostatic_box', 20, torch.float64)
    states = {n: dict(st) for n, st in s.states.items()}
    plan, _, args = gasd_check._sweep_args(s, states)
    store = args[0]
    store.update({p: store[p].clone() for p in ts.SWEEP_OUTPUTS})
    before = {p: store[p].clone() for p in ts.SWEEP_OUTPUTS}
    buffers = gasd_check.gd.SweepBuffers(store, args[3], 2, plan.capacity)
    run = torch.zeros((), dtype=torch.bool, device='cuda')
    ts.reset_launches()
    out, unconv = ts.tsph_sweep(*args, run=run, buffers=buffers)
    assert int(unconv) == 0 and ts.tsph_sweep.launches == 1
    for p in ts.SWEEP_OUTPUTS:
        assert out[p] is store[p] and torch.equal(store[p], before[p]), p
    run.fill_(True)
    out, unconv = ts.tsph_sweep(*args, run=run, buffers=buffers)
    want, wun = gasd_check._plain_sweep(
        (dict(args[0], **before),) + args[1:], plan.op)
    assert int(unconv) == int(wun) > 0


def _box_calls(dtype, nx=8, seed=1):
    """The three calls of TSPHScheme's evaluation on a seeded open 3D
    lattice, after one evaluation on the card."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / nx
    g = (np.arange(nx) + 0.5) * dx
    x, y, z = (c.ravel() for c in np.meshgrid(g, g, g))
    n = x.size
    P = {c: v + 0.1 * dx * rng.uniform(-1, 1, n)
         for c, v in (('x', x), ('y', y), ('z', z))}
    P.update(h=1.2 * dx * (1 + 0.1 * rng.uniform(-1, 1, n)),
             rho=1 + 0.3 * rng.random(n), u=0.3 * rng.normal(size=n),
             v=0.3 * rng.normal(size=n), w=0.3 * rng.normal(size=n))
    P['m'] = dx ** 3 * P['rho']
    pa = get_particle_array(name='fluid', **P)
    sch = tsph.TSPHScheme(['fluid'], [], dim=3, gamma=1.4, hfact=1.2)
    sch.setup_properties([pa])
    pa.properties['e'][:] = 1.0 + rng.random(n)
    pa.properties['h0'][:] = pa.properties['h']
    pa.properties['alpha'][:] = rng.random(n)
    ev = SPHEvaluator([pa], sch.get_equations(), dim=3,
                      kernel=Gaussian(dim=3),
                      config=Config(device='cuda', dtype=dtype))
    ev.evaluate(0.0, 1e-3)
    a_eval = ev.func_eval
    states = {'fluid': pa.to_device(ev.config)}
    cells = a_eval.grid.bin_all(states)
    calls = []
    for group in a_eval.leaf_groups():
        plan = a_eval._plans.get((id(group), 'fluid'))
        if plan is None:
            continue
        st = states['fluid']
        pre = {p: torch.zeros_like(st[p]) for p in plan.outputs}
        calls.append((0, 'fluid', plan, plan.args(st, states, cells,
                                                  a_eval.grid, None, pre)))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_3d_box_matches_plain_versions(dtype):
    _need_card()
    calls = _box_calls(dtype)
    assert [c[2].sources[0].terms for c in calls] == ORDER
    found = tsph_check.check(calls, '3d %s' % dtype, TOL[dtype])
    assert found['pairs'] > 0


@pytest.mark.cuda
def test_another_kind_matches_plain_versions():
    _need_card()
    app = tsph_check.app('hydrostatic_box', 20, torch.float64, steps=2,
                         extra=('--kernel', 'CubicSpline'))
    s = app.solver
    gasd_check.jitter(s)
    s.solve()
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    assert ts.kind_flags(s.acceleration_evals[0].kernel) == (
        '-DPAIR_KIND=1',)
    calls = tsph_check.plan_calls(s, [0])
    tsph_check.check(calls, 'CubicSpline', TOL[torch.float64])
    found = gasd_check.check_sweep(
        tsph_check.sweep_start('hydrostatic_box', 20, torch.float64, steps=2,
                               extra=('--kernel', 'CubicSpline')),
        'hydrostatic CubicSpline', TOL[torch.float64])
    assert found['linked'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('run,size', [('accuracy_test_2d', 24),
                                      ('cheng_shu_1d', 200)])
def test_chunks_equal_the_per_step_loop(run, size):
    _need_card()
    states, sweeps = [], []
    for chunk_steps in (1, 4):
        app = tsph_check.app(run, size, torch.float64, steps=8)
        s = app.solver
        s.chunk_steps = chunk_steps
        assert s._chunk_eligible() == (chunk_steps > 1)
        ts.reset_launches()
        app.solve()
        assert s.count == 8 and ts.tsph_sweep.launches
        assert all(ts.tsph_pair.by_set[1:])
        if chunk_steps > 1:
            assert s.captures and s.replays
        states.append({p: v.clone() for p, v in s.states['fluid'].items()})
        sweeps.append(list(s.acceleration_evals[0].sweeps))
    for p, v in states[0].items():
        assert torch.equal(v, states[1][p]), (run, p)
    assert sweeps[0] == sweeps[1]
