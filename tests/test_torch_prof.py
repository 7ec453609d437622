"""The pair stub (``ops/pair_stub.py``), the ported profiling tools'
inner functions and the work counter (``tools_dev/roofline.py``) on the
CPU, at dam_break_3d dx=0.12, held against ``pysph_tpu`` and a
brute-force numpy count; and the TVF wall examples' entries of the timed
paths (``tools_dev/time_chunks.py``), set up on the CPU."""

import numpy as np
import pytest
import torch

from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import pair_stub as ps
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.tools_dev import (
    prof_dma, prof_phases, roofline, time_chunks, time_walks)
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

DX = 0.12
PROPS = ('au', 'av', 'aw', 'arho', 'ax', 'ay', 'az', 'rho', 'p')


def _app(seed=7):
    """dam_break_3d at DX on the CPU with seeded velocities and density,
    so that every pair term is non-zero."""
    app = prof_dma.setup(DX, 'cpu')
    rng = np.random.default_rng(seed)
    for st in app.solver.states.values():
        n = st['x'].shape[0]
        for p in ('u', 'v', 'w'):
            st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n),
                                    dtype=st['x'].dtype)
        st['rho'] = torch.as_tensor(1000.0 * (1.0 + 0.01 * rng.normal(
            size=n)), dtype=st['x'].dtype)
    return app


def _calls(app):
    a_eval = app.solver.acceleration_evals[0]
    a_eval.update_and_compute(0.0, app.solver.dt, app.solver.states)
    return prof_dma.pair_calls(a_eval, app.solver.states)


@pytest.mark.parametrize('mode', ps.MODES)
def test_pair_stub_gives_exact_zeros_of_the_kernels_outputs(mode):
    calls = _calls(_app())
    assert [plan.dest for plan, _ in calls] == ['boundary', 'obstacle',
                                                'fluid']
    for plan, args in calls:
        want = wp.wcsph_pair(*args)
        for fn in (ps.pair_stub, ps.pair_stub_reference):
            got = fn(*args, mode=mode)
            assert set(got) == set(want) == set(plan.outputs)
            for p, v in got.items():
                assert v.shape == want[p].shape and v.dtype == want[p].dtype
                assert bool((v == 0).all())
    with pytest.raises(ValueError, match='mode'):
        ps.pair_stub(*calls[0][1], mode='some')


def test_prof_phases_dest_split_is_the_jax_group_1_split():
    ref = JaxDamBreak3D()
    ref.setup(['--dx', str(DX), '--disable-output', '-q'])
    jax_g1 = ref.solver.integrator.acceleration_evals[0].groups[1]
    want = {}
    for eq in jax_g1.equations:
        want.setdefault(eq.dest, []).append(
            (type(eq).__name__, tuple(eq.sources)))
    a_eval = _app().solver.acceleration_evals[0]
    got = {d: [(type(e).__name__, tuple(e.sources)) for e in eqs]
           for d, eqs in prof_phases.dest_split(a_eval).items()}
    assert list(got) == list(want)
    assert got == want


def test_prof_phases_runs_each_dest_share_and_restores_the_eval():
    app = _app()
    s = app.solver
    a_eval = s.acceleration_evals[0]
    groups, plans = a_eval.groups, a_eval._plans
    choices = dict(a_eval.engine_choices)
    g1 = a_eval.groups[1]
    for dest, eqs in prof_phases.dest_split(a_eval).items():
        group = Group(equations=eqs, real=g1.real)
        prof_phases.with_groups(a_eval, [group],
                                lambda: a_eval.update_and_compute(
                                    0.0, s.dt, s.states))
        assert s.acceleration_evals[0].groups is groups
    assert a_eval._plans is plans and a_eval.engine_choices == choices


@pytest.mark.parametrize('variant', [v for _, v in prof_dma.VARIANTS])
def test_prof_dma_variant_runs_one_eval_on_the_cpu(variant):
    """'real' gives the torch engine's eval; a stub or the skip gives the
    skip's (zeros for every pair output); the plans get their kernel
    back."""
    app = _app()
    states = prof_dma.run_variant(app, variant)
    a_eval = app.solver.acceleration_evals[0]
    assert all(p.op is wp.wcsph_pair for p in a_eval._plans.values() if p)
    if variant == 'real':
        ref = _app()
        ref_eval = ref.solver.acceleration_evals[0]
        for plan in ref_eval._plans.values():
            if plan is not None:
                plan.op = plan.reference
        ref_eval.update_and_compute(0.0, ref.solver.dt, ref.solver.states)
        want = ref.solver.states
    else:
        want = prof_dma.run_variant(_app(), 'skip')
    for name, st in states.items():
        for p in PROPS:
            if p in st:
                torch.testing.assert_close(st[p], want[name][p], rtol=1e-5,
                                           atol=1e-5)
    if variant != 'real':
        assert bool((states['fluid']['arho'] == 0).all())


def _brute(dest, src, dcells, scells, grid):
    """(candidates, pairs in support) of every dest against every source
    particle, in numpy."""
    nx, ny, _ = grid.dims
    dc, sc = dcells.cell.numpy(), scells.cell.numpy()
    dijk = np.stack([dc % nx, (dc // nx) % ny, dc // (nx * ny)], axis=1)
    sijk = np.stack([sc % nx, (sc // nx) % ny, sc // (nx * ny)], axis=1)
    near = (np.abs(dijk[:, None, :] - sijk[None, :, :]) <= 1).all(axis=2)
    r2 = sum((dest[c].numpy()[:, None] - src[c].numpy()[None, :]) ** 2
             for c in 'xyz')
    sup = grid.radius_scale * np.maximum(dest['h'].numpy()[:, None],
                                         src['h'].numpy()[None, :])
    return int(near.sum()), int((near & (r2 < sup * sup)).sum())


@pytest.mark.parametrize('dest', ['boundary', 'obstacle', 'fluid'])
def test_work_counter_pairs_match_a_brute_force_count(dest):
    app = _app()
    calls = {plan.dest: args for plan, args in _calls(app)}
    args = calls[dest]
    dstate, dcells, _, _, sources, grid, _ = args
    cand = pairs = 0
    for src, scells, _ in sources:
        c, p = _brute(dstate, src, dcells, scells, grid)
        cand += c
        pairs += p
        got = roofline.stencil(grid, dcells, scells)
        assert got[0] == c
    work = roofline.wcsph_work(*args)
    assert (work['candidates'], work['pairs']) == (cand, pairs)
    # at dx=0.12 the obstacle's 3 particles see no fluid
    assert (pairs > 0) == (dest != 'obstacle')
    assert work['flops'] >= cand * roofline.SUPPORT_FLOPS
    stub = {m: roofline.stub_work(m, *args) for m in ps.MODES}
    assert stub['all']['candidates'] == cand
    assert stub['third']['candidates'] <= cand
    assert stub['none']['bytes'] < stub['dest']['bytes'] < \
        stub['third']['bytes'] <= stub['all']['bytes']
    ms, by = roofline.bound(work)
    assert ms > 0 and by in ('bytes', 'operations')


#: the wall paths' particles by array, as the reference's examples make
#: them (the cavity at nx=400: 160,000 fluid and 8,921 wall particles)
WALL_PARTICLES = {
    'cavity nx=400': {'fluid': 160000, 'solid': 8921},
    'rayleigh_taylor': {'fluid1': 2501, 'fluid2': 2499, 'solid': 1882},
    'periodic_cylinders': {'fluid': 9128, 'solid': 2472},
}


@pytest.mark.parametrize('path', time_chunks.WALL_PATHS)
def test_wall_paths_set_up_on_their_kernels(path):
    """Each wall path of ``time_chunks.PATHS``, set up on the CPU as the
    card's tools set it up: the example at its size, the timed paths
    under the default binning only, every dest on a kernel (each fluid's
    two groups on ``tvf_pair``, linked; the wall's on ``gtvf_pair``), and
    the work counter counting the no-slip wall's flops."""
    kw = time_chunks.PATHS[path]
    assert kw['dx'] is None and time_chunks.configs(path) == ('reuse',)
    app = kw['cls']()
    app.setup(['--disable-output', '-q', '--device', 'cpu'] +
              list(kw.get('extra', ())))
    s = app.solver
    assert {name: st['x'].shape[0] for name, st in s.states.items()} == \
        WALL_PARTICLES[path]
    a_eval, = s.acceleration_evals
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = [p for p in a_eval._plans.values() if p is not None]
    tvf = [p for p in plans if p.op is tp.tvf_pair]
    assert len(tvf) == 2 * (len(WALL_PARTICLES[path]) - 1)
    assert all(p.link is not None for p in tvf)
    assert [p.op for p in plans if p.dest == 'solid'] == [gp.gtvf_pair] * 2
    momentum = next(p for p in tvf if p.outputs[0] == 'au')
    wall = next(ps_ for ps_ in momentum.sources if ps_.name == 'solid')
    assert wall.terms == tp.MPG | tp.NOSLIP
    if path == 'cavity nx=400':
        return
    # the no-slip term's flops, once a pair of the fluid and the wall
    args = next(c[3] for c in time_walks.plan_calls(s, [0])
                if c[2] is momentum)
    work = roofline.tvf_work(*args)
    src = [c for c in args[4] if c[2].name == 'solid']
    args[4][args[4].index(src[0])] = src[0][:2] + (
        src[0][2]._replace(terms=tp.MPG),)
    without = roofline.tvf_work(*args)
    wall_pairs = roofline.support_pairs(args[5], args[0], args[1],
                                        src[0][0], src[0][1])
    assert wall_pairs > 0 and work['flops'] - without['flops'] == \
        wall_pairs * roofline.TVF_TERM_FLOPS[tp.NOSLIP]
