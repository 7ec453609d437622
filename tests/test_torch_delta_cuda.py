"""The delta-SPH kernels against their plain torch versions, on the card:
``delta_pair`` (the moment matrix and the corrected density gradient)
and ``wcsph_pair`` with the delta-SPH terms, on dam_break_3d
``--delta-sph`` at dx=0.06 with a seeded velocity and density
perturbation and on the elliptical drop (2D, Gaussian); scaled error <=
1e-10 in float64, <= 1e-4 of max|ref| in float32, with the pairs whose
accept decision differs counted (``tools_dev/delta_check.py``).  The
linked pair (the moment call emitting its neighbour list, the gradient
call consuming it) on the same calls: the list equal to
``neighbours_reference``, the gradient the walking one's bit for bit,
also with a capacity so small that every warp walks, and 0 flips; and a
few steps of the path with the links and without them, bit for bit.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_delta_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import delta_check
from pysph_tpu_torch.tools_dev.time_walks import (
    delta_calls, make_app, plan_calls)
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

DTYPES = [torch.float64, torch.float32]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_delta_kernels_match_plain_versions_dam_break(dtype):
    _need_card()
    calls, _, _ = delta_calls(0.06, dtype)
    before = (dl.delta_pair.launches, wp.wcsph_pair.launches)
    found = delta_check.check(calls, 'dam_break_3d dx=0.06 %s' % dtype)
    # two delta_pair calls, one wcsph_pair call with the delta terms,
    # each twice (the output, then the accepted counts or nothing)
    assert dl.delta_pair.launches - before[0] == 3
    assert wp.wcsph_pair.launches - before[1] == 1
    assert 0 < found['accepted'] < found['pairs']
    if dtype == torch.float64:
        assert found['flips'] == 0


def _drop_calls(dtype):
    """The pair calls of one eval of the perturbed delta-SPH drop at
    nx=60, every 7th row outside the gradient group's mask."""
    app = make_app(None, dtype, cls=EllipticalDrop,
                   extra=('--nx', '60', '--delta-sph'))
    s = app.solver
    st = s.states['fluid']
    rng = np.random.default_rng(5)
    n = st['x'].shape[0]
    st['u'] = st['u'] + torch.as_tensor(rng.normal(0.0, 10.0, n),
                                        dtype=dtype, device='cuda')
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n),
                                dtype=dtype, device='cuda')
    st['tag'][::7] = 1      # rows outside the gradient group's mask
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    return plan_calls(s, [0])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_delta_kernels_match_plain_versions_drop(dtype):
    _need_card()
    calls = _drop_calls(dtype)
    assert len(delta_check.delta_calls_of(calls)) == 3
    found = delta_check.check(calls, 'drop nx=60 %s' % dtype)
    assert 0 < found['accepted'] < found['pairs']


@pytest.mark.cuda
def test_delta_kernels_raise_on_bad_arguments():
    _need_card()
    calls, _, _ = delta_calls(0.12, torch.float32)
    (_, _, plan, args), = [c for c in calls if c[2].op is dl.delta_pair
                           and c[2].outputs == ('gradrho',)]
    dest = dict(args[0])
    dest['m_mat'] = dest['m_mat'][:, :3].contiguous()
    with pytest.raises(ValueError, match='d_m_mat'):
        dl.delta_pair(dest, *args[1:])
    sources = [(st, cells, ds._replace(dim=4)) for st, cells, ds in args[4]]
    with pytest.raises(ValueError, match='dim'):
        dl.delta_pair(*args[:4], sources, *args[5:])


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['dam_break', 'drop'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_linked_pair_is_the_walk(dtype, case):
    _need_card()
    calls = delta_calls(0.06, dtype)[0] if case == 'dam_break' \
        else _drop_calls(dtype)
    before = dl.delta_pair.launches
    found = delta_check.check_linked(calls, '%s %s' % (case, dtype))
    # emit, consume (and the accepted counts), the two walking calls
    assert dl.delta_pair.launches - before == 4
    assert found['linked'] == 1 and found['packs'] == 1
    assert found['overflowed'] == 0 and found['flips'] == 0
    assert found['max_count'] <= found['capacity']
    # every dest has its self-pair, nearly all more: every warp walks
    small = delta_check.check_linked(calls, '%s %s, capacity 1'
                                     % (case, dtype), capacity=1)
    assert small['capacity'] == 1
    assert 0.9 * small['dests'] < small['overflowed'] <= small['dests']


@pytest.mark.cuda
def test_linked_path_steps_as_the_walking_path():
    """dam_break_3d --delta-sph at dx=0.06, 6 steps per step and in
    chunks of 3, with the links and with them removed: every prop bit
    for bit."""
    _need_card()
    runs = []
    for linked in (True, False):
        app = make_app(0.06, torch.float32, steps=6,
                       extra=('--delta-sph',))
        s = app.solver
        s.n_damp, s.chunk_steps = 3, 3
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
