"""The launch and gather probes and the pair stub against their plain
torch versions, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_micro_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.ops import pair_stub as ps
from pysph_tpu_torch.tools_dev import common, prof_dma
from pysph_tpu_torch.tools_dev import micro_engine as tool_engine
from pysph_tpu_torch.tools_dev import micro_launch as tool_launch
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-4   # of max|ref|, float32 sums in another order


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= TOL * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize('case', [c[0] for c in tool_launch.CASES])
def test_micro_launch_matches_plain_version_on_the_card(case):
    _need_card()
    _, progs, views, tz, lanes, planes = next(
        c for c in tool_launch.CASES if c[0] == case)
    src = tool_launch.make_src(tz, lanes, planes, 'cuda', seed=11)
    _close(micro.micro_launch(src, progs, views),
           micro.micro_launch_reference(src, progs, views))


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(tool_engine.CASES))
def test_micro_engine_matches_plain_version_on_the_card(name):
    _need_card()
    _, args, kw = tool_engine.make_case(name, 'cuda', seed=12)
    _close(micro.micro_engine(*args, **kw),
           micro.micro_engine_reference(*args, **kw))


@pytest.mark.cuda
def test_micro_launch_in_a_cuda_graph_counts_at_capture():
    """The wrapper launches on the capture stream: a replay gives the
    eager result, and the counter counts the capture, not the replays."""
    _need_card()
    src = tool_launch.make_src(8, 128, 2, 'cuda', seed=13)
    want = micro.micro_launch_reference(src, 100, 3)
    holder = []
    micro.micro_launch.launches = 0
    graph = common.capture(
        lambda: holder.append(micro.micro_launch(src, 100, 3)))
    assert micro.micro_launch.launches == 2   # warm-up and capture
    holder[-1].zero_()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert micro.micro_launch.launches == 2
    _close(holder[-1], want)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ps.MODES)
def test_pair_stub_writes_exact_zeros_on_the_card(mode):
    _need_card()
    app = prof_dma.setup(0.04, 'cuda')
    s = app.solver
    rng = np.random.default_rng(14)
    for st in s.states.values():
        st['u'] = torch.as_tensor(rng.normal(size=st['x'].shape[0]),
                                  dtype=st['x'].dtype, device='cuda')
    a_eval = s.acceleration_evals[0]
    for plan, args in prof_dma.pair_calls(a_eval, s.states):
        pre = {p: torch.full_like(v, 7.0) for p, v in args[3].items()}
        args = args[:3] + (pre,) + args[4:]
        got = ps.pair_stub(*args, mode=mode)
        torch.cuda.synchronize()
        assert set(got) == set(plan.outputs)
        assert all(bool((v == 0).all()) for v in got.values())
