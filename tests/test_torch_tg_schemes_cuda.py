"""The periodic branches of ``wcsph_pair``, ``dense_pair`` and
``gtvf_pair`` against their plain torch version, on the card: the
Taylor-Green vortex's ``--scheme wcsph`` (both kernel engines) and
``--scheme gtvf`` on the box periodic in x and y, ``QuinticSpline``,
with ``LaminarViscosity`` (``VISC``) and ``MomentumEquationViscosity``
(``MVISC``).

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tg_schemes_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import tvf_check
from pysph_tpu_torch.tools_dev.time_walks import make_app
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

RUNS = [('wcsph', 'kernel', wp.wcsph_pair, wp.pack_sources,
         wp.pack_sources_reference),
        ('wcsph', 'dense', dp.dense_pair, wp.pack_sources,
         wp.pack_sources_reference),
        ('gtvf', 'kernel', gp.gtvf_pair, gp.pack_sources,
         gp.pack_sources_reference)]
RUN_IDS = ['%s-%s' % r[:2] for r in RUNS]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('nx', [20, 50])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('run', RUNS, ids=RUN_IDS)
def test_periodic_kernel_matches_plain_version_on_the_card(run, dtype, tol,
                                                           nx, edges):
    """Every pair call of one eval of each evaluator (5 x 5 cells at
    nx=20, 17 x 17 at nx=50), with ``edges`` a tenth of the particles
    on the box's edges and corners (the wrapped rows and the split x
    ranges walked by many lanes): one walk and one pack launched a call,
    the pack equal to its plain version, every output within ``tol`` of
    max|ref|, and the viscosity term in the path's calls."""
    _need_card()
    scheme, engine, op, pack, pack_reference = run
    calls, _, moved = tvf_check.calls(nx, dtype, edges, scheme, engine)
    assert bool(moved) == edges
    visc = 0
    for _, _, plan, args in calls:
        assert args[5].is_periodic and plan.op is op
        srcs = args[4]
        for got, want in zip(pack(srcs), pack_reference(srcs)):
            assert got.shape == want.shape and torch.equal(got, want)
        before = op.launches, cell_pack.pack.launches
        op(*args)
        assert (op.launches, cell_pack.pack.launches) == (
            before[0] + 1, before[1] + 1)
        for ps in plan.sources:
            visc |= ps.terms & (wp.VISC if scheme == 'wcsph' else gp.MVISC)
    assert visc
    _, worst = tvf_check.compare(calls, tol)
    assert worst <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('run', RUNS, ids=RUN_IDS)
def test_engines_agree_from_a_perturbed_start(run):
    """The path at nx=20 from ``--perturb 0.1`` in float64 for 10 steps
    (in chunks, particles wrapping) on the kernel engine against the
    torch engine: every prop within 1e-9 of its max."""
    _need_card()
    scheme, engine = run[:2]
    states = {}
    for e in (engine, 'torch'):
        app = make_app(None, torch.float64, steps=10, engine=e,
                       cls=TaylorGreen,
                       extra=('--nx', '20', '--perturb', '0.1', '--scheme',
                              scheme))
        app.solve()
        assert app.solver.count == 10
        choices = {c for a in app.solver.acceleration_evals
                   for c in a.engine_choices.values()}
        assert choices == {e}
        states[e] = app.solver.states['fluid']
    for p, want in states['torch'].items():
        if not want.is_floating_point():
            continue
        scale = max(float(want.abs().max()), 1e-300)
        err = float((states[engine][p] - want).abs().max()) / scale
        assert err <= 1e-9, (p, err)
