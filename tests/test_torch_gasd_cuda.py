"""``GasDScheme``'s pair phases on the hand-written ``gasd_pair`` against
their plain torch versions, on the card: both phase sets (the grad-h
density, ``MPMAccelerations``) of one evaluation of the shock tube (1D,
h jumping by the density ratio at the diaphragm) and of the Sedov blast
(2D), from a jittered start, in float64 and float32, with each dest's
pairs in support equal to the plain version's; GHI (``dwdh``) against
``Gaussian.gradient_h`` in 1D and 2D; every other kernel with a shape
function (``gasd_check.KINDS``); a periodic box; a CUDA tensor with a
kernel that has none, or another dtype, refused, not run on the plain
version; and a few steps of each run on the card with every pair phase on
the kernel.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gasd_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import Gaussian, WendlandQuinticC2_1D
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.scheme import GasDScheme
from pysph_tpu_torch.tools_dev import gasd_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: the runs at a small size
RUNS = {'shocktube': 80, 'sedov': 31}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('run', list(RUNS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_gasd_pair_matches_plain_version_on_the_card(dtype, run):
    """Both sets of one evaluation: one launch and one pack a call,
    every output within the tolerance of max|ref|, the pairs and each
    dest's count exactly the plain version's."""
    _need_card()
    calls, _, _ = gasd_check.calls(run, RUNS[run], dtype)
    assert [c[2].op for c in calls] == [gd.gasd_pair] * 2
    assert [c[2].sources[0].terms for c in calls] == [gd.SDEN, gd.MPM]
    gd.gasd_pair.launches = cell_pack.pack.launches = 0
    found = gasd_check.check(calls, '%s %s' % (run, dtype), TOL[dtype])
    assert gd.gasd_pair.launches == cell_pack.pack.launches == 2
    assert found['pairs'] > 0 and found['nnbr_differ'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [1, 2])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_ghi_matches_gradient_h(dim, dtype):
    _need_card()
    assert gasd_check.gradient_h(dim, dtype) <= (
        1e-13 if dtype == torch.float64 else 1e-5)


def _periodic_calls(dtype, kernel):
    """The two sets' calls on a jittered 12 x 12 lattice in a box
    periodic in x and y, h varying by 20%."""
    rng = np.random.default_rng(11)
    n, dx = 12, 1.0 / 12
    g = (np.arange(n) + 0.5) * dx
    x, y = (c.ravel() for c in np.meshgrid(g, g))
    k = x.size
    pa = get_particle_array_gasd(
        name='fluid', x=x + 0.1 * dx * rng.uniform(-1, 1, k),
        y=y + 0.1 * dx * rng.uniform(-1, 1, k),
        u=rng.normal(size=k), v=rng.normal(size=k), m=dx * dx,
        rho=1.0 + 0.1 * rng.random(k), p=1.0 + rng.random(k),
        cs=1.0 + rng.random(k), e=1.0 + rng.random(k),
        omega=1.0 + 0.1 * rng.random(k), alpha1=rng.random(k),
        alpha2=rng.random(k), h=1.2 * dx * (1.0 + 0.2 * rng.random(k)))
    scheme = GasDScheme(['fluid'], [], dim=2, gamma=1.4, kernel_factor=1.2)
    config = Config(device='cuda', dtype=dtype)
    domain = DomainManager(xmin=0, xmax=1, ymin=0, ymax=1,
                           periodic_in_x=True, periodic_in_y=True)
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0,
                                   domain=domain)
    a_eval = AccelerationEval([pa], scheme.get_equations(), kernel, config,
                              grid)
    states = {'fluid': pa.to_device(config)}
    cells = grid.bin_all(states)
    st = states['fluid']
    out = []
    for group in a_eval.leaf_groups():
        plan = a_eval._plans.get((id(group), 'fluid'))
        if plan is not None:
            pre = {p: torch.zeros_like(st[p]) for p in plan.outputs}
            out.append((0, 'fluid', plan, plan.args(st, states, cells, grid,
                                                    None, pre)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_gasd_pair_on_a_periodic_box(dtype):
    _need_card()
    calls = _periodic_calls(dtype, Gaussian(dim=2))
    assert len(calls) == 2 and calls[0][3][5].is_periodic
    gasd_check.check(calls, 'periodic %s' % dtype, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_every_kind_matches_plain_version_on_the_card(dtype):
    """Both sets under each other kernel (each later kind a library of
    its own, built at its first launch)."""
    _need_card()
    found = gasd_check.kinds(dtype, TOL[dtype])
    assert {f['kind'] for f in found.values()} == {0, 1, 3, 4, 5, 6}
    assert all(f['pairs'] > 0 for f in found.values())


@pytest.mark.cuda
def test_another_kernel_on_the_card_raises():
    """A CUDA call with a kernel that has no shape function in the pair
    kernels (the 1D ones) raises, and does not run the plain version."""
    _need_card()
    (_, _, plan, args), _ = _periodic_calls(torch.float64, Gaussian(dim=2))
    args = args[:6] + (WendlandQuinticC2_1D(dim=1),)
    with pytest.raises(ValueError, match='no shape function'):
        gd.gasd_pair(*args)
    # a dtype the kernel lacks
    state = {k: v.half() if v.is_floating_point() else v
             for k, v in args[0].items()}
    with pytest.raises(ValueError, match='dtype'):
        gd.gasd_pair(state, *args[1:6], Gaussian(dim=2))


def _solve(run, k, steps, extra=()):
    app = gasd_check.app(run, RUNS[run], torch.float32, steps=steps,
                         extra=extra)
    s = app.solver
    s.chunk_steps = k
    gd.gasd_pair.launches = gd.gasd_sweep.launches = 0
    a_eval, = s.acceleration_evals
    a_eval.sweeps.clear()
    a_eval.binnings = a_eval.converged_reads = 0
    app.solve()
    return s, a_eval


@pytest.mark.cuda
@pytest.mark.parametrize('run', list(RUNS))
def test_steps_on_the_card_run_on_the_kernel(run):
    """Three steps of each run in float32 per step: every pair phase on
    the kernel (a gated sweep launch a sweep, one momentum launch an
    evaluation), a binning test a sweep, the count of unconverged
    particles read only after a sweep that can stop the loop, a finite
    state; and in one chunk, replayed from a CUDA graph, the same bits
    with no such read after the initial evaluation's."""
    _need_card()
    s, a_eval = _solve(run, 1, 3)
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    sweeps = a_eval.sweeps
    assert s.count == 3 and len(sweeps) == 4
    assert gd.gasd_sweep.launches == sum(sweeps)
    assert gd.gasd_pair.launches == len(sweeps)
    assert a_eval.binnings == sum(sweeps)
    assert 0 < a_eval.converged_reads <= sum(sweeps)
    for v in s.states['fluid'].values():
        if v.is_floating_point():
            assert bool(torch.isfinite(v).all())
    c, c_eval = _solve(run, 10, 3)
    assert c.replays == 1 and c.redos == 0
    assert c_eval.sweeps == sweeps
    assert c_eval.converged_reads <= sweeps[0]
    for p, v in s.states['fluid'].items():
        assert torch.equal(c.states['fluid'][p], v), p


@pytest.mark.cuda
@pytest.mark.parametrize('scheme', ['mpm', 'gsph'])
def test_gas_chunks_equal_the_per_step_loop_on_the_card(scheme):
    """20 steps of ``sedov`` (the CFL dt) under each adaptive-h scheme in
    chunks of 10 replayed from CUDA graphs equal the per-step loop bit
    for bit: ``gsph``'s re-binnings and ``mpm``'s gated sweeps read
    nothing inside a chunk."""
    _need_card()
    extra = gasd_check.FULL_WIDTH + ('--adaptive-h', scheme)
    c, _ = _solve('sedov', 10, 20, extra)
    s, _ = _solve('sedov', 1, 20, extra)
    assert c.replays >= 1 and c.count == s.count == 20
    assert (c.t, c.dt) == (s.t, s.dt)
    for p, v in s.states['fluid'].items():
        assert torch.equal(c.states['fluid'][p], v), (scheme, p)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('run,cap', [('sedov', None), ('shocktube', None),
                                     ('sedov', 1)])
def test_gated_sweep_matches_plain_version_on_the_card(run, cap, dtype):
    """``gasd_sweep`` against its plain version on every sweep of an
    iteration from a state whose h moved by up to 5% (``gasd_check.
    check_sweep``): the outputs within the tolerance, no converged flag
    apart in float64, the list as ``neighbours_reference`` (with one
    entry too: every warp walks), the momentum launch on it bit for bit
    the walk."""
    _need_card()
    s = gasd_check.sweep_start(run, 41 if run == 'sedov' else 80, dtype)
    found = gasd_check.check_sweep(s, run, TOL[dtype], capacity=cap)
    assert found['sweeps'] > 1 and found['pairs'] > 0
    assert found['linked'] == 1 and found['walked'] == 1
    if dtype == torch.float64:
        assert found['flags_differ'] == 0
    if cap == 1:
        assert found['overflowed'] > 0
