"""The binning kernels against their plain torch version, and the reuse
in captured chunks, on the card.

Skips without an NVIDIA card (a CUDA kernel has no CPU mode; on the CPU
``bin_cells`` takes its plain version, ``tests/test_torch_binning_reuse.py``).
This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_bin_cells_cuda.py
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.tools_dev import bin_check, time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


def _states(dim, dtype, seed):
    """Three arrays (one empty) uniform in the unit box, a tenth of the
    first pushed beyond the grid (clamped into its edge cells)."""
    rng = np.random.default_rng(seed)
    arrays = []
    for name, n in (('fluid', 4000), ('wall', 1500), ('empty', 0)):
        xyz = np.zeros((3, n))
        xyz[:dim] = rng.uniform(0.0, 1.0, (dim, n))
        arrays.append(ParticleArray(name=name, x=xyz[0], y=xyz[1], z=xyz[2],
                                    h=rng.uniform(0.01, 0.02, n)))
    grid = CellGrid.from_particles(arrays, dim=dim, radius_scale=2.0)
    config = Config(device='cuda', dtype=dtype)
    states = {pa.name: pa.to_device(config) for pa in arrays}
    states['fluid']['x'][:400] += 2.0
    return grid, states


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_bin_cells_matches_plain_version_exactly(dim, dtype):
    """``tools_dev/bin_check.py::check``: forced, kept, stale but
    inactive (flag 0: the handle bitwise unchanged), rebuilt and kept
    again, every tensor of the handle equal to the plain version's; one
    launch a call."""
    _need_card()
    grid, states = _states(dim, dtype, 5 + dim)
    before = bc.bin_cells.launches
    assert bin_check.check(grid, states, seed=dim) == len(bin_check.FLAGS)
    assert bc.bin_cells.launches - before == len(bin_check.FLAGS)


@pytest.mark.cuda
def test_captured_chunks_with_reuse_equal_the_eager_loop():
    """The moving dam break (dx=0.04, float64, fluid at 3 m/s): chunks
    of 10 replayed from CUDA graphs, each step's reuse test deciding on
    the card, against the eager per-step loop: the same binnings ran, and
    every prop, t, dt and the count are equal bit for bit."""
    _need_card()
    held = time_chunks.gate('dam_break_3d dx=0.04 moving')
    assert held['rebuilds'] >= 5 and held['replays'] == held['chunks']
    assert held['max_scaled_err'] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['2d xy', '2d x', '3d xyz'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_periodic_bin_cells_matches_plain_version_exactly(case, dtype):
    """The same on a periodic grid (``base/domain.py``): cells of L /
    dims from the box's corner, ids modulo the counts, the reuse test's
    displacement by minimum image (``bin_check``'s moved particles are
    wrapped into the box, so some jump by its length), a tenth of the
    particles on the box's ends; periodic in x and y, in x only, and in
    every axis of 3D."""
    _need_card()
    dim = int(case[0])
    axes = case.split()[1]
    rng = np.random.default_rng(17)
    n = 3000
    xyz = np.zeros((3, n))
    xyz[:dim] = rng.uniform(0.0, 1.0, (dim, n))
    xyz[:dim, :n // 10] = rng.choice([0.0, 1.0, 1.0 - 1e-7],
                                     (dim, n // 10))
    kw = {}
    for c in axes:
        kw.update({c + 'min': 0.0, c + 'max': 1.0, 'periodic_in_' + c: True})
    domain = DomainManager(**kw)
    pa = ParticleArray(name='fluid', x=xyz[0], y=xyz[1], z=xyz[2],
                       h=rng.uniform(0.01, 0.02, n))
    grid = CellGrid.from_particles([pa], dim=dim, radius_scale=3.0,
                                   domain=domain)
    assert grid.periodic[:dim] == tuple(c in axes for c in 'xyz'[:dim])
    states = {'fluid': pa.to_device(Config(device='cuda', dtype=dtype))}
    assert bin_check.check(grid, states, seed=dim) == len(bin_check.FLAGS)


def _crowded(spread, dims, dtype, n=60000, seed=8):
    rng = np.random.default_rng(seed)
    pa = ParticleArray(name='fluid', x=rng.uniform(0.0, spread, n),
                       y=rng.uniform(0.0, spread, n), z=np.zeros(n),
                       h=np.ones(n))
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0)
    if dims is not None:
        grid._set_dims(dims)
    return grid, {'fluid': pa.to_device(Config(device='cuda', dtype=dtype))}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('spread,dims', [(1e-3, None), (400.0, (4, 4, 1)),
                                         (40.0, None)])
def test_a_crowded_state_sorts_as_the_stable_sort(spread, dims, dtype):
    """Every particle in one cell, the clamped edges of a grid far too
    small, and cells past a warp's sort (longer than 256): ``order`` is
    ``torch.sort(cid, stable=True)``'s and the plain version's, at
    once."""
    _need_card()
    grid, states = _crowded(spread, dims, dtype)
    handle = grid.handle_for(None, states)
    bc.bin_cells(grid, states, handle, force=True)
    cells = handle.lists['fluid']
    cid = cells.cell.long()
    assert int(torch.bincount(cid).max()) > 256
    assert torch.equal(cells.order.long(),
                       torch.sort(cid, stable=True).indices)
    assert bin_check.check(grid, states) == len(bin_check.FLAGS)


@pytest.mark.cuda
def test_a_nan_state_is_not_binned():
    """A NaN x: the binning keeps the handle as it was, its flag 0, the
    grid's ``nonfinite`` set, which ``check_finite`` raises; the plain
    version does the same."""
    _need_card()
    grid, states = _crowded(40.0, None, torch.float32, n=5000)
    handle = grid.handle_for(None, states)
    bc.bin_cells(grid, states, handle, force=True)
    kept = [t.clone() for t in handle.lists['fluid']]
    st = dict(states['fluid'])
    st['x'] = st['x'].clone()
    st['x'][17] = float('nan')
    for op in (bc.bin_cells, bc.bin_cells_reference):
        assert not bool(op(grid, {'fluid': st}, handle, force=True))
        assert all(torch.equal(a, b) for a, b in
                   zip(kept, handle.lists['fluid']))
        with pytest.raises(FloatingPointError, match='not finite'):
            grid.check_finite()
