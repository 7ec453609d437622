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
