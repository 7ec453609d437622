"""The sorted cell list's pair set against the brute-force oracle of
pysph_tpu.base.nnps, exactly, on seeded random particles."""

import numpy as np
import pytest
import torch

from pysph_tpu.base.nnps import brute_force_neighbors
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

CPU64 = Config(device='cpu', dtype=torch.float64)


def _array(name, rng, n, dim, hlo, hhi):
    xyz = np.zeros((3, n))
    xyz[:dim] = rng.uniform(0.0, 1.0, (dim, n))
    return ParticleArray(name=name, x=xyz[0], y=xyz[1], z=xyz[2],
                         h=rng.uniform(hlo, hhi, n))


def _pairs_by_dest(i, j, n):
    order = np.lexsort((j, i))
    i, j = i[order], j[order]
    starts = np.searchsorted(i, np.arange(n + 1))
    return [j[starts[k]:starts[k + 1]] for k in range(n)]


@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('chunk', [None, 37])
@pytest.mark.parametrize('escape', [False, True])
def test_cell_list_pairs_equal_brute_force(dim, chunk, escape):
    rng = np.random.default_rng(11 + dim)
    n = 400 if dim == 3 else 300
    hs = 1.0 if dim == 2 else 2.0
    dest = _array('dest', rng, n, dim, 0.02 * hs, 0.06 * hs)
    src = _array('src', rng, n + 50, dim, 0.01 * hs, 0.08 * hs)
    grid = CellGrid.from_particles([dest, src], dim=dim, radius_scale=2.0)
    states = {pa.name: pa.to_device(CPU64) for pa in (dest, src)}
    if escape:
        # particles that left the grid's extent are clamped into its
        # edge cells and must still find every neighbour
        for s in states.values():
            s['x'] = s['x'] * 1.7 - 0.3
    cells = grid.bin_all(states)
    rows = [(0, n)] if chunk is None else \
        [(a, min(n, a + chunk)) for a in range(0, n, chunk)]
    pairs = [grid.neighbor_pairs(states['dest'], cells['dest'],
                                 states['src'], cells['src'], r)
             for r in rows]
    i = torch.cat([p[0] for p in pairs]).numpy()
    j = torch.cat([p[1] for p in pairs]).numpy()
    got = _pairs_by_dest(i, j, n)

    def oracle_state(s):
        d = {k: s[k].numpy() for k in ('x', 'y', 'z', 'h')}
        d['n_act'] = s['x'].shape[0]
        return d
    want = brute_force_neighbors(oracle_state(states['dest']),
                                 oracle_state(states['src']), 2.0)
    assert sum(len(w) for w in want) > 5 * n      # not a sparse toy
    for k in range(n):
        np.testing.assert_array_equal(got[k], want[k])


def test_cell_list_is_sorted_and_complete():
    rng = np.random.default_rng(5)
    pa = _array('a', rng, 500, 3, 0.03, 0.05)
    grid = CellGrid.from_particles([pa], dim=3, radius_scale=2.0)
    cl = grid.bin_all({'a': pa.to_device(CPU64)})['a']
    cell, order = cl.cell.long(), cl.order.long()
    assert torch.equal(torch.sort(order).values, torch.arange(500))
    assert bool((cell[order][1:] >= cell[order][:-1]).all())
    for c in torch.unique(cell).tolist():
        members = order[cl.start[c]:cl.end[c]]
        assert bool((cell[members] == c).all())
    assert int((cl.end - cl.start).sum()) == 500
