"""The periodic domain of the port (``base/domain.py``) and the periodic
cell grid (``base/cell_grid.py``, ``ops/bin_cells.py``), float64 on the
CPU, seeded with numpy.

- ``wrap_positions`` and ``minimum_image`` equal ``pysph_tpu``'s
  exactly, displacements of exactly half a box (round half to even)
  among them.
- The exact pair lists on a periodic grid equal an all-pairs
  minimum-image oracle, on grids of 1, 2 and 3 or more cells on a
  periodic axis (the stencil shrinks below 3), periodic on every axis
  or on some, in 2D and 3D; with a capacity they are the same list.
- The periodic walk's row ranges (``ops/cell_walk.py::periodic_spans``,
  the mirror of ``csrc/cell_walk.cuh::walk_rows_periodic``), the split
  x ranges at the edges included, hand the pairs in support in the
  exact list's order.
- The reuse test takes the minimum image: particles that wrapped across
  the box keep the binning, whose lists stay the oracle's; a move past
  the margin rebuilds; an invalidated handle rebuilds.
"""

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomainManager
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.ops import cell_walk
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

F64 = torch.float64
RS = 3.0
H = 0.1
#: cells of a periodic axis: its length over the cell 1.1 RS H
CELL = 1.1 * RS * H
#: {case: (dim, (L / CELL by axis, None: not periodic), particles)}
CASES = {
    '2d 5x4 periodic': (2, (5.3, 4.2), 90),
    '2d 2x1 periodic': (2, (2.4, 1.3), 40),
    '2d 3x2 periodic': (2, (3.1, 2.2), 60),
    '2d 4 periodic x, open y': (2, (4.4, None), 60),
    '2d open x, 2 periodic y': (2, (None, 2.7), 50),
    '3d 3x2x1 periodic': (3, (3.3, 2.2, 1.4), 80),
    '3d 4 periodic x, open y z': (3, (4.5, None, None), 90),
}


def _domain(lengths, mins=(-0.3, 0.2, 0.1)):
    kw = {}
    for d, (c, L) in enumerate(zip('xyz', lengths)):
        if L is not None:
            lo = mins[d]
            kw.update({c + 'min': lo, c + 'max': lo + L * CELL,
                       'periodic_in_' + c: True})
    return kw


def _state(dim, lengths, n, seed):
    """Particles in the box (a tenth of a cell past its ends on a few),
    and on the open axes in a band of about three cells; h of 0.8-1
    H."""
    rng = np.random.default_rng(seed)
    dom = _domain(lengths)
    props = {}
    for d, c in enumerate('xyz'):
        if d >= dim:
            props[c] = np.zeros(n)
        elif lengths[d] is None:
            props[c] = rng.uniform(0.0, 3.0 * CELL, n)
        else:
            lo, hi = dom[c + 'min'], dom[c + 'max']
            props[c] = rng.uniform(lo - 0.1 * CELL, hi + 0.1 * CELL, n)
    props['h'] = H * rng.uniform(0.8, 1.0, n)
    for p in ('m', 'rho', 'u', 'v', 'w', 'p'):
        props[p] = rng.normal(size=n)
    return ParticleArray.from_numpy('fluid', props), dom


def _oracle(state, domain):
    """Every (i, j) with the minimum-image r2 < (RS max(hi, hj))^2."""
    d2 = 0.0
    for c, L, per in zip('xyz', domain.lengths, domain.periodic):
        x = state[c].numpy()
        d = x[:, None] - x[None, :]
        if per:
            d = d - L * np.round(d / L)
        d2 = d2 + d * d
    h = state['h'].numpy()
    sup = RS * np.maximum(h[:, None], h[None, :])
    i, j = np.nonzero(d2 < sup * sup)
    return set(zip(i.tolist(), j.tolist()))


def _setup(case, seed=3):
    dim, lengths, n = CASES[case]
    pa, kw = _state(dim, lengths, n, seed)
    domain = DomainManager(**kw)
    grid = CellGrid.from_particles([pa], dim=dim, radius_scale=RS,
                                   domain=domain)
    state = {k: torch.as_tensor(v, dtype=F64)
             for k, v in pa.to_numpy()[0].items()}
    return grid, domain, state, lengths


def _pairs(grid, state, cells):
    i, j = grid.neighbor_pairs(state, cells, state, cells,
                               (0, state['x'].shape[0]))
    return i, j


def test_wrap_positions_match_jax():
    rng = np.random.default_rng(5)
    kw = dict(xmin=-0.3, xmax=0.9, ymin=0.2, ymax=1.45, periodic_in_x=True,
              periodic_in_y=True)
    x, y, z = (rng.uniform(-2.0, 3.0, 200) for _ in range(3))
    x[:4] = (-0.3, 0.9, 2.1, -1.5)     # on the box's ends and a box away
    want = JaxDomainManager(**kw).wrap_positions(x, y, z)
    got = DomainManager(**kw).wrap_positions(
        *(torch.as_tensor(c, dtype=F64) for c in (x, y, z)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_minimum_image_matches_jax_half_to_even():
    rng = np.random.default_rng(6)
    kw = dict(xmin=0.0, xmax=1.0, ymin=-0.5, ymax=1.5, zmin=0.0, zmax=2.0,
              periodic_in_x=True, periodic_in_y=True, periodic_in_z=False)
    d = [rng.uniform(-2.0, 2.0, 64) for _ in range(3)]
    # exactly half a box either way, and one and a half: rounds to even
    d[0][:4] = (0.5, -0.5, 1.5, -1.5)
    d[1][:4] = (1.0, -1.0, 3.0, -3.0)
    want = JaxDomainManager(**kw).minimum_image(*d)
    got = DomainManager(**kw).minimum_image(
        *(torch.as_tensor(c, dtype=F64) for c in d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:4].tolist() == [0.5, -0.5, -0.5, 0.5]


@pytest.mark.parametrize('case', sorted(CASES))
def test_periodic_grid_geometry(case):
    """Counts ``max(floor(L / cell), 1)`` on a periodic axis (the
    stencil -1..0 on two cells, 0 on one), cell ids modulo them."""
    grid, domain, state, lengths = _setup(case)
    for d, L in enumerate(lengths):
        if L is not None:
            assert grid.dims[d] == max(int(np.floor(L)), 1)
            want = {1: (0,), 2: (-1, 0)}.get(grid.dims[d], (-1, 0, 1))
            assert grid.axis_offsets(d) == want
    assert len(grid.stencil_offsets()) == grid.offsets('cpu').shape[0]
    handle = grid.handle_for(None, {'fluid': state})
    bc.bin_cells(grid, {'fluid': state}, handle, force=True)
    cid = handle.lists['fluid'].cell.long()
    assert int(cid.min()) >= 0 and int(cid.max()) < grid.ncells
    for d, c in enumerate('xyz'):
        if grid.periodic[d]:
            w = domain.lengths[d] / grid.dims[d]
            ix = np.floor((state[c].numpy() - domain.mins[d]) / w)
            stride = int(np.prod(grid.dims[:d]))
            got = (cid.numpy() // stride) % grid.dims[d]
            np.testing.assert_array_equal(got, ix.astype(int) %
                                          grid.dims[d])


@pytest.mark.parametrize('case', sorted(CASES))
def test_periodic_lists_are_the_minimum_image_oracle(case):
    grid, domain, state, _ = _setup(case)
    cells = grid.bin_all({'fluid': state})['fluid']
    i, j = _pairs(grid, state, cells)
    got = list(zip(i.tolist(), j.tolist()))
    assert len(got) == len(set(got))
    assert set(got) == _oracle(state, domain)
    # at a capacity that holds them: the same list, in its order
    cap = grid.pair_capacity('fluid', 'fluid', 'cpu')
    cap.candidates, cap.pairs = 10 ** 5, len(got) + 7
    ci, cj, cw = grid.neighbor_pairs(state, cells, state, cells,
                                     (0, state['x'].shape[0]), cap)
    assert ci[:len(got)].tolist() == i.tolist()
    assert cj[:len(got)].tolist() == j.tolist()
    assert int(cap.need[1]) == len(got)


@pytest.mark.parametrize('case', sorted(CASES))
def test_periodic_walk_is_the_exact_list_in_order(case):
    """Each dest's candidates from the walk's two ranges a row, in
    support, are its exact list, in the same order; the second range is
    non-empty only at the x edges of a periodic x axis."""
    grid, domain, state, _ = _setup(case)
    cells = grid.bin_all({'fluid': state})['fluid']
    i, j = _pairs(grid, state, cells)
    spans = cell_walk.periodic_spans(grid, cells, cells)
    order = cells.order.long()
    oracle = _oracle(state, domain)
    nx = grid.dims[0]
    splits = 0
    for pos in range(state['x'].shape[0]):
        a = int(order[pos])
        walked = []
        for row in spans[pos]:
            for k0, k1 in row.tolist():
                walked.extend(int(order[k]) for k in range(k0, k1))
        assert len(walked) == len(set(walked))
        listed = j[i == a].tolist()
        assert [b for b in walked if (a, b) in oracle] == listed
        cx = int(cells.cell[a]) % nx
        split = bool((spans[pos, :, 1, 1] > spans[pos, :, 1, 0]).any())
        if split:
            assert grid.periodic[0] and nx >= 2 and (
                cx == 0 or (cx == nx - 1 and nx >= 3))
            splits += 1
    assert bool(splits) == (grid.periodic[0] and nx >= 2)


@pytest.mark.parametrize('case', ['2d 5x4 periodic', '3d 3x2x1 periodic',
                                  '2d 4 periodic x, open y'])
def test_reuse_test_takes_the_minimum_image(case):
    grid, domain, state, _ = _setup(case, seed=9)
    states = {'fluid': state}
    handle = grid.handle_for(None, states)
    assert bool(bc.bin_cells(grid, states, handle))    # width 0: rebuilds
    margin = grid.half_margin() * float(state['h'].max())
    # every particle moves a fifth of the margin, and those near a
    # periodic end wrap across the box
    rng = np.random.default_rng(10)
    moved = dict(state)
    for d, c in enumerate('xyz'[:grid.dim]):
        step = torch.as_tensor(rng.uniform(-0.2, 0.2, state[c].shape[0]),
                               dtype=F64) * margin / np.sqrt(grid.dim)
        moved[c] = state[c] + step
    moved = domain.wrap_state(moved)
    jumped = (moved['x'] - state['x']).abs() > 0.5 * domain.lengths[0] \
        if grid.periodic[0] else torch.zeros(1, dtype=torch.bool)
    states = {'fluid': moved}
    assert not bool(bc.bin_cells(grid, states, handle))
    if grid.periodic[0]:
        assert bool(jumped.any())
    i, j = _pairs(grid, moved, handle.lists['fluid'])
    assert set(zip(i.tolist(), j.tolist())) == _oracle(moved, domain)
    # one particle past the margin: rebuilt
    far = dict(moved)
    far['y'] = moved['y'].clone()
    far['y'][0] += 1.2 * margin
    assert bool(bc.bin_cells(grid, {'fluid': far}, handle))
    handle.invalidate()
    assert bool(bc.bin_cells(grid, {'fluid': far}, handle))
