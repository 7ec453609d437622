"""The torch pair engine at capacities (float64, on the CPU): its lists
against the exact ones, its overflow flag and counts, the results of a
pair phase at any capacity that holds the pairs, and no read of the
device while it builds them.

Seeded random particles (numpy ``default_rng``) in 2D and 3D, chunks of
dest rows as the engine takes them.
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid, PairCapacity
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.base.utils import get_particle_array_wcsph
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
from pysph_tpu_torch.sph.basic_equations import (
    ContinuityEquation, XSPHCorrection)
from pysph_tpu_torch.sph.wc.basic import MomentumEquation
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

CPU64 = Config(device='cpu', dtype=torch.float64)


def _case(dim, seed=3):
    rng = np.random.default_rng(seed + dim)
    n = {2: 300, 3: 400}[dim]
    arrays = []
    for name, m in (('dest', n), ('src', n + 40)):
        xyz = np.zeros((3, m))
        xyz[:dim] = rng.uniform(0.0, 1.0, (dim, m))
        arrays.append(get_particle_array_wcsph(
            name=name, x=xyz[0], y=xyz[1], z=xyz[2],
            h=rng.uniform(0.03, 0.06, m) * (1.0 if dim == 2 else 2.0),
            m=np.full(m, 1e-3), rho=1.0 + 0.01 * rng.normal(size=m),
            u=rng.normal(size=m), v=rng.normal(size=m),
            cs=np.full(m, 10.0), p=rng.normal(size=m)))
    grid = CellGrid.from_particles(arrays, dim=dim, radius_scale=2.0)
    states = {pa.name: pa.to_device(CPU64) for pa in arrays}
    return grid, states, grid.bin_all(states)


def _exact_counts(grid, states, cells, rows):
    """(candidates, pairs) of the exact list of ``rows``."""
    cap = PairCapacity('cpu')
    grid.neighbor_pairs(states['dest'], cells['dest'], states['src'],
                        cells['src'], rows, cap)
    i, _ = grid.neighbor_pairs(states['dest'], cells['dest'], states['src'],
                               cells['src'], rows)
    return int(cap.need[0]), i.numel()


@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('extra', [0, 1, 57])
def test_capped_list_is_the_exact_list(dim, extra):
    """At capacities ``extra`` above the counts: the first pairs are the
    exact list's, in its order; the rest are (a, 0) writing row n."""
    grid, states, cells = _case(dim)
    n = states['dest']['x'].shape[0]
    for rows in ((0, 150), (150, n)):
        cand, pairs = _exact_counts(grid, states, cells, rows)
        assert pairs > 5 * (rows[1] - rows[0])
        cap = PairCapacity('cpu')
        cap.candidates, cap.pairs = cand + extra, pairs + extra
        grid.pair_overflow = torch.zeros((), dtype=torch.bool)
        i, j, w = grid.neighbor_pairs(states['dest'], cells['dest'],
                                      states['src'], cells['src'], rows,
                                      cap)
        ei, ej = grid.neighbor_pairs(states['dest'], cells['dest'],
                                     states['src'], cells['src'], rows)
        assert i.shape == (pairs + extra,)
        assert torch.equal(i[:pairs], ei) and torch.equal(j[:pairs], ej)
        assert torch.equal(w[:pairs], ei)
        assert bool((i[pairs:] == rows[0]).all())
        assert bool((j[pairs:] == 0).all()) and bool((w[pairs:] == n).all())
        assert cap.need.tolist() == [cand, pairs]
        assert not grid.pairs_overflowed()


@pytest.mark.parametrize('short', ['candidates', 'pairs'])
def test_overflow_flag_and_counts(short):
    grid, states, cells = _case(3)
    rows = (0, 200)
    cand, pairs = _exact_counts(grid, states, cells, rows)
    grid.pair_caps['dest', 'src'] = cap = PairCapacity('cpu')
    cap.candidates, cap.pairs = cand, pairs
    setattr(cap, short, getattr(cap, short) - 1)
    grid.watch_pairs()
    grid.neighbor_pairs(states['dest'], cells['dest'], states['src'],
                        cells['src'], rows, cap)
    assert grid.pairs_overflowed() and grid.pair_overflow is None
    if short == 'candidates':
        # counted within the capacity: at most the pairs of the list
        assert cap.need[0] == cand and cap.need[1] <= pairs
    else:
        assert cap.need.tolist() == [cand, pairs]
    grown = grid.grow_pairs()
    want = int(np.ceil(1.25 * (cand if short == 'candidates' else pairs)))
    assert grown['dest', 'src'][0 if short == 'candidates' else 1] == want
    assert grid.pair_key() == ((('dest', 'src'), cap.candidates, cap.pairs),)


@pytest.mark.parametrize('dim', [2, 3])
def test_pair_phase_at_any_capacity_gives_the_exact_bits(dim):
    """Continuity, momentum and XSPH of dest <- src in chunks of 97 rows:
    the same bits on exact lists and at two capacities that hold them."""
    grid, states, cells = _case(dim)
    n = states['dest']['x'].shape[0]
    eqs = [ContinuityEquation('dest', ['src']),
           MomentumEquation('dest', ['src'], c0=10.0, alpha=0.1, beta=0.0),
           XSPHCorrection('dest', ['src'])]
    outs = []
    for scale in (None, 1.0, 3.0):
        dest = dict(states['dest'])
        for p in ('arho', 'au', 'av', 'aw', 'ax', 'ay', 'az'):
            dest[p] = torch.zeros(n, dtype=torch.float64)
        cap = None
        if scale is not None:
            cap = PairCapacity('cpu')
            cap.candidates = cap.pairs = int(scale * 60000)
        run_pair_phase([eq for eq in eqs], dest, states['src'],
                       cells['dest'], cells['src'], grid, CubicSpline(dim),
                       dest['tag'] == 0, 0.0, 1e-4, chunk=97, cap=cap)
        if cap is not None:
            assert cap.need[0] <= cap.candidates
            assert cap.need[1] <= cap.pairs
        outs.append(dest)
    for p in ('arho', 'au', 'av', 'ax', 'ay'):
        assert bool(outs[0][p].abs().max() > 0), p
        for out in outs[1:]:
            assert torch.equal(out[p], outs[0][p]), p


def test_capped_lists_read_nothing(monkeypatch):
    grid, states, cells = _case(2)
    cap = PairCapacity('cpu')
    cap.candidates, cap.pairs = 40000, 20000
    reads = []
    for name in ('tolist', 'item', '__float__', '__bool__', '__int__',
                 '__index__', 'numpy'):
        def read(self, *args, _name=name, _orig=getattr(torch.Tensor, name),
                 **kw):
            reads.append(_name)
            return _orig(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    grid.pair_overflow = torch.zeros((), dtype=torch.bool)
    grid.neighbor_pairs(states['dest'], cells['dest'], states['src'],
                        cells['src'], (0, 300), cap)
    assert reads == []


def test_empty_source():
    grid, states, cells = _case(2)
    src = {k: v[:0] for k, v in states['src'].items()}
    src_cells = grid.bin_all({'dest': states['dest'], 'src': src})['src']
    cap = PairCapacity('cpu')
    cap.candidates, cap.pairs = 10, 10
    i, j, w = grid.neighbor_pairs(states['dest'], cells['dest'], src,
                                  src_cells, (0, 50), cap)
    assert i.shape == (10,) and bool((w == 300).all())
    assert cap.need.tolist() == [0, 0]
