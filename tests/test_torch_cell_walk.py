"""The walks of the WCSPH pair kernels on the CPU: row spans of the cell
order, the packed source copy and the pack's arguments, ``wcsph_pair``'s
lane walk (``ops/cell_walk.py``, the rule of ``csrc/cell_walk.cuh``) and
``dense_pair``'s tiles and staged chunks, held to the plain 3^dim
stencil walk on seeded cases with clamped particles
(``tools_dev/walk_cases.py``), and the work counter's ``visited``."""

import re

import numpy as np
import pytest
import torch

from pysph_tpu_torch.ops import build, cell_walk
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev import walk_cases as wc

WALKED = ('clamped-3d', 'grid-2d', 'four-sources')


def _ijk(grid, cell):
    nx, ny, _ = grid.dims
    return cell % nx, (cell // nx) % ny, cell // (nx * ny)


def _stencil_walk(grid, src_cells, cell):
    """The source positions of the plain stencil walk of a dest in
    ``cell``: row (oz, oy), x ascending, then position."""
    nx, ny, nz = grid.dims
    start, end = src_cells.start.numpy(), src_cells.end.numpy()
    cx, cy, cz = _ijk(grid, cell)
    out = []
    for oy, oz in cell_walk.stencil_rows(grid):
        y, z = cy + oy, cz + oz
        if not (0 <= y < ny and 0 <= z < nz):
            continue
        for x in range(max(cx - 1, 0), min(cx + 1, nx - 1) + 1):
            c = x + nx * (y + ny * z)
            out.append(np.arange(start[c], end[c]))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _support(dest, i, src, src_cells, ks, rs):
    """The positions ``ks`` of the packed source that dest ``i`` holds in
    support, in the order given."""
    j = src_cells.order.numpy()[ks]
    r2 = sum((float(dest[c][i]) - src[c].numpy()[j]) ** 2 for c in 'xyz')
    sup = rs * np.maximum(float(dest['h'][i]), src['h'].numpy()[j])
    return ks[r2 < sup * sup]


@pytest.mark.parametrize('case', WALKED)
def test_row_span_is_the_three_cells_ranges(case):
    _, _, _, _, sources, grid, _ = wc.make_case(case)
    nx = grid.dims[0]
    clamped = 0
    for src, cells, _ in sources:
        order = cells.order.numpy()
        start, end = cells.start.numpy(), cells.end.numpy()
        cid = cells.cell.numpy()
        for c in range(grid.ncells):
            assert (cid[order[start[c]:end[c]]] == c).all()
            x = c % nx
            if 0 < x < nx - 1:
                want = np.concatenate([order[start[k]:end[k]]
                                       for k in (c - 1, c, c + 1)])
                assert np.array_equal(order[start[c - 1]:end[c + 1]], want)
        inside = (src['x'] < 1.0) & (src['y'] < 1.0) & (src['z'] < 1.0)
        clamped += int((~inside).sum())
    assert clamped > 0


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', WALKED)
def test_pack_is_the_gather_through_the_cell_order(case, dtype):
    _, _, _, _, sources, _, _ = wc.make_case(case, dtype=dtype, seed=1)
    packed = wp.pack_sources(sources)
    assert len(packed) == len(sources)
    for rec, ref, (src, cells, ps) in zip(
            packed, wp.pack_sources_reference(sources), sources):
        assert torch.equal(rec, ref)
        planes = 3 if ps.terms & (wp.MOM | wp.XSPH) else 2
        n = src['x'].shape[0]
        assert rec.shape == (planes, n, 4) and rec.dtype == dtype
        order = cells.order.long()
        for plane, names in enumerate(wp.PACK_RECORDS[:planes]):
            for col, p in enumerate(names):
                want = torch.zeros(n, dtype=dtype) if p is None or (
                    p in ('p', 'cs') and not ps.terms & wp.MOM) \
                    else src[p][order]
                assert torch.equal(rec[plane, :, col], want), (plane, p)


@pytest.mark.parametrize('case', WALKED)
def test_lane_walk_is_the_plain_stencil_walk(case):
    dest, dcells, _, _, sources, grid, _ = wc.make_case(case, seed=2)
    order = dcells.order.numpy()
    cells = dcells.cell.numpy()[order]
    in_support = 0
    for src, scells, _ in sources:
        spans = cell_walk.walk_spans(grid, dcells, scells).numpy()
        third = cell_walk.walk_spans(grid, dcells, scells, halo=0).numpy()
        assert (spans[..., 0] <= third[..., 0]).all() and \
            (third[..., 1] <= spans[..., 1]).all()
        for p in range(0, order.size, 7):
            walked = np.concatenate([np.arange(a, b) for a, b in spans[p]])
            plain = _stencil_walk(grid, scells, cells[p])
            assert np.array_equal(walked, plain)
            in_support += _support(dest, order[p], src, scells, walked,
                                   grid.radius_scale).size
    assert in_support > 0


def _dense_visits(grid, dcells, scells, stage_records):
    """{sorted dest position: positions visited}, as ``dense_pair``
    walks one source: a block per tile of TILE_CELLS x cells of a row,
    each stencil row's span of the tile's cells x0 - 1 .. x1 + 1 staged
    in chunks of ``stage_records``, each thread walking the part of the
    chunk in its own cells.  Also returns the number of chunks that are
    not the first of their span."""
    nx, ny, nz = grid.dims
    t = cell_walk.TILE_CELLS
    dstart, dend = dcells.start.numpy(), dcells.end.numpy()
    start, end = scells.start.numpy(), scells.end.numpy()
    dcell = dcells.cell.numpy()[dcells.order.numpy()]
    visits, split = {}, 0
    for row in range(ny * nz):
        y, z = row % ny, row // ny
        for x0 in range(0, nx, t):
            x1 = min(x0 + t, nx) - 1
            dests = range(dstart[x0 + nx * row], dend[x1 + nx * row])
            for oy, oz in cell_walk.stencil_rows(grid):
                yy, zz = y + oy, z + oz
                if not (0 <= yy < ny and 0 <= zz < nz):
                    continue
                base = nx * (yy + ny * zz)
                k0 = start[base + max(x0 - 1, 0)]
                k1 = end[base + min(x1 + 1, nx - 1)]
                for kc in range(k0, k1, stage_records):
                    split += kc > k0
                    kend = min(kc + stage_records, k1)
                    for p in dests:
                        cx = dcell[p] % nx
                        a = max(start[base + max(cx - 1, 0)], kc)
                        b = min(end[base + min(cx + 1, nx - 1)], kend)
                        visits.setdefault(p, []).append(np.arange(a, b))
    return {p: np.concatenate(v) for p, v in visits.items()}, split


@pytest.mark.parametrize('stage_records', [cell_walk.STAGE_RECORDS, 32])
@pytest.mark.parametrize('case', WALKED)
def test_dense_tiles_and_chunks_visit_each_stencil_candidate_once(
        case, stage_records):
    _, dcells, _, _, sources, grid, _ = wc.make_case(case, seed=3)
    dcell = dcells.cell.numpy()[dcells.order.numpy()]
    fat = int((dcells.end - dcells.start).max())
    splits = 0
    for _, scells, _ in sources:
        visits, split = _dense_visits(grid, dcells, scells, stage_records)
        for p in range(dcell.size):
            got = visits.get(p, np.zeros(0, np.int64))
            assert np.array_equal(got, _stencil_walk(grid, scells,
                                                     dcell[p]))
        splits += split
    # spans longer than a stage: the fat clamped cell, or short stages
    if case == 'clamped-3d' or stage_records == 32:
        assert splits > 0
    assert (fat > cell_walk.STAGE_RECORDS) == (case == 'clamped-3d')


def test_walk_constants_are_the_cuda_sources():
    def const(name, source):
        m = re.search(r'constexpr int %s = (\d+);' % name,
                      (build.CSRC / source).read_text())
        return int(m.group(1))
    assert const('kTileCells', 'dense_pair.cu') == cell_walk.TILE_CELLS
    assert const('kStages', 'dense_pair.cu') == cell_walk.STAGES
    assert const('kStageRecords', 'dense_pair.cu') == cell_walk.STAGE_RECORDS


@pytest.mark.parametrize('case', wc.CASES)
def test_work_counter_visited_is_the_walks_candidates(case):
    args = wc.make_case(case, seed=4)
    dest, dcells, _, _, sources, grid, _ = args
    work = roofline.wcsph_work(*args)
    assert work['visited'] == work['candidates']
    stub = {m: roofline.stub_work(m, *args) for m in ('third', 'all')}
    assert stub['all']['visited'] == work['visited']
    for mode, halo in (('all', 1), ('third', 0)):
        walked = sum(int(np.diff(cell_walk.walk_spans(
            grid, dcells, scells, halo).numpy()).sum())
            for _, scells, _ in sources)
        assert stub[mode]['visited'] == walked
    assert stub['third']['visited'] <= stub['all']['visited']
    assert (stub['third']['visited'] < stub['all']['visited']) == (
        case != 'empty-dest')


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', WALKED)
def test_pair_args_point_the_walk_at_its_pack(case, dtype):
    """The pack that a walk's launch function runs first writes the
    copies whose planes the walk reads, one aligned buffer for all."""
    args = wc.make_case(case, dtype=dtype, seed=5)
    sources = args[4]
    wa, _, copies = wp.pair_args('wcsph_pair', *args, packed=True)
    assert wa.pack.n_src == wa.n_src == len(sources) == len(copies)
    assert wa.pack.dtype == wa.dtype == int(dtype == torch.float64)
    record = 4 * copies[0].element_size()
    for k, (rec, (src, cells, ps)) in enumerate(zip(copies, sources)):
        planes, n = wp.pack_planes(ps.terms), src['x'].shape[0]
        assert rec.shape == (planes, n, 4) and rec.is_contiguous()
        ps_args, sa = wa.pack.src[k], wa.src[k]
        assert (ps_args.n, ps_args.planes) == (n, planes)
        assert ps_args.out == sa.pos == rec.data_ptr()
        assert ps_args.out % record == 0
        assert sa.vel == sa.pos + n * record
        assert (sa.thermo or 0) == (sa.pos + 2 * n * record
                                    if planes == 3 else 0)
        assert ps_args.order == cells.order.data_ptr()
        for p in wp.PACK_RECORDS[0] + wp.PACK_RECORDS[1]:
            assert getattr(ps_args, p) == src[p].data_ptr()
        assert bool(ps_args.rho) == (planes == 3)
    no_pack = wp.pair_args('wcsph_pair', *args)
    assert no_pack[0].pack.n_src == 0 and no_pack[2] is None


def test_pair_args_reject_a_source_prop_of_the_wrong_length():
    dest, dcells, wm, pre, sources, grid, kernel = wc.make_case('grid-2d')
    src = dict(sources[1][0])
    src['rho'] = src['rho'][:-1]
    sources[1] = (src,) + sources[1][1:]
    with pytest.raises(ValueError, match='s_rho'):
        wp.pair_args('wcsph_pair', dest, dcells, wm, pre, sources, grid,
                     kernel, packed=True)
