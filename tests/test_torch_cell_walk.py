"""The walks of the pair kernels on the CPU: row spans of the cell
order, the packed source copies (``ops/cell_pack.py``) and the pack's
arguments, the lanes' walk of ``wcsph_pair``, ``gtvf_pair`` and
``fused_pair`` (``ops/cell_walk.py``, the rule of ``csrc/cell_walk.cuh``)
and ``dense_pair``'s tiles and staged chunks, held to the plain 3^dim
stencil walk on seeded cases with clamped particles
(``tools_dev/walk_cases.py``), the record planes against the ``.cu``
sources, and the work counter's ``visited``."""

import re

import numpy as np
import pytest
import torch

from pysph_tpu_torch.ops import build, cell_pack, cell_walk
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev import walk_cases as wc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

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
    wa, _, buf = wp.pair_args('wcsph_pair', *args, packed=True)
    copies = cell_pack.copies(buf, wp._packs(sources))
    assert wa.pack.n_src == wa.n_src == len(sources) == len(copies)
    assert wa.pack.dtype == wa.dtype == int(dtype == torch.float64)
    record = 4 * buf.element_size()
    assert sum(c.numel() for c in copies) == buf.numel()
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
        for q in range(cell_pack.MAX_PLANES):
            names = wp.pack_layout(ps.terms)[q] if q < planes else (None,) * 4
            for c, p in enumerate(names):
                assert (ps_args.prop[q][c] or 0) == (
                    0 if p is None else src[p].data_ptr()), (q, p)
        assert bool(ps_args.prop[2][0]) == (planes == 3)
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


def _fixed_wcsph_pack(sources):
    """The WCSPH pack as a fixed gather, before the planes became a
    table: {x y z h}, {u v w m}, and {rho p cs 0} where the terms read
    rho, with a prop the terms do not read as 0."""
    out = []
    for src, cells, ps in sources:
        order = cells.order.long()
        reads = wp._reads(ps.terms, with_mass=True)
        zero = torch.zeros_like(src['x'][order])
        planes = 3 if ps.terms & (wp.MOM | wp.XSPH) else 2
        out.append(torch.stack([
            torch.stack([src[p][order] if p in reads else zero
                         for p in names], dim=1)
            for names in (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                          ('rho', 'p', 'cs', None))[:planes]]))
    return out


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', WALKED)
def test_table_pack_is_the_fixed_wcsph_pack(case, dtype):
    sources = wc.make_case(case, dtype=dtype, seed=6)[4]
    for got, want in zip(wp.pack_sources_reference(sources),
                         _fixed_wcsph_pack(sources)):
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.fixture(scope='module')
def gtvf_calls():
    return wc.gtvf_calls(crowd=True)


@pytest.mark.parametrize('phase', range(len(gp.PHASE_SETS)))
def test_gtvf_pack_planes_are_the_gather_through_the_cell_order(
        gtvf_calls, phase):
    """Each source packs {x y z h} and the planes holding a prop its
    terms read; column p of a plane is ``src[p][order]``, 0 where the
    terms read nothing there."""
    calls = [c for c in gtvf_calls if gp.phase_of(
        np.bitwise_or.reduce([ps.terms for ps in c[2].sources])) == phase]
    assert calls
    for _, _, _, args in calls:
        sources = args[4]
        for rec, (src, cells, gs) in zip(gp.pack_sources(sources), sources):
            reads = gp._reads(gs.terms, 1)
            slots = [q for q, names in enumerate(gp.PACK_RECORDS)
                     if q == 0 or reads & set(names)]
            n = src['x'].shape[0]
            assert rec.shape == (len(slots), n, 4)
            order = cells.order.long()
            for plane, q in zip(rec, slots):
                for col, p in zip(plane.T, gp.PACK_RECORDS[q]):
                    want = src[p][order] if p in reads else \
                        torch.zeros(n, dtype=torch.float64)
                    assert torch.equal(col, want), (q, p)
    # the walls' rho0 of 0 is carried as it is (rhodiv = inf)
    if phase == 2:
        assert any(bool((rec[1, :, 3] == 0).any())
                   for c in calls for rec in gp.pack_sources(c[3][4]))


def _plane_name(p):
    """A name of a ``plane q:`` comment: ``0``, a prop, or ``prop[c]``,
    column c of a strided prop."""
    if p == '0':
        return None
    m = re.fullmatch(r'(\w+)\[(\d)\]', p)
    return (m.group(1), int(m.group(2))) if m else p


@pytest.mark.parametrize('kernel', ['wcsph_pair', 'gtvf_pair', 'fused_pair',
                                    'delta_pair', 'tvf_pair'])
def test_plane_tables_are_the_cuda_sources(kernel):
    module, source = {'wcsph_pair': (wp, 'wcsph_terms.cuh'),
                      'gtvf_pair': (gp, 'gtvf_pair.cu'),
                      'fused_pair': (fp, 'fused_pair.cu'),
                      'delta_pair': (dl, 'delta_pair.cu'),
                      'tvf_pair': (tp, 'tvf_pair.cu')}[kernel]
    rows = re.findall(r'^//\s+plane (\d): (.+)$',
                      (build.CSRC / source).read_text(), re.MULTILINE)
    assert [int(q) for q, _ in rows] == list(range(len(rows)))
    assert [tuple(_plane_name(p) for p in names.split())
            for _, names in rows] == list(module.PACK_RECORDS)
    assert len(rows) <= cell_pack.MAX_PLANES


@pytest.mark.parametrize('kernel', ['gtvf_pair', 'fused_pair'])
def test_gtvf_and_fused_lanes_walk_the_plain_stencil(gtvf_calls, kernel):
    """``gtvf_pair`` on the GTVF calls (2D, a crowded clamped corner
    cell) and ``fused_pair``'s self walk on cells 2.5 hmax wide with
    rows of h <= 0 (which walk nothing): each lane's spans are exactly
    its stencil candidates, and ``visited`` counts them."""
    if kernel == 'gtvf_pair':
        walks = [(args[5], args[1], scells, None)
                 for _, _, _, args in gtvf_calls
                 for _, scells, _ in args[4]]
        for _, _, _, args in gtvf_calls:
            work = roofline.gtvf_work(*args)
            assert work['visited'] == work['candidates'] > 0
    else:
        st, cells, grid, _ = wc.fused_case(radius_scale=2.5)
        assert grid.radius_scale == 2.5
        walks = [(grid, cells, cells, st['h'])]
    fat = 0
    for grid, dcells, scells, h in walks:
        order = dcells.order.numpy()
        cell = dcells.cell.numpy()[order]
        spans = cell_walk.walk_spans(grid, dcells, scells).numpy()
        fat = max(fat, int((scells.end - scells.start).max()))
        visited = 0
        for p in range(order.size):
            walked = np.concatenate([np.arange(a, b) for a, b in spans[p]])
            assert np.array_equal(walked, _stencil_walk(grid, scells,
                                                        cell[p]))
            if h is None or h[order[p]] > 0:
                visited += walked.size
    assert fat >= 100       # the clamped corner cell
    if kernel == 'fused_pair':
        work = roofline.fused_work(st, cells, grid)
        assert work['visited'] == visited < work['candidates']
