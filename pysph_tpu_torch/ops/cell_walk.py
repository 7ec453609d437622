"""The walks of the pair kernels, in torch: which source positions each
dest tests.

Mirrors ``csrc/cell_walk.cuh`` (``wcsph_pair``, ``gtvf_pair``,
``fused_pair`` and ``pair_stub``) and the tile constants of
``csrc/dense_pair.cu``, so that the CPU tests can hold the rules to the
plain stencil walk.  Positions index a source's packed copy
(``ops/cell_pack.py``), which is its cell order.

The lanes' rule: the dest at position ``p`` of its sorted order is lane
``p % 32`` of warp ``p // 32``, and in each stencil row (z offset outer,
y offset inner) it tests the positions of its x cells ``cx - halo .. cx
+ halo`` (clipped to the grid), one contiguous range: with halo 1
exactly the candidates of its 3^dim stencil.  (``fused_pair``'s dests
with ``h <= 0`` walk nothing.)  On a periodic grid (``tvf_pair``) the
rows wrap and a row's x cells that cross the grid's end are two ranges
(``periodic_spans``).
"""

import torch

#: dense_pair: x-adjacent dest cells of a block, shared-memory stages and
#: {x, y, z, h} records a stage holds (dense_pair.cu kTileCells, kStages,
#: kStageRecords)
TILE_CELLS = 8
STAGES = 4
STAGE_RECORDS = 512
#: dense_pair: dests of one pass of a block (dense_pair.cu kDests)
PASS_DESTS = 128


def dense_passes(grid, dest_cells):
    """(tiles holding a dest, their passes) of ``dense_pair``'s blocks:
    a tile of ``TILE_CELLS`` x-adjacent cells of a row takes
    ``ceil(dests / PASS_DESTS)`` passes over its stencil."""
    nx, ny, nz = grid.dims
    counts = (dest_cells.end - dest_cells.start).long().reshape(ny * nz, nx)
    counts = torch.nn.functional.pad(counts, (0, (-nx) % TILE_CELLS))
    dests = counts.reshape(ny * nz, -1, TILE_CELLS).sum(dim=2)
    busy = dests[dests > 0]
    return int(busy.numel()), int(((busy + PASS_DESTS - 1) //
                                   PASS_DESTS).sum())


def stencil_rows(grid):
    """[(oy, oz)] of the stencil rows, in the walks' order."""
    ry = (-1, 0, 1) if grid.dims[1] > 1 else (0,)
    rz = (-1, 0, 1) if grid.dims[2] > 1 else (0,)
    return [(oy, oz) for oz in rz for oy in ry]


def walk_spans(grid, dest_cells, src_cells, halo=1):
    """(n, rows, 2) int64: the source positions [k0, k1) that the dest at
    each sorted position tests in each stencil row (``stencil_rows``),
    under the lanes' rule (halo 1) or ``pair_stub``'s ``third`` (halo 0);
    (0, 0) for a row outside the grid."""
    nx, ny, nz = grid.dims
    cell = dest_cells.cell[dest_cells.order.long()].long()
    cx, row = cell % nx, cell // nx
    y, z = row % ny, row // ny
    xa = (cx - halo).clamp(min=0)
    xb = (cx + halo).clamp(max=nx - 1)
    start, end = src_cells.start.long(), src_cells.end.long()
    spans = []
    for oy, oz in stencil_rows(grid):
        yy, zz = y + oy, z + oz
        inside = (yy >= 0) & (yy < ny) & (zz >= 0) & (zz < nz)
        base = nx * (yy.clamp(0, ny - 1) + ny * zz.clamp(0, nz - 1))
        spans.append(torch.stack([
            torch.where(inside, start[base + xa], 0),
            torch.where(inside, end[base + xb], 0)], dim=1))
    return torch.stack(spans, dim=1)


def periodic_spans(grid, dest_cells, src_cells):
    """(n, rows, 2, 2) int64: the two ranges [k0, k1) of source positions
    that the dest at each sorted position tests in each stencil row of a
    periodic grid (``walk_rows_periodic``: the rows of the axes' offsets,
    ``CellGrid.axis_offsets``, z outer; on a periodic axis the row wraps;
    on a periodic x axis cells ``cx + lo .. cx + hi`` that cross the
    grid's end are the first range up to the end and the second from cell
    0, else one range and an empty second); (0, 0) for a row outside the
    grid on an axis that is not periodic."""
    nx, ny, nz = grid.dims
    px, py, pz = grid.periodic
    cell = dest_cells.cell[dest_cells.order.long()].long()
    cx, row = cell % nx, cell // nx
    y, z = row % ny, row // ny
    xo = grid.axis_offsets(0)
    xa, xb = cx + xo[0], cx + xo[-1]
    start, end = src_cells.start.long(), src_cells.end.long()
    zero = torch.zeros_like(cx)
    spans = []
    for oz in grid.axis_offsets(2):
        for oy in grid.axis_offsets(1):
            yy, zz = y + oy, z + oz
            inside = torch.ones_like(cx, dtype=torch.bool)
            if py:
                yy = yy % ny
            else:
                inside &= (yy >= 0) & (yy < ny)
            if pz:
                zz = zz % nz
            else:
                inside &= (zz >= 0) & (zz < nz)
            base = nx * (yy.clamp(0, ny - 1) + ny * zz.clamp(0, nz - 1))
            if px:
                low, high = xa < 0, xb >= nx
                a0 = torch.where(low, xa + nx, xa)
                b0 = torch.where(low | high, nx - 1, xb)
                b1 = torch.where(low, xb, xb - nx)
                split = low | high
                second = torch.stack([
                    torch.where(split, start[base], zero),
                    torch.where(split, end[base + b1.clamp(0, nx - 1)],
                                zero)], dim=1)
            else:
                a0, b0 = xa.clamp(min=0), xb.clamp(max=nx - 1)
                second = torch.stack([zero, zero], dim=1)
            first = torch.stack([start[base + a0], end[base + b0]], dim=1)
            spans.append(torch.where(inside[:, None, None],
                                     torch.stack([first, second], dim=1),
                                     0))
    return torch.stack(spans, dim=1)
