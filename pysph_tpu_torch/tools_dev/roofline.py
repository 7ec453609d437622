"""Work counts and bounds of the port's kernels on an NVIDIA H100.

Each ``*_work`` function takes a kernel's arguments (the same as the
kernel's wrapper) and returns a dict of what that call needs:

- ``candidates``: (dest, source) pairs of the 3^dim-cell stencil of
  width ``rs * hmax``, the yardstick of every walk;
- ``visited``: the (dest, source) pairs the kernel's walk actually
  tests.  Each lane of ``wcsph_pair``, ``gtvf_pair`` and ``fused_pair``
  and each thread of ``dense_pair`` tests exactly its own 3^dim cells
  (``ops/cell_walk.py``, held to the plain stencil walk by
  ``tests/test_torch_cell_walk.py``), so it equals ``candidates``, but
  for ``fused_pair``'s dests with ``h <= 0``, which walk nothing;
- ``pairs``: the pairs in support, ``r2 < (rs max(hi, hj))^2``;
- ``flops``: operations, a division, square root, ``exp``, compare,
  absolute value or max counting one, from the per-candidate and
  per-pair-in-support tables below (read off the CUDA sources, lines
  cited);
- ``bytes``: the unique bytes read and written, each input byte once:
  the dest's props, cell ids, write mask and ``pre`` values, the outputs,
  and of each source the particles and cell ranges that the walk can
  reach (cells in the stencil of a non-empty dest cell), with every prop
  the term mask reads.

``bound(work)`` is the least time the card could take for that work: the
larger of ``flops`` over the float32 peak outside the tensor cores and
``bytes`` over the memory rate (NVIDIA's H100 SXM data sheet, at the
700 W power limit), and which of the two sets it.  The counts come from
the cell lists and shapes, so they run on the CPU as well as on the
card; only a time divided by a bound is a device number.
"""

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import cell_walk
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops import wcsph_pair as wp

PEAK_FLOPS = 67e12    # float32, outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
I32 = 4

#: the support test of every walk: xij yij zij, r2, max(hi, hj), rs *,
#: square, compare (cell_walk.cuh:88-97)
SUPPORT_FLOPS = 12
#: per pair in support, before the terms: uij vij wij, hij, rinv, rij,
#: h1, q, fac, g, DWIJ (wcsph_terms.cuh), and the shape function by
#: kernel kind (WendlandQuintic, CubicSpline, Gaussian, QuinticSpline (its
#: three branches at q <= 1), WendlandQuinticC4, WendlandQuinticC6,
#: SuperGaussian in 2D and 3D; shapes.cuh)
WCSPH_PAIR_FLOPS = 22
SHAPE_FLOPS = (12, 9, 6, 22, 17, 22, 10, 10)
#: per term and pair in support (wcsph_terms.cuh); MOM, XSPH and VISC
#: share rhoij and rhoij1 (4), DCONT, DMOM and LVD V_j and EPS (3); TENS
#: counts what it adds to MOM (w / w(deltap) to the 4th power, R_i, R_j);
#: on a periodic grid the minimum image (IMAGE_FLOPS a periodic axis) in
#: every support test and in the body
WCSPH_TERM_FLOPS = {wp.CONT: 7, wp.MOM: 39, wp.XSPH: 10, wp.DCONT: 23,
                    wp.DMOM: 19, wp.VISC: 20, wp.TENS: 12, wp.SDEN: 3,
                    wp.LVD: 17}
WCSPH_RHO_FLOPS = 4
WCSPH_DELTA_FLOPS = 3
#: delta_pair.cu, per pair in support: DWIJ (:165-177) before the shape
#: function; the moment's 1 + 4 n^2 (:182-188); the gradient's drho and
#: sums (:211-214); the correction's solve by n (:95-128) and its test
#: 5 n + 4 (:194-208)
DELTA_PAIR_FLOPS = 26
DELTA_GRAD_FLOPS = 9
DELTA_SOLVE_FLOPS = {1: 3, 2: 13, 3: 56}
#: gtvf_pair.cu: WIJ and DWIJ of every pair in support before the shape
#: function (:403-429), then each term's functor (:166-375), MPG's h/2
#: gradient with a second shape function; the minimum image as
#: wcsph_pair's
GTVF_PAIR_FLOPS = 20
GTVF_TERM_FLOPS = {gp.SWV: 7, gp.CGTVF: 12, gp.CSOLID: 12, gp.CDENS: 4,
                   gp.VSUM: 1, gp.WALLP: 14, gp.MPG: 32, gp.MAS: 72,
                   gp.MVISC: 28}
#: fused_pair.cu: the support test and the h > 0 test per candidate
#: (cell_walk.cuh:74-83, fused_pair.cu:102), the rest per pair in
#: support (fused_pair.cu:103-144)
FUSED_CANDIDATE_FLOPS = 13
FUSED_PAIR_FLOPS = 65
#: bin_cells.cu: the reuse test per particle (the box's 6 and h's max,
#: 3 sub, 3 mul, 2 add and a max for the displacement; :194-206), and a
#: binning's cell id per axis of more than one cell (sub, div, floor, 2
#: clamps; :246-251); on a periodic grid the test's displacement takes
#: its minimum image too (IMAGE_FLOPS an axis)
BIN_TEST_FLOPS = 16
BIN_CELL_FLOPS = 5
#: tvf_pair.cu: per pair in support, xij, r2, hij, rinv, rij, h1, fac,
#: WIJ, the gradient's factor and DWIJ (pair_of) before the shape
#: function; each term (the functors' pair bodies; NOSLIP, the no-slip
#: wall: etai, etaj, etaij, Fij, its factor and u - ug, 24), and the
#: momentum terms' shared 1 / Vj, their volume factor, EPS and vij; the
#: minimum image, d - L rint(d / L), on each periodic axis, in every
#: support test (cell_walk.cuh) and in the body
TVF_PAIR_FLOPS = 30
TVF_TERM_FLOPS = {tp.SDEN: 3, tp.MPG: 25, tp.VISC: 25, tp.MAS: 57,
                  tp.AVIS: 25, tp.NOSLIP: 24}
TVF_MOMENTUM_FLOPS = 9
IMAGE_FLOPS = 4


def bound(work):
    """(ms, 'operations' or 'bytes'): the least time of ``work`` on the
    card and what sets it."""
    t_ops = work['flops'] / PEAK_FLOPS * 1e3
    t_bytes = work['bytes'] / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops > t_bytes else (t_bytes, 'bytes')


def add(*works):
    """The sum of several calls' work."""
    return {k: sum(w[k] for w in works) for k in works[0]}


def _grid3(grid, counts):
    nx, ny, nz = grid.dims
    return counts.reshape(nz, ny, nx)


def _shifted(a3, offs, periodic):
    """s[c] = a3[c + o] for the offsets ``offs`` (-1, 0 or 1 by array
    axis): wrapped on a ``periodic`` axis, 0 past the ends of another."""
    s = a3
    for ax, (o, per) in enumerate(zip(offs, periodic)):
        if o == 0:
            continue
        s = torch.roll(s, -o, ax)
        if not per:
            edge = [slice(None)] * 3
            edge[ax] = slice(-1, None) if o > 0 else slice(0, 1)
            s[tuple(edge)] = 0
    return s


def _shift_sum(grid, a3, x_offsets):
    """out[c] = sum over the stencil offsets o of a3[c + o] (0 outside
    the grid, wrapped on a periodic axis), on a (nz, ny, nx) array."""
    periodic = tuple(reversed(grid.periodic))
    out = torch.zeros_like(a3)
    for ox, oy, oz in grid.offsets(a3.device).tolist():
        if ox in x_offsets:
            out += _shifted(a3, (oz, oy, ox), periodic)
    return out


def stencil(grid, dest_cells, src_cells, x_offsets=(-1, 0, 1)):
    """(candidates, reached source particles, reached cells) of the walk
    of every dest over the source's cells at the stencil offsets whose x
    offset is in ``x_offsets``."""
    dcount = _grid3(grid, (dest_cells.end - dest_cells.start).long())
    scount = _grid3(grid, (src_cells.end - src_cells.start).long())
    candidates = int((dcount * _shift_sum(grid, scount, x_offsets)).sum())
    # a source cell is reached when a non-empty dest cell lies at minus a
    # stencil offset; the stencil is symmetric, so the same shifts do
    reached = _shift_sum(grid, (dcount > 0).long(),
                         tuple(-o for o in x_offsets)) > 0
    return candidates, int(scount[reached].sum()), int(reached.sum())


def support_pairs(grid, dest, dest_cells, src, src_cells, chunk=16384):
    """Pairs in support, from the torch pair engine's pair lists."""
    n = dest['x'].shape[0]
    return sum(int(grid.neighbor_pairs(dest, dest_cells, src, src_cells,
                                       (a, min(n, a + chunk)))[0].numel())
               for a in range(0, n, chunk))


def _dest_bytes(dest, write_mask, pre, props):
    """Dest props, cell ids and write mask read, pre read and outputs
    written, once each."""
    x = dest['x']
    n, es = x.shape[0], x.element_size()
    wm = 0 if write_mask is None else n
    return n * (es * (len(props) + 2 * len(pre)) + I32) + wm


def _source_bytes(src, reached, cells_reached, props):
    return reached * (src['x'].element_size() * len(props) + I32) + \
        cells_reached * 2 * I32


def wcsph_work(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Work of one ``wcsph_pair`` or ``dense_pair`` call."""
    terms = 0
    work = dict(candidates=0, visited=0, pairs=0, flops=0, bytes=0)
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    for src, cells, ps in sources:
        terms |= ps.terms
        cand, reached, ncells = stencil(grid, dest_cells, cells)
        work['visited'] += cand
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        per_pair = WCSPH_PAIR_FLOPS + image + shape + sum(
            f for t, f in WCSPH_TERM_FLOPS.items() if ps.terms & t)
        if ps.terms & (wp.MOM | wp.XSPH | wp.VISC):
            per_pair += WCSPH_RHO_FLOPS
        if ps.terms & (wp.DCONT | wp.DMOM | wp.LVD):
            per_pair += WCSPH_DELTA_FLOPS
        work['candidates'] += cand
        work['pairs'] += pairs
        work['flops'] += cand * (SUPPORT_FLOPS + image) + pairs * per_pair
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       wp._reads(ps.terms, with_mass=True))
    work['bytes'] += _dest_bytes(dest, write_mask, pre,
                                 wp._reads(terms, with_mass=False))
    return work


def delta_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
               walks=True):
    """Work of one ``delta_pair`` call: the walk of ``wcsph_pair``; the
    dest's x y z h (with rho for the gradient, and m_mat for the
    correction), cell ids, write mask, pre values and output read or
    written once; of each source the reachable particles' x y z h m rho
    and cell ranges.  ``walks=False``: a gradient call that reads a
    linked moment call's neighbour list, whose candidates' support
    tests that walk made and are not counted again.  On a periodic grid
    the stencil wraps and every support test and pair takes the minimum
    image."""
    x = dest['x']
    n, es = x.shape[0], x.element_size()
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    ds = sources[0][2]
    if ds.terms & dl.MMAT:
        body = 1 + 4 * ds.dim * ds.dim
    else:
        body = DELTA_GRAD_FLOPS
        if ds.terms & dl.CORR:
            body += DELTA_SOLVE_FLOPS[ds.dim] + 5 * ds.dim + 4
    work = dict(candidates=0, visited=0, pairs=0, flops=0, bytes=0)
    for src, cells, _ in sources:
        cand, reached, ncells = stencil(grid, dest_cells, cells)
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        if walks:
            work['candidates'] += cand
            work['visited'] += cand
            work['flops'] += cand * (SUPPORT_FLOPS + image)
        work['pairs'] += pairs
        work['flops'] += pairs * (DELTA_PAIR_FLOPS + image + shape + body)
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       dl.PACK_RECORDS[0] + ('m', 'rho'))
    (out,) = pre.values()
    props = 4 + (0 if ds.terms & dl.MMAT else 1) + (
        9 if ds.terms & dl.CORR else 0)
    work['bytes'] += n * (es * (props + 2 * out.shape[1]) + I32) + (
        0 if write_mask is None else n)
    return work


def pack_work(sources):
    """Work of one ``pack_sources`` call: each source's order and the
    props its terms read, read once, and its records written once."""
    nbytes = 0
    for src, _, ps in sources:
        x = src['x']
        nbytes += x.shape[0] * (I32 + x.element_size() * (
            len(wp._reads(ps.terms, with_mass=True)) +
            4 * wp.pack_planes(ps.terms)))
    return dict(candidates=0, visited=0, pairs=0, flops=0, bytes=nbytes)


def gtvf_work(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Work of one ``gtvf_pair`` call (the stencil wrapped on a periodic
    grid)."""
    terms = 0
    work = dict(candidates=0, visited=0, pairs=0, flops=0, bytes=0)
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    for src, cells, gs in sources:
        terms |= gs.terms
        cand, reached, ncells = stencil(grid, dest_cells, cells)
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        per_pair = GTVF_PAIR_FLOPS + image + shape + sum(
            f for t, f in GTVF_TERM_FLOPS.items() if gs.terms & t)
        if gs.terms & gp.MPG:
            per_pair += shape
        work['candidates'] += cand
        work['visited'] += cand
        work['pairs'] += pairs
        work['flops'] += cand * (SUPPORT_FLOPS + image) + pairs * per_pair
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       gp._reads(gs.terms, 1))
    work['bytes'] += _dest_bytes(dest, write_mask, pre, gp._reads(terms, 0))
    return work


def tvf_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
             walks=True):
    """Work of one ``tvf_pair`` call (the stencil wrapped on a periodic
    grid).  ``walks=False``: a momentum call that reads a linked density
    call's neighbour list, whose candidates' support tests that walk
    made and are not counted again."""
    terms = 0
    work = dict(candidates=0, visited=0, pairs=0, flops=0, bytes=0)
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    for src, cells, ts in sources:
        terms |= ts.terms
        cand, reached, ncells = stencil(grid, dest_cells, cells)
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        per_pair = TVF_PAIR_FLOPS + image + shape + sum(
            f for t, f in TVF_TERM_FLOPS.items() if ts.terms & t)
        if ts.terms & ~tp.SDEN:
            per_pair += TVF_MOMENTUM_FLOPS
        if walks:
            work['candidates'] += cand
            work['visited'] += cand
            work['flops'] += cand * (SUPPORT_FLOPS + image)
        work['pairs'] += pairs
        work['flops'] += pairs * per_pair
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       tp._reads(ts.terms, 1))
    work['bytes'] += _dest_bytes(dest, write_mask, pre, tp._reads(terms, 0))
    return work


def fused_work(state, cells, grid):
    """Work of one ``fused_continuity_momentum`` call (one array against
    itself, 9 props in, 4 sums out, no pre values or write mask)."""
    x = state['x']
    n, es = x.shape[0], x.element_size()
    cand, _, ncells = stencil(grid, cells, cells)
    pairs = support_pairs(grid, state, cells, state, cells)
    walks = state['h'][cells.order.long()] > 0
    visited = int(cell_walk.walk_spans(grid, cells, cells).diff(dim=2)[
        walks].sum())
    return dict(candidates=cand, visited=visited, pairs=pairs,
                flops=cand * FUSED_CANDIDATE_FLOPS + pairs * FUSED_PAIR_FLOPS,
                bytes=n * (es * (9 + 4) + 2 * I32) + ncells * 2 * I32)


def bin_work(grid, states, rebuilt):
    """Work of one ``bin_cells`` call on ``states`` ({name: state}):
    kept, each particle's x y z h and reference position read once;
    rebuilt, also its cell id, its place in the order and its reference
    position written, and start and end of every cell of each array (the
    per-cell counts are the kernels' scratch, not the function's)."""
    x = next(iter(states.values()))['x']
    n = sum(s['x'].shape[0] for s in states.values())
    es = x.element_size()
    work = dict(candidates=0, visited=0, pairs=0,
                flops=n * (BIN_TEST_FLOPS + IMAGE_FLOPS * sum(grid.periodic)),
                bytes=n * 7 * es)
    if rebuilt:
        work['bytes'] += n * (3 * es + 2 * I32) + \
            len(states) * grid.ncells * 2 * I32
        work['flops'] += n * BIN_CELL_FLOPS * grid.dim
    return work


def stub_work(mode, dest, dest_cells, write_mask, pre, sources, grid,
              kernel):
    """Work of one ``pair_stub`` call in ``mode``: the outputs written;
    from ``dest`` on, the dest props ``wcsph_pair`` loads; from ``third``
    on, the walk's loads and support tests over the cells at the stencil
    x offsets of the mode (``visited``: the same count)."""
    x = dest['x']
    n, es = x.shape[0], x.element_size()
    terms = 0
    for _, _, ps in sources:
        terms |= ps.terms
    work = dict(candidates=0, visited=0, pairs=0, flops=0,
                bytes=n * es * len(pre))
    if mode == 'none':
        return work
    dprops = wp._reads(terms, with_mass=False)
    work['bytes'] += n * es * (len(dprops) + int(bool(terms & wp.MOM)))
    if mode == 'dest':
        return work
    work['bytes'] += n * I32     # cell ids
    x_offsets = (-1, 0, 1) if mode == 'all' else (0,)
    for src, cells, ps in sources:
        cand, reached, ncells = stencil(grid, dest_cells, cells, x_offsets)
        work['candidates'] += cand
        work['visited'] += cand
        work['flops'] += cand * SUPPORT_FLOPS
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       wp._reads(ps.terms, with_mass=True))
    return work


def micro_launch_work(src, n_programs, n_views):
    """Work of one ``micro_launch`` call: the first 8 lanes of every
    distinct block its views reach, the outputs, one add per input."""
    n_blocks, planes, tz, _ = src.shape
    blocks = micro.launch_map(n_programs, n_views, n_blocks)
    return dict(candidates=0, pairs=0,
                flops=n_programs * n_views * planes * tz * micro.OUT_LANES,
                bytes=(int(torch.unique(blocks).numel()) * planes +
                       n_programs) * tz * micro.OUT_LANES * 4)


def micro_engine_work(src, bi, bj, bz, inv, n_views=9, dyn_maps=True,
                      md=32, nx=micro.NX, ny=micro.NY, n_zt=micro.N_ZT):
    """Work of one ``micro_engine`` call (its arguments): plane 0 of every
    distinct block that each source's views reach, the outputs, and under
    ``dyn_maps`` the block coordinates and the distinct entries of
    ``inv`` read; one add per input lane."""
    n_src, tz, lanes = src.shape[0], src.shape[3], src.shape[4]
    a_max = bi.shape[0]
    blocks = micro.engine_blocks(bi, bj, bz, inv, src.shape[1] - 1,
                                 n_views, dyn_maps, nx, ny, n_zt)
    distinct = sum(int(torch.unique(b).numel()) for b in blocks)
    maps = 0
    if dyn_maps:
        cells = micro.engine_cells(bi, bj, bz, n_views, nx, ny, n_zt)
        maps = (3 * a_max + n_src * int(torch.unique(cells).numel())) * I32
    return dict(candidates=0, pairs=0,
                flops=n_src * a_max * n_views * tz * lanes,
                bytes=(distinct * tz * lanes + a_max * micro.OUT_PLANES *
                       tz * md) * 4 + maps)
