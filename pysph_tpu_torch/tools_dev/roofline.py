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

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import cell_walk
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.ops import tsph_pair as ts
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
#: function, then each term's functor, MPG's h/2 gradient with a second
#: shape function (EDAC's wall terms: SND and VSUM a sum each, EWALLP
#: WALLP's without wij, ESWV SWV's without it); the minimum image as
#: wcsph_pair's
GTVF_PAIR_FLOPS = 20
GTVF_TERM_FLOPS = {gp.SWV: 7, gp.CGTVF: 12, gp.CSOLID: 12, gp.CDENS: 4,
                   gp.VSUM: 1, gp.WALLP: 14, gp.MPG: 32, gp.MAS: 72,
                   gp.MVISC: 28, gp.SND: 1, gp.EWALLP: 13, gp.ESWV: 6}
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
#: wall: etai, etaj, etaij, Fij, its factor and u - ug, 24; EDAC's
#: (edac_pair): AVGP the sum and the count, 2; EMPG MPG's with p - pavg
#: on both sides, 27; EMOM the pressure gradient alone, 13; EDACEQ etaij,
#: v.DWIJ and x.DWIJ, the two increments of ap, 29; XSPH rhoij, its
#: guarded reciprocal and the three increments, 14), and the momentum
#: terms' shared 1 / Vj, their volume factor, EPS and vij; the minimum
#: image, d - L rint(d / L), on each periodic axis, in every support test
#: (cell_walk.cuh) and in the body
TVF_PAIR_FLOPS = 30
TVF_TERM_FLOPS = {tp.SDEN: 3, tp.MPG: 25, tp.VISC: 25, tp.MAS: 57,
                  tp.AVIS: 25, tp.NOSLIP: 24, tp.AVGP: 2, tp.EMPG: 27,
                  tp.EMOM: 13, tp.EDACEQ: 29, tp.XSPH: 14}
TVF_MOMENTUM_FLOPS = 9
#: iisph_pair.cu: per pair in support pair_of as tvf_pair's (before the
#: shape function), then each term's functor: NDEN the sum; SDEN m W;
#: SDENB rho0 / Vj W; DII -m rho_1^2 and 3 increments; DIIB with
#: rho0 / Vj; VISC vij, EPS, x.DWIJ, rhoij and its guarded reciprocal,
#: the factor and 3 increments; VISCB with phi_b; RHOADV (uadv_i -
#: uadv_j).DWIJ, dt m and the sum (RHOB the wall's u v w, rho0 / Vj);
#: AII (dii_i - fac DWIJ).DWIJ and m times it (AIIB rho0 / Vj); DIJPJ
#: 1 / rho_j, -m_j rho1^2 piter_j and 3 increments; PSOLVE djkpk, tmp,
#: tmp.DWIJ and m times it; PSOLVEB rho0 / Vj dijpj_i.DWIJ; PFORCE 1 /
#: rho_j, the two pressure terms and 3 increments; PFORCEB -p_i rho_i1^2
#: rho0 / Vj and 3 increments
IISPH_TERM_FLOPS = {ip.NDEN: 1, ip.SDEN: 2, ip.SDENB: 3, ip.DII: 9,
                    ip.DIIB: 10, ip.VISC: 26, ip.VISCB: 23, ip.RHOADV: 11,
                    ip.RHOB: 12, ip.AII: 13, ip.AIIB: 14, ip.DIJPJ: 11,
                    ip.PSOLVE: 22, ip.PSOLVEB: 8, ip.PFORCE: 15,
                    ip.PFORCEB: 11}
IMAGE_FLOPS = 4
#: gasd_pair.cu: per pair in support, pair_of (xij, r2, rinv, rij: 11);
#: the density set's q, shape at hi, the gradient's factor and DWI, v.DWI,
#: WI, the five sums and GHI (gradient_h, 6): 35 beside the shape; the
#: momentum set's pj / rhoj^2, cij, rhoij, hij, EPS, the two further
#: smoothing lengths' h1 and fac, three gradients' q and factor, DWI DWJ
#: DWIJ, vij, the normalised XIJ, dot, Fij, the signal speeds, the MAX,
#: alpha1, the pressure terms, v.DWI, the conduction and del2e: 119
#: beside its three shapes, and the viscosity's 17 on a pair with dot <= 0;
#: ADKE's density (AdkeDensity): hij, its h1 and fac, q, WIJ, the
#: gradient's factor at hi and DWI, v.DWI, the two sums: 25 beside its two
#: shapes; ADKE's accelerations (AdkeAccel): cij, eij, hij, EPS, rhoij and
#: its inverse, r2, Hij, vij, x.v, muij, tmpv, the h1 and fac of hij, the
#: gradient's factor and DWIJ, the three sums, v.DWIJ, x.DWIJ and ae: 70
#: beside its shape, and the viscosity's 6 on a pair with x.v < 0; the
#: terms of one particle alone, once each: a source's pj / rhoj^2 (2) and
#: Hj = g1 hj csj + g2 hj^2 (|divj| - divj) (8), counted on the sources
#: with a pair, and the dest's Hi (8) a source array, on the dests with a
#: pair (csrc/adke_pair.cu's adke_terms_kernel and AdkeAccel::source)
GASD_PAIR_FLOPS = 11
GASD_SET_FLOPS = {gd.SDEN: 35, gd.MPM: 119, gd.ADEN: 25, gd.ADKE: 70}
GASD_SHAPES = {gd.SDEN: 1, gd.MPM: 3, gd.ADEN: 2, gd.ADKE: 1}
GASD_VISC_FLOPS = 17
ADKE_VISC_FLOPS = 6
ADKE_SOURCE_FLOPS = 10
ADKE_DEST_FLOPS = 8
#: ADKE's sets' minimum image on a periodic axis, a candidate and a pair:
#: d - L s, with L s known from the stencil range's wrap s (csrc/
#: adke_pair.cu; the division that it keeps for a particle past the box's
#: end since its binning is not work the function needs)
ADKE_IMAGE_FLOPS = 1
#: gsph_pair.cu, beside pair_of (GASD_PAIR_FLOPS): the gradients' factor
#: at hi and DWI, 1 / rhoj, the four differences and the 12 sums: 41
#: beside the shape; the accelerations' e_ij, sij, vl, vr, the two grho
#: and p projections, the two velocity projections (vsi, vsj), hij, EPS,
#: rhoij, the limiter (I02 first-order or IwIn counted as I02's 8), the
#: interpolation (linear's 16), the reconstruction (fl fr and the six
#: states with their floors), v*, the h1 and fac of hj, the two gradients'
#: factors, DWI DWJ and the four sums: 176 beside its two shapes; the
#: conduction's Hi, Hj, Hij, the gradient at hij and x.DWIJ: 30 and a
#: shape more
GSPH_SET_FLOPS = {gs.GRAD: 41, gs.ACC: 176}
GSPH_SHAPES = {gs.GRAD: 1, gs.ACC: 2}
GSPH_CONDUCTION_FLOPS = 30
#: the Riemann solvers (csrc/riemann.cuh), per pair: the flops beside the
#: Newton trips, and those of a trip (van Leer: wl, wr, zl, zr, u*l, u*r,
#: p* and its floor; exact: two pressure functions and the step, each
#: function counted at its cheaper branch, the shock's 12, so that the
#: bound stays a least time whatever branch a pair takes); a pow, like an
#: exp, counts one
RIEMANN_FLOPS = {0: 4, 1: 28, 2: 62, 3: 62, 4: 72, 5: 46, 6: 24, 7: 26,
                 8: 40, 9: 56, 10: 38}
RIEMANN_TRIP_FLOPS = {1: 42, 2: 30}
#: crksph_pair.cu, per pair in support beside pair_of (GASD_PAIR_FLOPS)
#: and its shapes (CRKSPH_SHAPES), by dimension (2, 3): a shape's q, W and
#: the gradient's factor (kernel_at, 6) and, at a smoothing length other
#: than the dest's, its h1 and fac (AtH::set, 5 in 2D, 6 in 3D; HIJ 2
#: more); NumDen: its sum (7); Moments: hij, V_j^-1, DW, the count, V W
#: and the sums of m0, m1, m2 (once for a <= b: 3 each), gm0, gm1 (5 each)
#: and gm2 (9 each, a <= b): 111, 259; Density: hij, B.x, the pair
#: factor, V_j^-1 and the two sums: 26, 27; GradV: DWI, the dest's
#: corrected gradient (corrected<1>: 2 DIM + DIM (2 DIM + 8)), V_j^-1,
#: vij and the DIM^2 sums (4 each): 56, 97; the momentum set: WI DWI at
#: hi and WJ DWJ at hj, both sides' corrected gradients and DWIJ
#: (Symmetric::dwij_of: 82, 126), the limiter, Q_i, Q_j and the factor
#: (Symmetric::fac_of: 108, 158) and its three sums (9): 199, 293, and
#: LaminarViscosity's 28 more (CRKSPH_VISC_FLOPS); the energy set: dwij_of,
#: fac_of, vij of u0, the DIM terms of aeij (6 each), sj (a pow and a
#: division), the entropy split and its sum (15): 220, 320
CRKSPH_SET_FLOPS = {
    2: {cp.NDEN: 7, cp.MOMS: 111, cp.RHO: 26, cp.GRADV: 56, cp.MOM: 199,
        cp.ENERGY: 220},
    3: {cp.NDEN: 7, cp.MOMS: 259, cp.RHO: 27, cp.GRADV: 97, cp.MOM: 293,
        cp.ENERGY: 320}}
CRKSPH_SHAPES = {cp.NDEN: 1, cp.MOMS: 1, cp.RHO: 1, cp.GRADV: 1, cp.MOM: 2,
                 cp.ENERGY: 2}
CRKSPH_VISC_FLOPS = 28
#: tsph_pair.cu, per pair in support beside pair_of (GASD_PAIR_FLOPS) and
#: its shapes (TSPH_SHAPES): Density: q, WI, the gradient's factor (a
#: compare and three products), v.DWI with DWI (11), GHI (6), fij (3)
#: and the six sums (9): 36; Gradient: q and the gradient's factor (5),
#: vij (3), -m_j, and per entry of the DIM x DIM block the DWI component
#: and the two sums (7 each): 9 + 7 DIM^2; Momentum: the source's h1 and
#: fac (5), q and the factor at both h (10), DWI DWJ (6), vij (3), cij
#: (2), hij (3), v.x (5), fij and fji (6), comi comj (4), the four sums
#: (19): 63, and the viscosity's 34 on a pair with v.x <= 0 (rhoij and
#: its inverse, alpha, muij, the factor, avi and the four sums); the
#: terms of one particle alone: a source's plane-3 rewrite (7,
#: tsph_terms_kernel, every source particle) and the dest's (Density 5,
#: Momentum 7) once a dest; the sweep's post_loop a dest (ni, dndhi,
#: func, dfdh, the clipped Newton step, diff, the test, ah: 20)
TSPH_SET_FLOPS = {ts.SDEN: 36, ts.MOM: 63}
TSPH_SHAPES = {ts.SDEN: 1, ts.GRADV: 1, ts.MOM: 2}
TSPH_VISC_FLOPS = 34
TSPH_SOURCE_FLOPS = 7
TSPH_DEST_FLOPS = {ts.SDEN: 5, ts.GRADV: 0, ts.MOM: 7}
TSPH_POST_FLOPS = 20


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
    grid).  ``walks=False``: a call that reads a linked density call's
    neighbour list (the momentum call, and ``EDACScheme``'s mean
    pressure), whose candidates' support tests that walk made and are
    not counted again."""
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
        if ts.terms & ~(tp.SDEN | tp.AVGP):
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


def iisph_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
               dt=0.0, walks=True):
    """Work of one ``iisph_pair`` call (the stencil wrapped on a periodic
    grid).  ``walks=False``: a call that reads a linked call's neighbour
    list, whose candidates' support tests that walk made and are not
    counted again."""
    terms = 0
    work = dict(candidates=0, visited=0, pairs=0, flops=0, bytes=0)
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    for src, cells, ts in sources:
        terms |= ts.terms
        cand, reached, ncells = stencil(grid, dest_cells, cells)
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        per_pair = TVF_PAIR_FLOPS + image + shape + sum(
            f for t, f in IISPH_TERM_FLOPS.items() if ts.terms & t)
        if walks:
            work['candidates'] += cand
            work['visited'] += cand
            work['flops'] += cand * (SUPPORT_FLOPS + image)
        work['pairs'] += pairs
        work['flops'] += pairs * per_pair
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       ip._reads(ts.terms, 1))
    work['bytes'] += _dest_bytes(dest, write_mask, pre, ip._reads(terms, 0))
    return work


def fitted_cells(grid, dest, dest_cells, sources):
    """(a grid, the dest's and each source's cells on it) for counting a
    gas call's support tests: a periodic grid keeps the cells it was
    sized for, the largest h that a binning met (GSPH's evaluation
    doubles h before its density), so there a copy whose periodic cells
    fit the call's own hmax (``cell_slack`` times its support, as an
    open grid's binning sizes them) and the arrays binned on it afresh
    (``CellGrid.bin``); elsewhere the call's own."""
    if not grid.is_periodic:
        return grid, dest_cells, [c for _, c, _ in sources]
    states = [dest] + [src for src, _, _ in sources]
    hmax = max(float(st['h'].max()) for st in states if st['h'].numel())
    width = grid.cell_slack * grid.radius_scale * hmax
    fit = CellGrid(grid.dim, grid.radius_scale, grid.dims, grid.cell_slack,
                   grid.domain)
    fit._set_dims(fit.sized_dims(grid.dims, width))
    x = dest['x']
    lo = torch.stack([torch.stack([st[c].min() for c in 'xyz'])
                      for st in states if st['x'].numel()]).min(0).values
    w = torch.tensor(width, dtype=x.dtype, device=x.device)
    origin = fit.origin(lo)
    cells = [fit.bin(st, origin, w) for st in states]
    return fit, cells[0], cells[1:]


def _gas_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              reads, paired, image_flops=IMAGE_FLOPS):
    """The shared count of ``gasd_work`` and ``gsph_work``: each
    source's pairs in support and ``paired(i, j, src, source)``, their
    flops, the support tests of the candidates and the bytes on
    ``fitted_cells`` (``candidates``, ``flops``, ``bytes``), and the
    candidates of the call's own cells beside them (``walk_candidates``:
    the tests more than those that a periodic grid sized for a larger h
    makes the walk take, time lost, not work the call needs).  Where each
    binning has periodic counts fitted to its own h (the binnings of a
    run whose equations write h: ``base/cell_grid.py``; GSPH's path), a
    call on its binning's cells (``time_walks.plan_calls``) has
    ``walk_candidates`` equal to ``candidates`` where the binning was
    sized for the call's own h (as after an initial evaluation), and a
    few percent more where it was sized for the widest h of the steps
    before (the accuracy test at 256^2 after its first chunk: 4.26 and
    4.03 a pair against 4.03 and 3.90); ``pair_flops`` leaves out the
    support tests: the work of the pairs alone; a support test's minimum
    image costs ``image_flops`` a periodic axis."""
    terms = 0
    work = dict(candidates=0, walk_candidates=0, visited=0, pairs=0,
                flops=0, pair_flops=0, bytes=0)
    image = image_flops * sum(grid.periodic)
    n = dest['x'].shape[0]
    fit, fit_dest, fit_src = fitted_cells(grid, dest, dest_cells, sources)
    for (src, cells, s), fcells in zip(sources, fit_src):
        terms |= s.terms
        walked = stencil(grid, dest_cells, cells)[0]
        cand, reached, ncells = stencil(fit, fit_dest, fcells)
        i, j = grid.neighbor_pairs(dest, dest_cells, src, cells, (0, n))
        flops = paired(i, j, src, s)
        work['candidates'] += cand
        work['walk_candidates'] += walked
        work['visited'] += walked
        work['pairs'] += int(i.numel())
        work['pair_flops'] += flops
        work['flops'] += cand * (SUPPORT_FLOPS + image) + flops
        work['bytes'] += _source_bytes(src, reached, ncells,
                                       reads(s.terms, 1))
    work['bytes'] += _dest_bytes(dest, write_mask, pre, reads(terms, 0))
    return work


def gasd_work(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Work of one ``gasd_pair`` call (``_gas_work``; the stencil wrapped
    on a periodic grid): the momentum sets' viscosity counted on the
    pairs that approach (``dot <= 0`` under MPM, ``dot < 0`` under ADKE:
    ``v_ij . x_ij``) in this call's data; ADKE's terms of one particle
    alone once a source and a dest with a pair, and its minimum image at
    ``ADKE_IMAGE_FLOPS`` an axis."""
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    adke = any(s.terms & (gd.ADEN | gd.ADKE) for _, _, s in sources)
    axis = ADKE_IMAGE_FLOPS if adke else IMAGE_FLOPS
    image = axis * sum(grid.periodic)

    def paired(i, j, src, s):
        flops = i.numel() * (GASD_PAIR_FLOPS + image + GASD_SET_FLOPS[
            s.terms] + GASD_SHAPES[s.terms] * shape)
        if s.terms & gd.ADKE:
            flops += ADKE_SOURCE_FLOPS * int(torch.unique(j).numel()) + \
                ADKE_DEST_FLOPS * int(torch.unique(i).numel())
        if s.terms & (gd.MPM | gd.ADKE):
            dot = sum(
                (dest[v][i] - src[v][j]) * grid.image(d, dest[c][i] -
                                                      src[c][j])
                for d, (c, v) in enumerate(zip('xyz', 'uvw')))
            flops += int((dot <= 0).sum()) * GASD_VISC_FLOPS \
                if s.terms & gd.MPM else \
                int((dot < 0).sum()) * ADKE_VISC_FLOPS
        return flops

    return _gas_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel, gd._reads, paired, axis)


def crksph_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                mode='walk'):
    """Work of one ``crksph_pair`` call (``_gas_work``; the stencil
    wrapped on a periodic grid): ``CRKSPH_SET_FLOPS`` and its shapes a
    pair in support, ``LaminarViscosity``'s where the set has it; the
    bytes of the dest's strided props (``crksph_pair.DEST_STRIDED``) and
    of each strided output's every column beside the props of stride 1.
    ``mode``: ``'walk'``, each candidate's support test (every call
    walking); ``'emit'``, the walk and its list written (an entry a
    pair up to the capacity, a count a dest); ``'read'``, a call on the
    list, its pairs alone (no support test) and their entries read."""
    dim = kernel.dim
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    sets = cp.sets_of(dim)

    def paired(i, j, src, s):
        base = s.terms & ~cp.VISC
        per = GASD_PAIR_FLOPS + image + CRKSPH_SET_FLOPS[dim][base] + \
            CRKSPH_SHAPES[base] * shape
        if s.terms & cp.VISC:
            per += CRKSPH_VISC_FLOPS
        return i.numel() * per

    work = _gas_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel, sets.reads, paired)
    x = dest['x']
    n, es = x.shape[0], x.element_size()
    terms = sources[0][2].terms
    work['bytes'] += n * es * (
        sum(cp.WIDTH[p] for p in cp.DEST_STRIDED.get(terms, ())) +
        2 * sum(cp.WIDTH.get(p, 1) - 1 for p in pre))
    if mode == 'emit':
        work['bytes'] += I32 * (min(work['pairs'], n * cp.CAPACITY[dim]) + n)
    elif mode == 'read':
        work['flops'] = work['pair_flops']
        work['candidates'] = work['walk_candidates'] = work['visited'] = 0
        work['bytes'] += I32 * (work['pairs'] + n)
    return work


def crksph_path_work(calls):
    """Work of a step's ``crksph_pair`` calls as the path runs them
    (``time_walks.plan_calls``' calls of both evaluators): the first
    evaluator's linked chain emitting and reading, the other calls
    walking."""
    def mode(plan):
        if plan.link is None:
            return 'walk'
        return 'emit' if plan is plan.link.emitter else 'read'
    return add(*[crksph_work(*args, mode=mode(plan))
                 for _, _, plan, args in calls])


#: crk_solve.cu a particle, by D: the determinant twice (D 2: 3 each; 3:
#: 14), the inverse (6; 36), c and c.m1 (4 D^2), A (2), grad A (D (9 D^2
#: + 3)), B (D) and grad B (D^2 (3 D + 3))
CRK_SOLVE_FLOPS = {1: 20, 2: 162, 3: 588}


def crk_solve_work(n, dim, element_size):
    """Work of one ``crk_solve`` launch on ``n`` particles: the moments
    read (m0, m1, m2, gm0, gm1, gm2, nnbr: 2 + 2 D + 2 D^2 + D^3 values)
    and A, grad A, B, grad B written (1 + 2 D + D^2) once each."""
    d = dim
    values = (2 + 2 * d + 2 * d * d + d ** 3) + (1 + 2 * d + d * d)
    return dict(flops=n * CRK_SOLVE_FLOPS[d], pair_flops=0,
                bytes=n * element_size * values, candidates=0,
                walk_candidates=0, visited=0, pairs=0)


def riemann_flops(params):
    """The flops of one pair's Riemann solve(s) under ``GsphParams``:
    the solver with its ``niter`` trips, and HLLSY's where ``hybrid``."""
    flops = RIEMANN_FLOPS[params.rsolver] + params.niter * \
        RIEMANN_TRIP_FLOPS.get(params.rsolver, 0)
    return flops + (RIEMANN_FLOPS[10] + 6 if params.hybrid else 0)


def gsph_work(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              t=0.0, dt=0.0):
    """Work of one ``gsph_pair`` call (``_gas_work``; the stencil wrapped
    on a periodic grid): the accelerations' Riemann solver with its
    Newton trips (``riemann_flops``) and the conduction where it is
    on."""
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)

    def paired(i, j, src, s):
        per = GASD_PAIR_FLOPS + image + GSPH_SET_FLOPS[s.terms] + \
            GSPH_SHAPES[s.terms] * shape
        if s.terms & gs.ACC:
            per += riemann_flops(s.params)
            if not (s.params.g1 == 0 and s.params.g2 == 0):
                per += GSPH_CONDUCTION_FLOPS + shape
        return i.numel() * per

    return _gas_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel, gs._reads, paired)


#: gasd_pair.cu's sweep a dest beside the density sums: post_loop (rhoi 4,
#: dhdrhoi 3, omega 3, the Newton step 6, the clamp 4, diff 3, arho and ah
#: 2, div 2)
GASD_POST_FLOPS = 27


def gasd_sweep_work(dest, dest_cells, write_mask, sources, grid, kernel):
    """Work of one ``gasd_sweep`` call: the density set's walk
    (``gasd_work``), its post_loop a dest, its props read and written in
    place (the 11 outputs, m and h0) and its neighbour list written (an
    entry a pair up to the capacity, a count a dest)."""
    pre = {p: dest[p] for p in gd.TERM_OUTPUTS[gd.SDEN]}
    work = gasd_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel)
    n = dest['x'].shape[0]
    es = dest['x'].element_size()
    work['flops'] += n * GASD_POST_FLOPS
    work['pair_flops'] += n * GASD_POST_FLOPS
    work['bytes'] += n * es * (2 * len(gd.SWEEP_OUTPUTS) + 2 - 2 * 6) + \
        4 * (min(work['pairs'], n * 64) + n)
    return work


def gasd_linked_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel):
    """Work of the momentum ``gasd_pair`` call on a density sweep's list:
    its pairs alone (no candidate's support test) and their list entries
    read beside its walk's bytes."""
    work = gasd_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel)
    work['flops'] = work['pair_flops']
    work['visited'] = 0
    work['bytes'] += 4 * (work['pairs'] + dest['x'].shape[0])
    return work


def gsph_linked_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel, t=0.0, dt=0.0):
    """Work of the acceleration ``gsph_pair`` call on its gradients
    call's list: its pairs alone (no candidate's support test) and their
    list entries read beside its walk's bytes."""
    work = gsph_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel)
    work['flops'] = work['pair_flops']
    work['visited'] = 0
    work['bytes'] += 4 * (work['pairs'] + dest['x'].shape[0])
    return work


def _tsph_set_flops(terms, dim):
    return 9 + 7 * dim * dim if terms == ts.GRADV else TSPH_SET_FLOPS[terms]


def tsph_work(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Work of one ``tsph_pair`` call (``_gas_work``; the stencil wrapped
    on a periodic grid): the momentum set's viscosity counted on the
    pairs that approach (``v_ij . x_ij <= 0``) in this call's data, its
    per-source terms once a source particle, each set's dest terms once a
    dest; the strided outputs ``invtt`` and ``gradv`` at 9 values a
    particle."""
    shape = SHAPE_FLOPS[kernel_kind(kernel)]
    image = IMAGE_FLOPS * sum(grid.periodic)
    dim = kernel.dim

    def paired(i, j, src, s):
        flops = i.numel() * (GASD_PAIR_FLOPS + image + _tsph_set_flops(
            s.terms, dim) + TSPH_SHAPES[s.terms] * shape)
        if s.terms & ts.MOM:
            dot = sum(
                (dest[v][i] - src[v][j]) * grid.image(d, dest[c][i] -
                                                      src[c][j])
                for d, (c, v) in enumerate(zip('xyz', 'uvw')))
            flops += int((dot <= 0).sum()) * TSPH_VISC_FLOPS + \
                TSPH_SOURCE_FLOPS * src['x'].shape[0]
        return flops

    work = _gas_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel, ts._reads, paired)
    n, es = dest['x'].shape[0], dest['x'].element_size()
    terms = sources[0][2].terms
    work['flops'] += n * TSPH_DEST_FLOPS[terms]
    work['pair_flops'] += n * TSPH_DEST_FLOPS[terms]
    # the strided pre values and outputs: 9 values, not 1
    work['bytes'] += n * es * 2 * 8 * sum(p in ts.WIDTH for p in pre)
    return work


def tsph_sweep_work(dest, dest_cells, write_mask, sources, grid, kernel):
    """Work of one ``tsph_sweep`` call: the density set's walk
    (``tsph_work``), its post_loop a dest, its props read and written in
    place (the 12 outputs, h0) and its neighbour list written (an entry a
    pair up to the capacity, a count a dest)."""
    pre = {p: dest[p] for p in ts.TERM_OUTPUTS[ts.SDEN]}
    work = tsph_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel)
    n = dest['x'].shape[0]
    es = dest['x'].element_size()
    work['flops'] += n * TSPH_POST_FLOPS
    work['pair_flops'] += n * TSPH_POST_FLOPS
    work['bytes'] += n * es * (2 * len(ts.SWEEP_OUTPUTS) + 1 - 2 * 6) + \
        4 * (min(work['pairs'], n * ts.CAPACITY[kernel.dim]) + n)
    return work


def tsph_linked_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel):
    """Work of a velocity gradient or momentum ``tsph_pair`` call on a
    density sweep's list: its pairs alone (no candidate's support test)
    and their list entries read beside its walk's bytes."""
    work = tsph_work(dest, dest_cells, write_mask, pre, sources, grid,
                     kernel)
    work['flops'] = work['pair_flops']
    work['visited'] = 0
    work['bytes'] += 4 * (work['pairs'] + dest['x'].shape[0])
    return work


#: iisph_solve.cu a dest and sweep beside the pair sums: post_loop (tmp 3,
#: dnr 1, the guard 2, the relaxed update 5, the clamp 1, the compression
#: 5) and reduce's count and sum (2)
SOLVE_DEST_FLOPS = 19


def iisph_solve_work(dest, dest_cells, write_mask, dijpj, solve, grid,
                     kernel, dt, spec, handoff=None, active=None, log=None,
                     sweeps=1):
    """Work of one ``iisph_solve`` call of ``sweeps`` sweeps (its
    arguments, ``ops/iisph_solve.py``): each sweep's two passes over the
    neighbour list, ComputeDIJPJ and PressureSolve, as ``iisph_work``
    counts a call that reads a list (no candidate test), and post_loop
    and reduce a dest; the bytes once: each source's records and the
    list's entries read, the dest's inputs read and its outputs written
    (a sweep reads them again from L2)."""
    pre = {p: dest[p] for p in ('dijpj0', 'dijpj1', 'dijpj2')}
    work = add(iisph_work(dest, dest_cells, write_mask, pre, dijpj, grid,
                          kernel, dt, walks=False),
               iisph_work(dest, dest_cells, write_mask, {'p': dest['p']},
                          solve, grid, kernel, dt, walks=False))
    x = dest['x']
    n, es = x.shape[0], x.element_size()
    work['pairs'] *= sweeps
    work['flops'] = sweeps * (work['flops'] + n * SOLVE_DEST_FLOPS)
    terms = {ts.name: ts.terms for _, _, ts in dijpj}
    for _, _, ts in solve:
        terms[ts.name] = terms.get(ts.name, 0) | ts.terms
    work['bytes'] = 0
    for src, cells, ts in solve:
        _, reached, ncells = stencil(grid, dest_cells, cells)
        pairs = support_pairs(grid, dest, dest_cells, src, cells)
        work['bytes'] += _source_bytes(src, reached, ncells, ip._reads(
            terms[ts.name], 1)) + pairs * I32
    reads = ip._reads(ip.DIJPJ | ip.PSOLVE, 0) | {'aii', 'rho_adv'}
    outputs = ('p', 'piter', 'compression', 'dijpj0', 'dijpj1', 'dijpj2')
    work['bytes'] += n * (es * (len(reads) + len(outputs)) + I32) + (
        0 if write_mask is None else n)
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
