// The cell walk shared by every pair kernel (csrc/wcsph_pair.cu,
// csrc/dense_pair.cu, csrc/pair_stub.cu, csrc/gtvf_pair.cu and
// csrc/fused_pair.cu): the records of a packed source copy
// (csrc/cell_pack.cuh), the support test, row spans of the copy, a lane's
// cell, and the walker that tests every candidate and hands those in
// support to the pair body in batches.  It defines no kernel's arguments:
// a kernel hands it its own argument struct for the grid's cell counts
// (any struct with members nx, ny, nz), a source's cell ranges and the
// plane of its {x, y, z, h} records.
//
// Row spans.  CellGrid numbers cells ix + nx * (iy + ny * iz), so the
// x-adjacent cells xa..xb of one (y, z) row have consecutive ids and their
// particles are the one range [start[xa], end[xb]) of the source's packed
// copy.  A walk of the 3^dim stencil reads 3^(dim-1) such ranges.
//
// Lanes (wcsph_pair, pair_stub, gtvf_pair, fused_pair).  Threads follow
// the dest's sorted order, so the 32 lanes of a warp hold dests of one or
// a few nearby cells, and the lanes of one cell load the same records at
// the same steps.  Each lane walks the span of its own cells cx - 1 .. cx
// + 1 in every stencil row: exactly the candidates of the 3^dim stencil,
// in the order of the plain stencil walk: row (oz, oy), x ascending, then
// position.  (Lanes of up to four adjacent cells walking the union span
// of their cells, so that more lanes share each load, were measured
// slower on the paths: the extra candidates cost more than the shared
// loads save.)
//
// Periodic walks (walk_rows_periodic, for a kernel that takes a periodic
// grid; the kernels built without it keep the walk above and its code).
// On a periodic axis the stencil row wraps with the cell counts, and
// shrinks to -1..0 on an axis of two cells and 0 on one of one cell
// (CellGrid.axis_offsets), so no cell is visited twice.  A wrapped y or
// z row is one range as before; a row span cx - 1 .. cx + 1 that crosses
// the grid's end on a periodic x axis is two ranges of the packed copy,
// its cells before the end then those from cell 0, which the warp walks
// as a second range only where one of its lanes has one (the x edges).
// The order stays the plain stencil walk's (x by stencil offset, then
// position), so a lane sums its pairs as neighbor_pairs lists them.  The
// support test takes the minimum image of each periodic displacement,
// d - L rint(d / L), with the box lengths of the kernel's arguments.
//
// The walker.  Every lane of a warp runs the same number of steps (the
// warp's longest span), so the votes see all 32 lanes.  A lane tests its
// candidates, kBatch loads in flight, and keeps those in support as bits
// of windows of 32 positions.  The last kWindows windows stay in
// registers; a new window first hands the oldest to the body, which then
// runs once per lane per round, each lane taking its oldest candidate,
// for as many rounds as the busiest lane holds in that window.  A lane
// with few pairs there takes the next window's meanwhile, so the body
// runs with most lanes busy instead of once for every candidate that
// some lane of the warp holds in support.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
// windows of 32 positions a lane holds before the body must take some
constexpr int kWindows = 4;
// record loads a lane has in flight while it tests candidates
constexpr int kBatch = 4;

// One record of four values of a packed source.
template <typename T>
struct Rec {
  T a, b, c, d;
};

// Record k of a packed plane: one 16-byte load in float, two in double.
__device__ __forceinline__ Rec<float> rec(const float* p, int k) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Rec<double> rec(const double* p, int k) {
  const double2* q = reinterpret_cast<const double2*>(p) + 2 * k;
  const double2 lo = __ldg(q), hi = __ldg(q + 1);
  return {lo.x, lo.y, hi.x, hi.y};
}
template <typename T>
__device__ __forceinline__ Rec<T> rec(const void* p, int k) {
  return rec(static_cast<const T*>(p), k);
}

// The support test of every walk, r2 < (rs max(hi, hj))^2, of a dest's
// {xi, yi, zi, hi} against a candidate's {x, y, z, h} record.
template <typename T>
__device__ __forceinline__ bool in_support(const Rec<T>& di,
                                           const Rec<T>& pj, T rs) {
  const T xij = di.a - pj.a;
  const T yij = di.b - pj.b;
  const T zij = di.c - pj.c;
  const T r2 = xij * xij + yij * yij + zij * zij;
  const T sup = rs * (di.d > pj.d ? di.d : pj.d);
  return r2 < sup * sup;
}

// The box of a periodic walk: the length of each periodic axis, 0 on
// the others.
template <typename T>
struct Box {
  T len[3];
};

// The minimum image of a displacement d along an axis of length L (0:
// not periodic): d - L round(d / L), round half to even as torch.round.
__device__ __forceinline__ float image(float d, float L) {
  return L != 0.0f ? d - L * rintf(d / L) : d;
}
__device__ __forceinline__ double image(double d, double L) {
  return L != 0.0 ? d - L * rint(d / L) : d;
}

// The support test of a periodic walk: in_support on the minimum image.
template <typename T>
__device__ __forceinline__ bool in_support(const Rec<T>& di,
                                           const Rec<T>& pj, T rs,
                                           const Box<T>& box) {
  const T xij = image(di.a - pj.a, box.len[0]);
  const T yij = image(di.b - pj.b, box.len[1]);
  const T zij = image(di.c - pj.c, box.len[2]);
  const T r2 = xij * xij + yij * yij + zij * zij;
  const T sup = rs * (di.d > pj.d ? di.d : pj.d);
  return r2 < sup * sup;
}

// Positions [k0, k1) of a source's packed copy.
struct Span {
  int k0, k1;
};

// The particles of cells xa..xb (clipped to the grid of g's nx, ny, nz)
// of row (y, z) of a source whose cells hold [start[c], end[c]); empty
// where the row lies outside the grid.
template <class G>
__device__ __forceinline__ Span row_span(const G& g, const int32_t* start,
                                         const int32_t* end, int xa, int xb,
                                         int y, int z) {
  if (y < 0 || y >= g.ny || z < 0 || z >= g.nz) return {0, 0};
  const int row = g.nx * (y + g.ny * z);
  return {start[row + max(xa, 0)], end[row + min(xb, g.nx - 1)]};
}

// One lane's candidates in support not yet handed to the body: window w
// holds bits[w] over positions base[w] + 0..31, oldest first.  Every lane
// of the warp must call walk and finish together.
template <typename T>
struct Walker {
  unsigned bits[kWindows];
  int base[kWindows];

  __device__ void begin() {
#pragma unroll
    for (int w = 0; w < kWindows; ++w) bits[w] = base[w] = 0;
  }

  // One round: each lane hands its oldest held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void round(Body& body) {
    int k = -1;
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      if (k < 0 && bits[w] != 0) {
        k = base[w] + __ffs(bits[w]) - 1;
        bits[w] &= bits[w] - 1;
      }
    }
    if (k >= 0) body(k);
  }

  // Test this lane's positions [k0, k0 + n) against the dest's {xi, yi,
  // zi, hi} di: pos(k) is candidate k's {x, y, z, h} record.
  template <class Pos, class Body>
  __device__ __forceinline__ void walk(int k0, int n, const Rec<T>& di,
                                       T rs, Pos& pos, Body& body) {
    auto test = [&](const Rec<T>& r) { return in_support(di, r, rs); };
    walk_test(k0, n, test, pos, body);
  }

  // walk with the caller's support test, test(record).
  template <class Test, class Pos, class Body>
  __device__ __forceinline__ void walk_test(int k0, int n, Test& test,
                                            Pos& pos, Body& body) {
    const int trip = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(max(n, 0))));
    for (int t0 = 0; t0 < trip; t0 += 32) {
      const int m = min(32, n - t0);  // this lane's steps in the window
      unsigned found = 0;
      for (int b = 0; b < m; b += kBatch) {
        Rec<T> r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          r[u] = pos(k0 + t0 + min(b + u, m - 1));
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b + u < m && test(r[u])) found |= 1u << (b + u);
      }
      if (!__any_sync(kFull, found != 0)) continue;
      while (__any_sync(kFull, bits[0] != 0)) round(body);
#pragma unroll
      for (int w = 0; w + 1 < kWindows; ++w) {
        bits[w] = bits[w + 1];
        base[w] = base[w + 1];
      }
      bits[kWindows - 1] = found;
      base[kWindows - 1] = k0 + t0;
    }
  }

  // Hand every held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void finish(Body& body) {
    for (;;) {
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < kWindows; ++w) any |= bits[w];
      if (!__any_sync(kFull, any != 0)) return;
      round(body);
    }
  }
};

// A lane's cell: its x cell and row.  A lane that walks nothing (past the
// end of the dest array, or a dest that takes no pair) is not active.
struct Lane {
  int cx, y, z;
  bool active;
};

template <class G>
__device__ __forceinline__ Lane lane_cell(const G& g, int cell,
                                          bool active) {
  const int row = cell / g.nx;
  return {cell % g.nx, row % g.ny, row / g.ny, active};
}

// One source's walk for a lane: each stencil row (oz, oy), in order,
// over the lane's x cell widened by `halo` on each side (1: the pair
// kernels' walk; 0: the lane's own cell, pair_stub's `third`), reading
// the {x, y, z, h} records from the plane `pos` of the source's packed
// copy, whose cells hold [start[c], end[c]).  The caller finishes the
// walker once the source's last row is walked.
template <typename T, class G, class Body>
__device__ __forceinline__ void walk_rows(const G& g,
                                          const int32_t* start,
                                          const int32_t* end,
                                          const void* pos, const Lane& l,
                                          int halo, const Rec<T>& di, T rs,
                                          Walker<T>& walker, Body& body) {
  auto load = [&](int k) { return rec<T>(pos, k); };
  const int ry = g.ny > 1, rz = g.nz > 1;
  for (int oz = -rz; oz <= rz; ++oz) {
    for (int oy = -ry; oy <= ry; ++oy) {
      Span sp{0, 0};
      if (l.active)
        sp = row_span(g, start, end, l.cx - halo, l.cx + halo, l.y + oy,
                      l.z + oz);
      walker.walk(sp.k0, sp.k1 - sp.k0, di, rs, load, body);
    }
  }
}

// The stencil offsets lo..hi of an axis of n cells (CellGrid.axis_offsets).
__device__ __forceinline__ void axis_offsets(int n, bool periodic, int& lo,
                                             int& hi) {
  lo = n > 1 ? -1 : 0;
  hi = n > 2 || (n == 2 && !periodic) ? 1 : 0;
}

// The two ranges of row (y, z) over the cells xa..xb on a periodic grid
// (box.len[d] != 0 on a periodic axis d): y and z wrap (or the row is
// empty outside the grid on an axis that is not periodic); on a periodic
// x axis the cells xa..xb wrap, and where they cross the grid's end the
// second range holds the cells from 0 (empty where they do not).
template <typename T, class G>
__device__ __forceinline__ void periodic_row(const G& g, const int32_t* start,
                                             const int32_t* end, int xa,
                                             int xb, int y, int z,
                                             const Box<T>& box, Span& first,
                                             Span& second) {
  first = second = Span{0, 0};
  if (box.len[1] != T(0))
    y = (y + g.ny) % g.ny;
  else if (y < 0 || y >= g.ny)
    return;
  if (box.len[2] != T(0))
    z = (z + g.nz) % g.nz;
  else if (z < 0 || z >= g.nz)
    return;
  const int row = g.nx * (y + g.ny * z);
  if (box.len[0] == T(0)) {
    first = {start[row + max(xa, 0)], end[row + min(xb, g.nx - 1)]};
  } else if (xa < 0) {
    first = {start[row + xa + g.nx], end[row + g.nx - 1]};
    second = {start[row], end[row + xb]};
  } else if (xb >= g.nx) {
    first = {start[row + xa], end[row + g.nx - 1]};
    second = {start[row], end[row + xb - g.nx]};
  } else {
    first = {start[row + xa], end[row + xb]};
  }
}

// walk_rows on a periodic grid (the lane's x cell widened by one on each
// side, as the pair kernels walk): each stencil row (oz, oy), in order,
// its first range, then its second where a lane of the warp has one.
template <typename T, class G, class Body>
__device__ __forceinline__ void walk_rows_periodic(
    const G& g, const int32_t* start, const int32_t* end, const void* pos,
    const Lane& l, const Rec<T>& di, T rs, const Box<T>& box,
    Walker<T>& walker, Body& body) {
  auto load = [&](int k) { return rec<T>(pos, k); };
  auto test = [&](const Rec<T>& r) { return in_support(di, r, rs, box); };
  int xlo, xhi, ylo, yhi, zlo, zhi;
  axis_offsets(g.nx, box.len[0] != T(0), xlo, xhi);
  axis_offsets(g.ny, box.len[1] != T(0), ylo, yhi);
  axis_offsets(g.nz, box.len[2] != T(0), zlo, zhi);
  for (int oz = zlo; oz <= zhi; ++oz) {
    for (int oy = ylo; oy <= yhi; ++oy) {
      Span first{0, 0}, second{0, 0};
      if (l.active)
        periodic_row(g, start, end, l.cx + xlo, l.cx + xhi, l.y + oy,
                     l.z + oz, box, first, second);
      walker.walk_test(first.k0, first.k1 - first.k0, test, load, body);
      if (__any_sync(kFull, second.k1 > second.k0))
        walker.walk_test(second.k0, second.k1 - second.k0, test, load, body);
    }
  }
}

}  // namespace walk
