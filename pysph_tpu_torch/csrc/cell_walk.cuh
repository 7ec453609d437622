// The cell walk shared by csrc/wcsph_pair.cu, csrc/dense_pair.cu and
// csrc/pair_stub.cu: row spans of the packed source copy, a lane's cell,
// and the walker that tests every candidate and hands those in support
// to the pair body in batches.
//
// Row spans.  CellGrid numbers cells ix + nx * (iy + ny * iz), so the
// x-adjacent cells xa..xb of one (y, z) row have consecutive ids and their
// particles are the one range [start[xa], end[xb]) of the source's packed
// copy.  A walk of the 3^dim stencil reads 3^(dim-1) such ranges.
//
// Lanes (wcsph_pair, pair_stub).  Threads follow the dest's sorted order,
// so the 32 lanes of a warp hold dests of one or a few nearby cells, and
// the lanes of one cell load the same records at the same steps.  Each
// lane walks the span of its own cells cx - 1 .. cx + 1 in every stencil
// row: exactly the candidates of the 3^dim stencil, in the order of the
// plain stencil walk: row (oz, oy), x ascending, then position.  (Lanes
// of up to four adjacent cells walking the union span of their cells, so
// that more lanes share each load, were measured slower on the paths:
// the extra candidates cost more than the shared loads save.)
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

#include "wcsph_terms.cuh"

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
// windows of 32 positions a lane holds before the body must take some
constexpr int kWindows = 4;
// record loads a lane has in flight while it tests candidates
constexpr int kBatch = 4;

// Positions [k0, k1) of a source's packed copy.
struct Span {
  int k0, k1;
};

// The particles of cells xa..xb (clipped to the grid) of row (y, z); empty
// where the row lies outside the grid.
__device__ __forceinline__ Span row_span(const WcsphArgs& a,
                                         const SrcArgs& S, int xa, int xb,
                                         int y, int z) {
  if (y < 0 || y >= a.ny || z < 0 || z >= a.nz) return {0, 0};
  const int row = a.nx * (y + a.ny * z);
  return {S.cell_start[row + max(xa, 0)],
          S.cell_end[row + min(xb, a.nx - 1)]};
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

  // Test this lane's positions [k0, k0 + n) against dest d: pos(k) is
  // candidate k's {x, y, z, h} record.
  template <class Pos, class Body>
  __device__ __forceinline__ void walk(int k0, int n,
                                       const wcsph::Dest<T>& d, T rs,
                                       Pos& pos, Body& body) {
    const int trip = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(max(n, 0))));
    for (int t0 = 0; t0 < trip; t0 += 32) {
      const int m = min(32, n - t0);  // this lane's steps in the window
      unsigned found = 0;
      for (int b = 0; b < m; b += kBatch) {
        wcsph::Rec<T> r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          r[u] = pos(k0 + t0 + min(b + u, m - 1));
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b + u < m && wcsph::in_support(d, r[u], rs))
            found |= 1u << (b + u);
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

// A lane's cell: its x cell and row.  Lanes past the end of the dest
// array walk nothing.
struct Lane {
  int cx, y, z;
  bool active;
};

__device__ __forceinline__ Lane lane_cell(const WcsphArgs& a, int cell,
                                          bool active) {
  const int row = cell / a.nx;
  return {cell % a.nx, row % a.ny, row / a.ny, active};
}

// One source's walk for a lane: each stencil row (oz, oy), in order,
// over the lane's x cell widened by `halo` on each side (1: the pair
// kernel's walk; 0: the lane's own cell, pair_stub's `third`), reading
// the {x, y, z, h} records from the packed copy.  The caller finishes the
// walker once the source's last row is walked.
template <typename T, class Body>
__device__ __forceinline__ void walk_rows(const WcsphArgs& a,
                                          const SrcArgs& S, const Lane& l,
                                          int halo, const wcsph::Dest<T>& d,
                                          T rs, Walker<T>& walker,
                                          Body& body) {
  auto pos = [&](int k) { return wcsph::rec<T>(S.pos, k); };
  const int ry = a.ny > 1, rz = a.nz > 1;
  for (int oz = -rz; oz <= rz; ++oz) {
    for (int oy = -ry; oy <= ry; ++oy) {
      Span sp{0, 0};
      if (l.active)
        sp = row_span(a, S, l.cx - halo, l.cx + halo, l.y + oy, l.z + oz);
      walker.walk(sp.k0, sp.k1 - sp.k0, d, rs, pos, body);
    }
  }
}

}  // namespace walk
