// A group of G lanes a dest: the walk shared by csrc/adke_pair.cu and
// csrc/crksph_pair.cu, over the cell-sorted packed sources of
// csrc/cell_pack.cuh and the row spans of csrc/cell_walk.cuh.
//
// Lanes.  A group of G lanes (1, 2, 4 or 8) takes a dest: thread t the
// dest at sorted position t / G as lane r = t mod G of its group, so a
// warp holds the 32 / G dests of one or two cells.  Every lane of a group
// walks the stencil ranges of the dest's cell (rows (oz, oy) of cells cx -
// 1 .. cx + 1, wrapped on a periodic grid as walk::walk_rows_periodic),
// taking positions k0 + r, k0 + r + G, ... of each range: a group's loads
// are G consecutive records, which the groups of one cell share.  Each
// lane holds its candidates in support as windows of 32 of its positions
// and hands them to the body in rounds (Walker, walk::Walker's rounds over
// a stride).  Each lane sums its own pairs; a butterfly of __shfl_xor_sync
// over log2 G steps adds the group's partial sums (sum: every lane ends
// with the same bits), so a launch gives the same bits every time.
//
// A walk may also list each dest's pairs in support in the walk's order
// (ops/pair_link.py neighbours_reference): the list hook takes each
// window's candidates of the whole group, as the lanes' found masks, and
// ranks them by position (position k0 + G t0 + q + G b of lane q's bit b).
//
// The support test is walk::in_support's arithmetic written as single
// IEEE operations (__fmul_rn and its kin), so that the pairs and each
// dest's count are exactly the plain version's whatever the contraction
// of the library that includes this header.
//
// The periodic image.  On a periodic axis of length L the minimum image is
// d - L rint(d / L).  A stencil range's wrap s (-1, 0 or 1) is known from
// the range; where |d - L s| < L / 4, rint(d / L) is s (the rounding of
// d / L moves it by far less than 1 / 4), so d - L s has exactly the
// image's bits without the division; elsewhere (a particle past the box's
// end since its binning, or a grid of few cells) the division.  The body
// gets the range's wrap with each candidate (a tag of its window).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_walk.cuh"

namespace group {

using walk::kFull;
using walk::Rec;

// single IEEE operations, rounded once whatever the contraction
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rint_of(float a) { return rintf(a); }
__device__ __forceinline__ double rint_of(double a) { return rint(a); }

// The minimum image of d on an axis of length L (0: not periodic), with
// the bits of walk::image; ls: L s for the range's wrap s (see the top).
template <typename T>
__device__ __forceinline__ T image_at(T d, T L, T ls) {
  if (L == T(0)) return d;
  const T t = sub_rn(d, ls);
  if (fabs(t) < T(0.25) * L) return t;
  return sub_rn(d, mul_rn(L, rint_of(div_rn(d, L))));
}

// A range's wraps s on the three axes as a tag: 2 bits an axis, s + 1.
__device__ __forceinline__ int wrap_tag(int sx, int sy, int sz) {
  return (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4;
}
template <typename T>
__device__ __forceinline__ T shift_of(int tag, int axis, T L) {
  return L * T(((tag >> (2 * axis)) & 3) - 1);
}

// walk::in_support (on the minimum image where periodic) in single IEEE
// operations: the plain version's pairs under any contraction.
template <typename T, bool PERIODIC>
__device__ __forceinline__ bool in_support_rn(const Rec<T>& di,
                                              const Rec<T>& pj, T rs,
                                              const walk::Box<T>& box,
                                              int tag) {
  T x = sub_rn(di.a, pj.a), y = sub_rn(di.b, pj.b), z = sub_rn(di.c, pj.c);
  if (PERIODIC) {
    x = image_at(x, box.len[0], shift_of(tag, 0, box.len[0]));
    y = image_at(y, box.len[1], shift_of(tag, 1, box.len[1]));
    z = image_at(z, box.len[2], shift_of(tag, 2, box.len[2]));
  }
  const T r2 = add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
  const T sup = mul_rn(rs, di.d > pj.d ? di.d : pj.d);
  return r2 < mul_rn(sup, sup);
}

// One pair in support at position k of a range of wrap tag: XIJ (the
// minimum image), RIJ, 1 / RIJ (0 at RIJ = 0) and the source's h, into a
// kernel's own pair record P (members k, xij, yij, zij, rij, rinv, hj).
template <class P, typename T, bool PERIODIC>
__device__ __forceinline__ P pair_at(const Rec<T>& di, const Rec<T>& pj,
                                     int k, int tag,
                                     const walk::Box<T>& box) {
  P q;
  q.k = k;
  q.xij = di.a - pj.a;
  q.yij = di.b - pj.b;
  q.zij = di.c - pj.c;
  if (PERIODIC) {
    q.xij = image_at(q.xij, box.len[0], shift_of(tag, 0, box.len[0]));
    q.yij = image_at(q.yij, box.len[1], shift_of(tag, 1, box.len[1]));
    q.zij = image_at(q.zij, box.len[2], shift_of(tag, 2, box.len[2]));
  }
  const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
  q.rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
  q.rij = r2 * q.rinv;
  q.hj = pj.d;
  return q;
}

// The group's sum of v: a butterfly over its G lanes, the same bits in
// each.
template <int G, typename T>
__device__ __forceinline__ T sum(T v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A walk that lists nothing.
struct NoList {
  __device__ __forceinline__ void operator()(unsigned, int) const {}
};

// A lane's candidates in support not yet handed to the body: window w
// holds bits[w] over its positions base[w] + G b, b = 0..31, of a range of
// wrap tag[w], oldest first; walk::Walker's rounds (see
// csrc/cell_walk.cuh) over a lane's share of each range.  Every lane of
// the warp must call walk and finish together.
template <typename T, int G>
struct Walker {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8,
                "a dest's group is 1, 2, 4 or 8 lanes");
  unsigned bits[walk::kWindows];
  int base[walk::kWindows];
  int tag[walk::kWindows];

  __device__ void begin() {
#pragma unroll
    for (int w = 0; w < walk::kWindows; ++w) bits[w] = base[w] = tag[w] = 0;
  }

  // One round: each lane hands its oldest held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void round(Body& body) {
    int k = -1, g = 0;
#pragma unroll
    for (int w = 0; w < walk::kWindows; ++w) {
      if (k < 0 && bits[w] != 0) {
        k = base[w] + G * (__ffs(bits[w]) - 1);
        g = tag[w];
        bits[w] &= bits[w] - 1;
      }
    }
    if (k >= 0) body(k, g);
  }

  // Test lane r's positions k0 + r + G j (j = 0, 1, ...) of the range
  // [k0, k0 + n) of wrap tag g: test(record) decides support, pos(k) is
  // candidate k's {x, y, z, h} record; list(found, k0 + G t0) sees each
  // window that some lane of the warp found a candidate in, in order.
  template <class Test, class Pos, class Body, class List>
  __device__ __forceinline__ void walk(int k0, int n, int r, int g,
                                       Test& test, Pos& pos, Body& body,
                                       List& list) {
    const int mine = n > r ? (n - r + G - 1) / G : 0;
    const int first = k0 + r;
    const int trip = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(mine)));
    for (int t0 = 0; t0 < trip; t0 += 32) {
      const int m = min(32, mine - t0);  // this lane's steps in the window
      unsigned found = 0;
      for (int b = 0; b < m; b += walk::kBatch) {
        Rec<T> q[walk::kBatch];
#pragma unroll
        for (int u = 0; u < walk::kBatch; ++u)
          q[u] = pos(first + G * (t0 + min(b + u, m - 1)));
#pragma unroll
        for (int u = 0; u < walk::kBatch; ++u)
          if (b + u < m && test(q[u])) found |= 1u << (b + u);
      }
      if (!__any_sync(kFull, found != 0)) continue;
      list(found, k0 + G * t0);
      while (__any_sync(kFull, bits[0] != 0)) round(body);
#pragma unroll
      for (int w = 0; w + 1 < walk::kWindows; ++w) {
        bits[w] = bits[w + 1];
        base[w] = base[w + 1];
        tag[w] = tag[w + 1];
      }
      bits[walk::kWindows - 1] = found;
      base[walk::kWindows - 1] = first + G * t0;
      tag[walk::kWindows - 1] = g;
    }
  }

  // Hand every held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void finish(Body& body) {
    for (;;) {
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < walk::kWindows; ++w) any |= bits[w];
      if (!__any_sync(kFull, any != 0)) return;
      round(body);
    }
  }
};

// The list of a group's window: each lane's found mask of the window at
// group position wbase (lane q's bit b: position wbase + q + G b), ranked
// by position among the group's candidates, entries listed + rank of the
// dest's list (nbr[c * n_dest + pos] for c < cap, source position base +
// k); returns the group's candidates in the window.  Every lane of the
// warp calls it together.
template <int G>
__device__ __forceinline__ int list_window(unsigned found, int wbase, int r,
                                           int listed, int base, int cap,
                                           int32_t* nbr, int n_dest,
                                           int pos) {
  const int lane = threadIdx.x & 31;
  unsigned f[G];
  int total = 0;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    f[q] = __shfl_sync(kFull, found, (lane & ~(G - 1)) + q);
    total += __popc(f[q]);
  }
  for (unsigned bits = found; bits != 0; bits &= bits - 1) {
    const int b = __ffs(bits) - 1;
    const unsigned below = (1u << b) - 1;
    int rank = 0;
#pragma unroll
    for (int q = 0; q < G; ++q)
      rank += __popc(f[q] & below) + (q < r ? (f[q] >> b) & 1 : 0);
    const int c = listed + rank;
    if (c < cap) nbr[size_t(c) * n_dest + pos] = base + wbase + r + G * b;
  }
  return total;
}

// One source's stencil ranges for lane r of the group of the dest di in
// the lane's cell l (the source's cells [start[c], end[c]) on the grid of
// g's nx, ny, nz; its {x, y, z, h} records in plane p0), each walked as
// Walker::walk with its wrap tag (0 on an open grid).  The caller finishes
// the walker after the source.
template <typename T, int G, bool PERIODIC, class Grid, class Body,
          class List>
__device__ __forceinline__ void walk_source(
    const Grid& a, const int32_t* start, const int32_t* end, const void* p0,
    const walk::Lane& l, int r, const Rec<T>& di, T rs,
    const walk::Box<T>& box, Walker<T, G>& walker, Body& body, List& list) {
  auto load = [&](int k) { return walk::rec<T>(p0, k); };
  if (!PERIODIC) {
    auto test = [&](const Rec<T>& q) {
      return in_support_rn<T, false>(di, q, rs, box, 0);
    };
    const int ry = a.ny > 1, rz = a.nz > 1;
    for (int oz = -rz; oz <= rz; ++oz) {
      for (int oy = -ry; oy <= ry; ++oy) {
        walk::Span sp{0, 0};
        if (l.active)
          sp = walk::row_span(a, start, end, l.cx - 1, l.cx + 1, l.y + oy,
                              l.z + oz);
        walker.walk(sp.k0, sp.k1 - sp.k0, r, 0, test, load, body, list);
      }
    }
    return;
  }
  int xlo, xhi, ylo, yhi, zlo, zhi;
  walk::axis_offsets(a.nx, box.len[0] != T(0), xlo, xhi);
  walk::axis_offsets(a.ny, box.len[1] != T(0), ylo, yhi);
  walk::axis_offsets(a.nz, box.len[2] != T(0), zlo, zhi);
  // a row y (or z) outside the grid is a wrapped one (on an axis that is
  // not periodic it is empty)
  auto wrap = [](int c, int n) { return c < 0 ? -1 : c >= n ? 1 : 0; };
  const int xa = l.cx + xlo, xb = l.cx + xhi;
  // the x wrap of the row's first range and of its second
  const int sx0 = box.len[0] != T(0) && xa < 0 ? -1 : 0;
  const int sx1 = xa < 0 ? 0 : 1;
  for (int oz = zlo; oz <= zhi; ++oz) {
    for (int oy = ylo; oy <= yhi; ++oy) {
      walk::Span first{0, 0}, second{0, 0};
      if (l.active)
        walk::periodic_row(a, start, end, xa, xb, l.y + oy, l.z + oz, box,
                           first, second);
      const int sy = wrap(l.y + oy, a.ny), sz = wrap(l.z + oz, a.nz);
      const int g0 = wrap_tag(sx0, sy, sz), g1 = wrap_tag(sx1, sy, sz);
      auto test0 = [&](const Rec<T>& q) {
        return in_support_rn<T, true>(di, q, rs, box, g0);
      };
      walker.walk(first.k0, first.k1 - first.k0, r, g0, test0, load, body,
                  list);
      if (__any_sync(kFull, second.k1 > second.k0)) {
        auto test1 = [&](const Rec<T>& q) {
          return in_support_rn<T, true>(di, q, rs, box, g1);
        };
        walker.walk(second.k0, second.k1 - second.k0, r, g1, test1, load,
                    body, list);
      }
    }
  }
}

}  // namespace group
