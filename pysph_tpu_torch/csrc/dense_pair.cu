// Cell-tiled WCSPH pair kernel for Hopper (sm_90a): tiles of dest cells,
// with the neighbour rows of the packed sources staged by bulk copies.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel (the dense-slot
// Pallas engine, PYSPH_TPU_RESIDENT=0 PYSPH_TPU_COMPACT=0) for the WCSPH
// phase sets: ContinuityEquation, MomentumEquation (with or without the
// tensile correction), XSPHCorrection, LaminarViscosity and
// SummationDensity of one dest array over at most 4 sources, with any
// shape of csrc/shapes.cuh, on an open or a periodic grid.  Same contract,
// same arguments and same per-pair body (wcsph_terms.cuh) as
// csrc/wcsph_pair.cu; only the walk differs.
//
// The TPU kernel gives one program to each active cell block, stages its
// 9 neighbour views of every fused source into VMEM by DMA, accumulates
// in VMEM scratch and writes each output once.  The GPU form of that:
//
// - one thread block per tile of kTileCells x-adjacent dest cells of one
//   (y, z) row.  The tile's dests are one contiguous range of the dest's
//   sorted order, taken kDests at a time, one consumer thread each (a
//   tile holds ~120-145 dests at 15-18 a cell; a clamped edge cell only
//   adds passes);
// - for each source and each stencil row, the particles of the tile's
//   cells x0 - 1 .. x1 + 1 are one contiguous span of the packed copy
//   (csrc/cell_pack.cuh, launched by this file's launch function just
//   before the walk).  A producer warp copies the span's
//   {x, y, z, h} records, which every candidate's support test reads,
//   into a ring of kStages shared-memory stages with the bulk copy
//   (cp.async.bulk, completing on the stage's `full` mbarrier), in chunks
//   of at most kStageRecords records, so a clamped edge cell of any size
//   fits.  It refills a stage once the kConsumerWarps consumer warps have
//   each arrived on the stage's `empty` mbarrier, so the copies of the
//   next chunks run while the consumers walk, and a consumer warp waits
//   for no other warp, only for its data;
// - each consumer thread tests only the part of the chunk that holds its
//   own cells cx - 1 .. cx + 1, so it tests the candidates of the plain
//   stencil walk, in its order; the walker of csrc/cell_walk.cuh keeps
//   those in support and hands them to the pair body in rounds, which
//   read the {u, v, w, m} and {rho, p, cs} records of the pairs in
//   support from the packed copy in global memory (L2), so a pair may
//   wait in the walker after its chunk's stage is reused;
// - each dest accumulates in registers over every source and writes pre
//   + sum (max(pre, m) for dt_cfl) once, under the write mask.  No
//   atomics: runs repeat exactly.
//
// On a periodic grid (the template flag PERIODIC; PeriodicChunks) the
// stencil rows wrap with the axes' offsets (CellGrid.axis_offsets), and
// the tile's span of a row, its cells x0 - 1 .. x1 + 1 on a periodic x
// axis, is up to three segments of the packed copy: the cell before the
// grid's start wrapped to its end, the cells inside the grid, the cell
// past its end wrapped to its start.  The block stages each segment's
// chunks in that order, and a thread tests the part of each segment that
// its own cells hold, so it walks the two ranges of
// walk::walk_rows_periodic in their order; the support test and the pair
// take the minimum image.
//
// What bounds it: the same candidates and pair body as wcsph_pair.cu.
// Here every candidate's record reaches the SM once per tile instead of
// once per warp that tests it, and the tests read shared memory.
//
// Interface: plain C through ctypes (ops/dense_pair.py), as wcsph_pair:
// the launch function launches the pack of a.pack, then the walk.

#include <type_traits>

#include "wcsph_terms.cuh"

namespace {

using wcsph::Cand;
using wcsph::Dest;
using wcsph::Rec;

constexpr int kConsumerWarps = 4;
constexpr int kDests = 32 * kConsumerWarps;  // dests of a pass
constexpr int kThreads = kDests + 32;        // and the producer warp
constexpr int kTileCells = 8;
constexpr int kStages = 4;
constexpr int kStageRecords = 512;

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kStageRecords * 4 * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(shared_addr(bar))
      : "memory");
}

// Record k of a staged plane.
__device__ __forceinline__ Rec<float> srec(const float* plane, int k) {
  const float4 v = reinterpret_cast<const float4*>(plane)[k];
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Rec<double> srec(const double* plane, int k) {
  const double2* q = reinterpret_cast<const double2*>(plane) + 2 * k;
  const double2 lo = q[0], hi = q[1];
  return {lo.x, lo.y, hi.x, hi.y};
}

// The staged chunks of one tile, in the order the block walks them: for
// each source, each stencil row (oz, oy) inside the grid whose span of
// the cells x0 - 1 .. x1 + 1 is not empty, chunks of at most
// kStageRecords records from the span's start.
struct Chunks {
  int x0, x1, y, z;  // the tile
  int s, r;          // source, stencil row (r = (oz + rz) * ny3 + oy + ry)
  int kc, k1;        // the chunk's first position, the span's end
  bool done;

  __device__ int ny3(const WcsphArgs& a) const { return a.ny > 1 ? 3 : 1; }
  __device__ int row_y(const WcsphArgs& a) const {
    return y + r % ny3(a) - (a.ny > 1);
  }
  __device__ int row_z(const WcsphArgs& a) const {
    return z + r / ny3(a) - (a.nz > 1);
  }
  __device__ int count() const { return min(kStageRecords, k1 - kc); }

  __device__ void begin(const WcsphArgs& a, int tx0, int tx1, int ty,
                        int tz) {
    x0 = tx0;
    x1 = tx1;
    y = ty;
    z = tz;
    s = 0;
    r = -1;
    kc = k1 = 0;
    done = a.n_src == 0;
    if (!done) next_row(a);
  }

  __device__ void next_row(const WcsphArgs& a) {
    const int rows = ny3(a) * (a.nz > 1 ? 3 : 1);
    for (;;) {
      if (++r == rows) {
        r = 0;
        if (++s == a.n_src) {
          done = true;
          return;
        }
      }
      const walk::Span sp =
          walk::row_span(a, a.src[s].cell_start, a.src[s].cell_end, x0 - 1,
                         x1 + 1, row_y(a), row_z(a));
      if (sp.k0 < sp.k1) {
        kc = sp.k0;
        k1 = sp.k1;
        return;
      }
    }
  }

  __device__ void next(const WcsphArgs& a) {
    kc += kStageRecords;
    if (kc >= k1) next_row(a);
  }

  // The positions of the thread's own cells cx - 1 .. cx + 1 in the
  // chunk's row of source S.
  __device__ walk::Span own(const WcsphArgs& a, const SrcArgs& S,
                            int cx) const {
    return walk::row_span(a, S.cell_start, S.cell_end, cx - 1, cx + 1,
                          row_y(a), row_z(a));
  }
};

// The staged chunks of one tile on a periodic grid, in the order the
// block walks them: for each source, each stencil row (oz, oy) of the
// axes' offsets (wrapped on a periodic axis, skipped outside the grid on
// another), each non-empty segment g of the row's cells x0 + xlo .. x1 +
// xhi (0: those before cell 0, wrapped to the grid's end; 1: those inside
// the grid; 2: those past its end, wrapped to cell 0), chunks of at most
// kStageRecords records from the segment's start.
struct PeriodicChunks {
  int x0, x1, y, z;  // the tile
  int s, r, g;       // source, stencil row, segment
  int kc, k1;        // the chunk's first position, the segment's end
  bool done;
  int xlo, xhi, ylo, yhi, zlo, zhi;  // the axes' stencil offsets

  __device__ static bool periodic(const WcsphArgs& a, int d) {
    return a.box[d] != 0.0;
  }
  __device__ int rows_y() const { return yhi - ylo + 1; }
  // the chunk's row, wrapped; -1 outside the grid
  __device__ int row_y(const WcsphArgs& a) const {
    const int v = y + ylo + r % rows_y();
    return periodic(a, 1) ? (v + a.ny) % a.ny
                          : (v < 0 || v >= a.ny ? -1 : v);
  }
  __device__ int row_z(const WcsphArgs& a) const {
    const int v = z + zlo + r / rows_y();
    return periodic(a, 2) ? (v + a.nz) % a.nz
                          : (v < 0 || v >= a.nz ? -1 : v);
  }
  __device__ int count() const { return min(kStageRecords, k1 - kc); }

  // cells [xa, xb] of segment g of the cells lo .. hi of a row (xa > xb:
  // empty)
  __device__ static void segment(const WcsphArgs& a, int g, int lo, int hi,
                                 int& xa, int& xb) {
    if (!periodic(a, 0)) {
      xa = g == 1 ? max(lo, 0) : 1;
      xb = g == 1 ? min(hi, a.nx - 1) : 0;
    } else if (g == 0) {
      xa = lo < 0 ? lo + a.nx : 1;
      xb = lo < 0 ? a.nx - 1 : 0;
    } else if (g == 1) {
      xa = max(lo, 0);
      xb = min(hi, a.nx - 1);
    } else {
      xa = hi >= a.nx ? 0 : 1;
      xb = hi >= a.nx ? hi - a.nx : 0;
    }
  }

  // positions of segment g of cells lo .. hi of the chunk's row of S
  __device__ walk::Span span(const WcsphArgs& a, const SrcArgs& S, int g,
                             int lo, int hi) const {
    const int yy = row_y(a), zz = row_z(a);
    int xa, xb;
    segment(a, g, lo, hi, xa, xb);
    if (yy < 0 || zz < 0 || xa > xb) return {0, 0};
    const int row = a.nx * (yy + a.ny * zz);
    return {S.cell_start[row + xa], S.cell_end[row + xb]};
  }

  __device__ void begin(const WcsphArgs& a, int tx0, int tx1, int ty,
                        int tz) {
    x0 = tx0;
    x1 = tx1;
    y = ty;
    z = tz;
    walk::axis_offsets(a.nx, periodic(a, 0), xlo, xhi);
    walk::axis_offsets(a.ny, periodic(a, 1), ylo, yhi);
    walk::axis_offsets(a.nz, periodic(a, 2), zlo, zhi);
    s = 0;
    r = 0;
    g = -1;
    kc = k1 = 0;
    done = a.n_src == 0;
    if (!done) next_segment(a);
  }

  __device__ void next_segment(const WcsphArgs& a) {
    const int rows = rows_y() * (zhi - zlo + 1);
    for (;;) {
      if (++g == 3) {
        g = 0;
        if (++r == rows) {
          r = 0;
          if (++s == a.n_src) {
            done = true;
            return;
          }
        }
      }
      const walk::Span sp = span(a, a.src[s], g, x0 + xlo, x1 + xhi);
      if (sp.k0 < sp.k1) {
        kc = sp.k0;
        k1 = sp.k1;
        return;
      }
    }
  }

  __device__ void next(const WcsphArgs& a) {
    kc += kStageRecords;
    if (kc >= k1) next_segment(a);
  }

  // The positions of the thread's own cells cx + xlo .. cx + xhi in the
  // chunk's segment of the chunk's row of source S.
  __device__ walk::Span own(const WcsphArgs& a, const SrcArgs& S,
                            int cx) const {
    return span(a, S, g, cx + xlo, cx + xhi);
  }
};

template <bool PERIODIC>
using ChunksOf = typename std::conditional<PERIODIC, PeriodicChunks,
                                           Chunks>::type;

// The producer: copy the {x, y, z, h} records of chunk c into `stage`,
// completing on bar.
template <typename T, class C>
__device__ void issue(const WcsphArgs& a, const C& c,
                      unsigned char* stage, uint64_t* bar) {
  const uint32_t bytes = c.count() * 4 * sizeof(T);
  const T* from = static_cast<const T*>(a.src[c.s].pos) +
                  static_cast<size_t>(c.kc) * 4;
  mbar_expect_tx(bar, bytes);
  bulk_copy(stage, from, bytes, bar);
}

// 5 blocks an SM in float (72 registers a thread).  EXTRA: built with
// the kExtra terms this kernel takes (kLvisc, kTens, kSumRho); PERIODIC:
// the periodic tile and the minimum image (template flags, so that the
// kernels built without them are the code they were before them).
template <typename T, int KIND, bool EXTRA, bool PERIODIC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 5 : 3)
    dense_pair_kernel(const WcsphArgs a) {
  using Chunks = ChunksOf<PERIODIC>;
  extern __shared__ __align__(128) unsigned char ring[];
  // full: the stage's copy landed; empty: every consumer warp walked it
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int tiles = (a.nx + kTileCells - 1) / kTileCells;
  const int row = blockIdx.x / tiles;
  const int x0 = (blockIdx.x % tiles) * kTileCells;
  const int x1 = min(x0 + kTileCells, a.nx) - 1;
  const int y = row % a.ny, z = row / a.ny;
  const int dstart = a.dcell_start[x0 + a.nx * row];
  const int dend = a.dcell_end[x1 + a.nx * row];
  if (dstart >= dend) return;  // the same for every thread of the block

  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int sb = stage_bytes<T>();

  // chunk u of the block (counted over every pass) sits in stage
  // u % kStages, in that stage's (u / kStages)-th phase
  if (threadIdx.x >= kDests) {  // the producer warp
    if (threadIdx.x == kDests) {
      unsigned u = 0;
      for (int base = dstart; base < dend; base += kDests) {
        Chunks c;
        for (c.begin(a, x0, x1, y, z); !c.done; c.next(a), ++u) {
          const int st = u % kStages;
          if (u >= kStages) mbar_wait(&empty[st], (u / kStages - 1) & 1);
          issue<T>(a, c, ring + st * sb, &full[st]);
        }
      }
    }
    return;
  }

  const int dterms = wcsph::dest_terms(a);
  const T rs = T(a.radius_scale), kfac = T(a.kfac);
  unsigned used = 0;
  for (int base = dstart; base < dend; base += kDests) {
    const int pos = base + threadIdx.x;
    const bool active = pos < dend;
    const int i = active ? a.dorder[pos] : 0;
    const int cx = active ? a.cell[i] % a.nx : x0;
    Dest<T> d{};
    if (active) d.template load<false, EXTRA>(a, i, dterms);
    const Rec<T> di = d.point();
    const walk::Box<T> box = wcsph::box_of<T>(a);
    auto test = [&](const Rec<T>& r) {
      return walk::in_support(di, r, rs, box);
    };

    Chunks c;
    c.begin(a, x0, x1, y, z);
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const SrcArgs& S = a.src[s];
      const int terms = S.terms;
      const bool thermo = terms & (kMom | kXsph | (EXTRA ? kLvisc : 0));
      const T c0 = T(S.c0), alpha = T(S.alpha), beta = T(S.beta);
      const T xeps = T(S.xsph_eps);
      const wcsph::ExtraConsts<T> ec = wcsph::extra_consts<T>(a, S);
      auto body = [&](int k) {
        Cand<T> cand;
        cand.pos = wcsph::rec<T>(S.pos, k);
        cand.vel = wcsph::rec<T>(S.vel, k);
        cand.th = thermo ? wcsph::rec<T>(S.thermo, k) : Rec<T>{};
        d.template pair<KIND, false, EXTRA, PERIODIC>(
            cand, k, terms, c0, alpha, beta, xeps, rs, kfac, a.dim, {}, ec,
            box);
      };
      for (; !c.done && c.s == s; c.next(a), ++used) {
        const int st = used % kStages;
        mbar_wait(&full[st], (used / kStages) & 1);
        const T* staged = reinterpret_cast<const T*>(ring + st * sb);
        const int kc = c.kc;
        // this thread's own cells of the chunk's row (cx - 1 .. cx + 1;
        // periodic: of its segment), in the chunk
        walk::Span own{0, 0};
        if (active) own = c.own(a, S, cx);
        const int lo = max(own.k0, kc), hi = min(own.k1, kc + c.count());
        auto staged_pos = [&](int k) { return srec(staged, k - kc); };
        if (PERIODIC)
          walker.walk_test(lo, hi - lo, test, staged_pos, body);
        else
          walker.walk(lo, hi - lo, di, rs, staged_pos, body);
        // the warp's reads of the stage come before the producer's refill
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(&empty[st]);
      }
      walker.finish(body);
    }
    if (active) d.template store<EXTRA>(a, i);
  }
}

template <typename T, int KIND, bool EXTRA, bool PERIODIC>
cudaError_t launch_flags(const WcsphArgs& a, int blocks,
                         cudaStream_t stream) {
  // above 48 KB (float64) a kernel must ask for its dynamic shared memory
  constexpr int ring = kStages * stage_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_pair_kernel<T, KIND, EXTRA, PERIODIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (attr != cudaSuccess) return attr;
  dense_pair_kernel<T, KIND, EXTRA, PERIODIC>
      <<<blocks, kThreads, ring, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const WcsphArgs& a, int blocks, cudaStream_t stream) {
  bool extra = false;
  for (int s = 0; s < a.n_src; ++s)
    extra = extra || (a.src[s].terms & kExtra);
  if (a.periodic)
    return extra ? launch_flags<T, KIND, true, true>(a, blocks, stream)
                 : launch_flags<T, KIND, false, true>(a, blocks, stream);
  return extra ? launch_flags<T, KIND, true, false>(a, blocks, stream)
               : launch_flags<T, KIND, false, false>(a, blocks, stream);
}

template <typename T>
cudaError_t launch(const WcsphArgs& a, cudaStream_t stream) {
  const long long tiles =
      1LL * ((a.nx + kTileCells - 1) / kTileCells) * a.ny * a.nz;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(tiles);
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, blocks, stream);
  });
}

}  // namespace

extern "C" {

int dense_pair_args_size() { return static_cast<int>(sizeof(WcsphArgs)); }

int dense_pair_launch(const WcsphArgs* args, void* stream) {
  const WcsphArgs a = *args;
  if (!wcsph::args_ok(a) || !shapes::built_kind(a.kernel_kind) ||
      a.dorder == nullptr || a.cell == nullptr ||
      a.dcell_start == nullptr || a.dcell_end == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the delta-SPH terms are wcsph_pair's only (as the JAX dense engine,
  // which takes no delta-SPH group)
  for (int s = 0; s < a.n_src; ++s)
    if (a.src[s].terms & (kDcont | kDmom | kLvd))
      return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* dense_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
