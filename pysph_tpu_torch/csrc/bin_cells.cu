// The cell binning of one evaluator's arrays, kept Verlet-style, for Hopper
// (sm_90a): the reuse test and the binning it gates, decided on the card.
//
// Replaces what pysph_tpu does in XLA ops, not a Pallas kernel:
// AccelerationEval.prepare_reuse (pysph_tpu/sph/acceleration_eval.py:
// 857-927, the test and its lax.cond) and prepare (:801-855, the binning),
// on the port's sorted cell lists (pysph_tpu_torch/base/cell_grid.py).
// It computes exactly what ops/bin_cells.py::bin_cells_reference computes
// from the same tensors:
//
// - over every particle of every array: the box lo, hi, hmax = max h and
//   disp2 = max |x - ref|^2 against the handle's reference positions;
// - rebuild = force or disp2 > margin^2 or cell > width * 1.0001, and
//   active where an active flag is given, with cell = cell_slack
//   radius_scale hmax and margin = 0.5 (cell_slack - 1) radius_scale hmax;
// - where rebuild: origin = lo, width = cell, overflow = some particle at
//   or beyond origin + dims width on an axis of more than one cell; per
//   array the cell id ix + nx (iy + ny iz) of each particle, with i =
//   floor((x - origin) / width) clamped into the grid, the order (particle
//   indices sorted by cell id, ascending within a cell, as a stable sort
//   gives them), start and end per cell, and x, y, z copied into ref;
// - where not: nothing of the handle changes (every kernel but the first
//   returns at once); the flag is written either way;
// - a position or h that is not finite (a run that blew up) is never
//   binned: the reduction tests every particle itself (fmax drops a NaN
//   operand, so the maxima never show one), and where it finds one (and
//   active) the flag is 0 and the grid's flag `nonfinite` is set to 1,
//   which the solver reads with what it reads anyway and raises
//   FloatingPointError; so a NaN can no longer pile every particle into
//   cell 0 for the sort;
// - on a periodic axis (CellGrid with a periodic domain): the origin is
//   the box's lower corner, the cells have the width L / dims, the id is
//   floor((x - origin) / width) modulo the count, the axis never
//   overflows, the displacement is the minimum image d - L rint(d / L),
//   and the width the test compares is the least of the cells' widths.
//
// IEEE arithmetic, no fused multiply-add: every value is one rounded
// operation as in the plain version's torch ops (__f*_rn/__d*_rn; the
// library is built without --use_fast_math), so the cell ids, and with
// them the lists, equal the plain version's bit for bit.
//
// What bounds it: bytes, and at the paths' sizes (1e5 particles, 1e4-1e5
// cells) the launches.  A binning reads x y z h and ref once for the test
// and x y z once more, and writes cell, order, start, end, ref: a few MB,
// ~2 us at 3.35 TB/s.  A kept eval reads x y z h and ref.
//
// Design: six launches, each gated by the flag on the card, so a CUDA
// graph holds all six and a kept eval costs their early returns:
// 1. bin_reduce: grid-stride over all particles, block maxima, a partial
//    per block; the last block to finish (a ticket) reduces the partials
//    and decides (finalize).  It also zeroes the per-cell counts and the
//    counts of the listed cells (scratch).
// 2. bin_count: cell ids, the counts by atomicAdd, ref.
// 3. bin_scan: a block per tile of kScanTile cells of an array; it sums
//    the counts before its tile (the tiles are few, so every block reads
//    them, and no block waits on another), scans its tile in shared
//    memory and writes start, and end = start (the scatter's cursors).
// 4. bin_scatter: order[end[cell]++] = i, in no fixed order, which leaves
//    end one past the cell's last;
// 5. bin_sort, a thread a cell: puts the cell's range of order in
//    ascending order where it holds at most kTiny particles (the paths'
//    cells of a few particles: its values in registers, each stored at
//    its rank, kTiny^2 compares), and lists a longer one;
// 6. bin_sort_listed sorts the listed cells, so that order is
//    deterministic and the stable sort's: a warp a cell of at
//    most kShort loads it into shared memory and each lane writes each
//    of its values at its rank, the count of the cell's values below it
//    (the indices are distinct): at most kShort / 32 values a lane times
//    the count (the gas runs' cells of ~110); then a block a longer cell
//    sorts it by an LSD radix sort of its indices, 8 bits a pass
//    (ceil(bits of n / 8) passes), each pass a histogram, a scan and a
//    scatter that is stable by construction (a slice of the block's
//    threads at a time, in index order: a value's place is its digit's
//    start, plus the values of that digit in the earlier slices, the
//    earlier warps of its slice (shared counts) and the lower lanes of
//    its warp (__match_any_sync)), through a scratch copy: O(k) a cell in
//    its count k, whatever the cell holds (a state crowded into one cell
//    sorts in one block in a few passes).
// The insertion sort of every cell by one thread that this replaces
// cost O(k^2) in a cell's count, and one thread sorted a crowded cell.
//
// Interface: plain C through ctypes (ops/bin_cells.py):
// bin_cells_launch(const BinArgs*, stream) launches the six kernels and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxArrays = 8;
constexpr int kThreads = 256;
// blocks of bin_reduce at most (2 a streaming multiprocessor), and the
// partials' rows (ops/bin_cells.py REDUCE_BLOCKS)
constexpr int kReduceBlocks = 264;
constexpr int kScanThreads = 1024;
// cells a block of bin_scan scans, kScanItems a thread
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
// a partial: -lo (3), hi (3), hmax, disp2, and 1 where a particle's
// position or h is not finite (else 0), each reduced by max
constexpr int kValues = 9;
// the longest cell a thread sorts alone (kTiny^2 compares in registers),
// and the longest a warp sorts
constexpr int kTiny = 16;
constexpr int kShort = 256;
// bin_sort_listed: threads a block, its warps, the radix and blocks (2
// blocks an SM)
constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kRadix = 256;
constexpr int kLongBlocks = 132 * 2;

struct BinArray {
  const void* x;     // (n,) of the dtype
  const void* y;
  const void* z;
  const void* h;
  void* ref;         // (3, n): the positions at the last binning
  int32_t* cell;     // (n,) cell id
  int32_t* order;    // (n,) particle indices sorted by cell
  int32_t* start;    // (ncells,) first position in order
  int32_t* end;      // (ncells,) one past the last
  int32_t* count;    // (ncells,) scratch: the counts
  int32_t* tmp;      // (n,) scratch: bin_sort_listed's copy
  // (ncells,) scratch: the cells bin_sort leaves to bin_sort_listed, those
  // of kTiny + 1 .. kShort particles from the front, the longer from the
  // back, and (2,) their numbers
  int32_t* listed;
  int32_t* nlisted;
  int32_t n, pad;
};

struct BinArgs {
  BinArray arr[kMaxArrays];
  void* origin;             // (3,) of the dtype
  void* width;              // () of the dtype
  uint8_t* overflow;        // () bool
  uint8_t* rebuild;         // () bool, written by bin_reduce
  const uint8_t* active;    // () bool, or null: always active
  double* partial;          // (kReduceBlocks, kValues) scratch
  uint32_t* ticket;         // () scratch, 0 between launches
  uint8_t* nonfinite;       // () bool, set where the state is not finite
  double slack_rs;          // cell_slack * radius_scale
  double half_margin;       // 0.5 * (cell_slack - 1) * radius_scale
  // the periodic axes (per[d] != 0): the box's lower corner, its length
  // and the cells' width L / dims there, each a value of the dtype
  double pmin[3], plen[3], pwidth[3];
  double stale;             // the least periodic width; inf: none
  // open_axis: some axis below dim is not periodic, so the reuse test
  // compares the binning's width too (CellGrid.stale_width)
  int32_t n_arr, dtype, force, nx, ny, nz, ncells, open_axis;
  int32_t per[3], pad;
};

namespace bin {

// one rounded IEEE operation each, never contracted into an FMA
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}

__device__ __forceinline__ float rint_rn(float a) { return rintf(a); }
__device__ __forceinline__ double rint_rn(double a) { return rint(a); }

// The minimum image d - L round(d / L) of a displacement along an axis
// of length L, round half to even as torch.round
template <typename T>
__device__ __forceinline__ T image(T d, T L) {
  return sub(d, mul(L, rint_rn(div(d, L))));
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// v[j] = the maximum of v[j] over the block, in every thread of warp 0
template <typename T>
__device__ void block_max(T* v, T (*sh)[kValues]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < kValues; ++j) v[j] = warp_max(v[j]);
  if (lane == 0)
    for (int j = 0; j < kValues; ++j) sh[warp][j] = v[j];
  __syncthreads();
  if (warp == 0)
    for (int j = 0; j < kValues; ++j)
      v[j] = warp_max(lane < (blockDim.x >> 5) ? sh[lane][j]
                                               : -static_cast<T>(INFINITY));
  __syncthreads();
}

// The decision and, where it rebuilds, the geometry: thread 0 of the last
// block, from the reduced values v.
template <typename T>
__device__ void finalize(const BinArgs& a, const T* v) {
  T* origin = static_cast<T*>(a.origin);
  T* width = static_cast<T*>(a.width);
  const T hmax = v[6], disp2 = v[7];
  const T cell = mul(static_cast<T>(a.slack_rs), hmax);
  const T margin = mul(static_cast<T>(a.half_margin), hmax);
  // the least width of the binning's cells (CellGrid.stale_width; 0 on
  // an invalidated handle)
  const T least = a.open_axis != 0 ? fmin(*width, static_cast<T>(a.stale))
                  : *width > static_cast<T>(0) ? static_cast<T>(a.stale)
                                               : *width;
  const bool stale = disp2 > mul(margin, margin) ||
                     cell > mul(least, static_cast<T>(1.0001));
  const bool live = a.active == nullptr || *a.active != 0;
  // a state that is not finite is not binned, and flags the grid
  const bool bad = v[8] > static_cast<T>(0);
  if (bad && live) *a.nonfinite = 1;
  const bool rebuild = (a.force != 0 || stale) && live && !bad;
  *a.rebuild = rebuild;
  if (!rebuild) return;
  const int dims[3] = {a.nx, a.ny, a.nz};
  bool overflow = false;
  for (int d = 0; d < 3; ++d) {
    const T lo = -v[d];
    origin[d] = a.per[d] != 0 ? static_cast<T>(a.pmin[d]) : lo;
    if (dims[d] > 1 && a.per[d] == 0)
      overflow |= floor(div(sub(v[3 + d], lo), cell)) >=
                  static_cast<T>(dims[d]);
  }
  *width = cell;
  *a.overflow = overflow;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bin_reduce(const BinArgs a) {
  __shared__ T sh[kThreads / 32][kValues];
  __shared__ bool last;
  const T lowest = -static_cast<T>(INFINITY);
  T v[kValues];
  for (int j = 0; j < kValues; ++j) v[j] = lowest;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (blockIdx.x == 0 && threadIdx.x < 2 * a.n_arr)
    a.arr[threadIdx.x >> 1].nlisted[threadIdx.x & 1] = 0;
  for (int s = 0; s < a.n_arr; ++s) {
    const BinArray& A = a.arr[s];
    for (int c = first; c < a.ncells; c += stride) A.count[c] = 0;
    const T* x = static_cast<const T*>(A.x);
    const T* y = static_cast<const T*>(A.y);
    const T* z = static_cast<const T*>(A.z);
    const T* h = static_cast<const T*>(A.h);
    const T* ref = static_cast<const T*>(A.ref);
    for (int i = first; i < A.n; i += stride) {
      const T px = x[i], py = y[i], pz = z[i];
      v[0] = fmax(v[0], -px);
      v[1] = fmax(v[1], -py);
      v[2] = fmax(v[2], -pz);
      v[3] = fmax(v[3], px);
      v[4] = fmax(v[4], py);
      v[5] = fmax(v[5], pz);
      const T hi = h[i];
      v[6] = fmax(v[6], hi);
      if (!(isfinite(px) && isfinite(py) && isfinite(pz) && isfinite(hi)))
        v[8] = static_cast<T>(1);
      T dx = sub(px, ref[i]), dy = sub(py, ref[A.n + i]),
        dz = sub(pz, ref[2 * A.n + i]);
      // a wrap moves a coordinate by a box length: its minimum image
      if (a.per[0] != 0) dx = image(dx, static_cast<T>(a.plen[0]));
      if (a.per[1] != 0) dy = image(dy, static_cast<T>(a.plen[1]));
      if (a.per[2] != 0) dz = image(dz, static_cast<T>(a.plen[2]));
      v[7] = fmax(v[7], add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
    }
  }
  block_max(v, sh);
  if (threadIdx.x == 0) {
    for (int j = 0; j < kValues; ++j)
      a.partial[blockIdx.x * kValues + j] = static_cast<double>(v[j]);
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials hold values of T exactly, so the maxima are T's
  for (int j = 0; j < kValues; ++j) v[j] = lowest;
  for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x)
    for (int j = 0; j < kValues; ++j)
      v[j] = fmax(v[j], static_cast<T>(__ldcg(&a.partial[b * kValues + j])));
  block_max(v, sh);
  if (threadIdx.x == 0) {
    finalize(a, v);
    *a.ticket = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bin_count(const BinArgs a) {
  if (!*a.rebuild) return;
  const BinArray& A = a.arr[blockIdx.y];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n) return;
  const T* origin = static_cast<const T*>(a.origin);
  const T w = *static_cast<const T*>(a.width);
  const T* pos[3] = {static_cast<const T*>(A.x), static_cast<const T*>(A.y),
                     static_cast<const T*>(A.z)};
  const int dims[3] = {a.nx, a.ny, a.nz};
  T* ref = static_cast<T*>(A.ref);
  long long cid = 0, stride = 1;
  for (int d = 0; d < 3; ++d) {
    const T p = pos[d][i];
    ref[static_cast<size_t>(d) * A.n + i] = p;
    if (a.per[d] != 0) {
      // periodic: cells of width L / dims from the box's corner, the id
      // modulo the count
      const T c = floor(div(sub(p, origin[d]), static_cast<T>(a.pwidth[d])));
      long long ci = static_cast<long long>(c) % dims[d];
      cid += (ci < 0 ? ci + dims[d] : ci) * stride;
    } else if (dims[d] > 1) {
      T c = floor(div(sub(p, origin[d]), w));
      const T top = static_cast<T>(dims[d] - 1);
      c = c < static_cast<T>(0) ? static_cast<T>(0) : c;
      c = c > top ? top : c;
      cid += static_cast<long long>(c) * stride;
    }
    stride *= dims[d];
  }
  A.cell[i] = static_cast<int32_t>(cid);
  atomicAdd(&A.count[cid], 1);
}

// the exclusive prefix sum of v over the block, and the block's total in
// *total (every thread); sh: 32 ints of shared memory
__device__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (blockDim.x >> 5) ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? sh[warp - 1] : 0) + x - v;
  *total = sh[31];
  __syncthreads();
  return before;
}

__global__ void __launch_bounds__(kScanThreads) bin_scan(const BinArgs a) {
  if (!*a.rebuild) return;
  __shared__ int tile[kScanTile];
  __shared__ int sh[32];
  const BinArray& A = a.arr[blockIdx.y];
  const int t = threadIdx.x, base = blockIdx.x * kScanTile;
  // the particles in the cells before the tile
  int off = 0;
  for (int c = t; c < base; c += kScanThreads) off += A.count[c];
  block_scan(off, sh, &off);
  for (int k = 0; k < kScanItems; ++k) {
    const int c = base + k * kScanThreads + t;
    tile[k * kScanThreads + t] = c < a.ncells ? A.count[c] : 0;
  }
  __syncthreads();
  int v[kScanItems], sum = 0;
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = tile[t * kScanItems + k];
    sum += v[k];
  }
  int total;
  int run = off + block_scan(sum, sh, &total);
  for (int k = 0; k < kScanItems; ++k) {
    tile[t * kScanItems + k] = run;
    run += v[k];
  }
  __syncthreads();
  for (int k = 0; k < kScanItems; ++k) {
    const int c = base + k * kScanThreads + t;
    if (c < a.ncells) A.start[c] = A.end[c] = tile[k * kScanThreads + t];
  }
}

__global__ void __launch_bounds__(kThreads) bin_scatter(const BinArgs a) {
  if (!*a.rebuild) return;
  const BinArray& A = a.arr[blockIdx.y];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n) return;
  A.order[atomicAdd(&A.end[A.cell[i]], 1)] = i;
}

// A thread a cell: a cell of at most kTiny particles sorted in place, a
// longer one listed for bin_sort_listed.
__global__ void __launch_bounds__(kThreads) bin_sort(const BinArgs a) {
  if (!*a.rebuild) return;
  const BinArray& A = a.arr[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.ncells) return;
  const int b = A.start[c], k = A.end[c] - b;
  if (k > kShort) {
    A.listed[a.ncells - 1 - atomicAdd(&A.nlisted[1], 1)] = c;
  } else if (k > kTiny) {
    A.listed[atomicAdd(&A.nlisted[0], 1)] = c;
  } else if (k > 1) {
    // in registers: each value goes to its rank (the indices are
    // distinct), every load issued before any store
    int32_t* o = A.order + b;
    int32_t v[kTiny];
#pragma unroll
    for (int u = 0; u < kTiny; ++u) v[u] = u < k ? o[u] : INT32_MAX;
#pragma unroll
    for (int u = 0; u < kTiny; ++u) {
      int r = 0;
#pragma unroll
      for (int w = 0; w < kTiny; ++w) r += v[w] < v[u];
      if (u < k) o[r] = v[u];
    }
  }
}

// The listed cells: a warp a cell of at most kShort (a rank sort in the
// warp's shared memory), then a block a longer cell (an LSD radix sort;
// see the top).
__global__ void __launch_bounds__(kLongThreads, 2)
    bin_sort_listed(const BinArgs a) {
  if (!*a.rebuild) return;
  const BinArray& A = a.arr[blockIdx.y];
  const int nmid = A.nlisted[0], nlong = A.nlisted[1];
  if (blockIdx.x * kLongWarps >= nmid && blockIdx.x >= nlong) return;
  __shared__ int32_t held[kLongWarps][kShort];
  __shared__ int cnt[kLongWarps][kRadix];
  __shared__ int base[kRadix], total[kRadix];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int32_t* s = held[warp];
  for (int q = blockIdx.x * kLongWarps + warp; q < nmid;
       q += gridDim.x * kLongWarps) {
    const int c = A.listed[q];
    const int b = A.start[c], k = A.end[c] - b;
    int32_t* o = A.order + b;
    for (int e = lane; e < k; e += 32) s[e] = o[e];
    __syncwarp();
    int32_t mine[kShort / 32];
    int rank[kShort / 32];
#pragma unroll
    for (int u = 0; u < kShort / 32; ++u) {
      mine[u] = lane + 32 * u < k ? s[lane + 32 * u] : INT32_MAX;
      rank[u] = 0;
    }
    for (int e = 0; e < k; ++e) {
      const int32_t v = s[e];
#pragma unroll
      for (int u = 0; u < kShort / 32; ++u) rank[u] += v < mine[u];
    }
#pragma unroll
    for (int u = 0; u < kShort / 32; ++u)
      if (lane + 32 * u < k) o[rank[u]] = mine[u];
    __syncwarp();
  }
  const int bits = A.n > 1 ? 32 - __clz(A.n - 1) : 1;
  const int passes = (bits + 7) / 8;
  for (int q = blockIdx.x; q < nlong; q += gridDim.x) {
    const int c = A.listed[a.ncells - 1 - q];
    const int b = A.start[c], k = A.end[c] - b;
    int32_t* src = A.order + b;
    int32_t* dst = A.tmp + b;
    for (int p = 0; p < passes; ++p) {
      const int shift = 8 * p;
      for (int r = t; r < kRadix; r += kLongThreads) base[r] = 0;
      __syncthreads();
      for (int e = t; e < k; e += kLongThreads)
        atomicAdd(&base[(src[e] >> shift) & (kRadix - 1)], 1);
      __syncthreads();
      if (warp == 0) {
        // the digits' starts: an exclusive scan, kRadix / 32 a lane
        constexpr int kPer = kRadix / 32;
        int v[kPer], sum = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) sum += v[j] = base[lane * kPer + j];
        int x = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        int run = x - sum;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          base[lane * kPer + j] = run;
          run += v[j];
        }
      }
      __syncthreads();
      for (int s0 = 0; s0 < k; s0 += kLongThreads) {
        const int e = s0 + t;
        const bool valid = e < k;
        const int32_t v = valid ? src[e] : 0;
        const int d = valid ? (v >> shift) & (kRadix - 1) : kRadix;
        for (int r = t; r < kLongWarps * kRadix; r += kLongThreads)
          (&cnt[0][0])[r] = 0;
        __syncthreads();
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int below = __popc(peers & ((1u << lane) - 1u));
        if (valid && below == 0) cnt[warp][d] = __popc(peers);
        __syncthreads();
        // each digit's values in the slice's earlier warps
        for (int r = t; r < kRadix; r += kLongThreads) {
          int run = 0;
          for (int w = 0; w < kLongWarps; ++w) {
            const int x = cnt[w][r];
            cnt[w][r] = run;
            run += x;
          }
          total[r] = run;
        }
        __syncthreads();
        if (valid) dst[base[d] + cnt[warp][d] + below] = v;
        __syncthreads();
        for (int r = t; r < kRadix; r += kLongThreads) base[r] += total[r];
        __syncthreads();
      }
      int32_t* swap = src;
      src = dst;
      dst = swap;
    }
    if (passes & 1)
      for (int e = t; e < k; e += kLongThreads) A.order[b + e] = src[e];
    __syncthreads();
  }
}

inline bool args_ok(const BinArgs& a) {
  if (a.n_arr < 1 || a.n_arr > kMaxArrays || (a.dtype != 0 && a.dtype != 1) ||
      a.nx < 1 || a.ny < 1 || a.nz < 1 ||
      static_cast<long long>(a.nx) * a.ny * a.nz != a.ncells ||
      a.origin == nullptr || a.width == nullptr || a.overflow == nullptr ||
      a.rebuild == nullptr || a.partial == nullptr || a.ticket == nullptr ||
      a.nonfinite == nullptr)
    return false;
  for (int s = 0; s < a.n_arr; ++s) {
    const BinArray& A = a.arr[s];
    if (A.n < 0 || A.start == nullptr || A.end == nullptr ||
        A.count == nullptr || A.listed == nullptr || A.nlisted == nullptr ||
        (A.n > 0 && A.tmp == nullptr) ||
        (A.n > 0 && (A.x == nullptr || A.y == nullptr || A.z == nullptr ||
                     A.h == nullptr || A.ref == nullptr ||
                     A.cell == nullptr || A.order == nullptr)))
      return false;
  }
  return true;
}

template <typename T>
cudaError_t launch(const BinArgs& a, cudaStream_t st) {
  int nmax = 0;
  for (int s = 0; s < a.n_arr; ++s) nmax = max(nmax, a.arr[s].n);
  const int most = max(nmax, a.ncells);
  const int blocks =
      min(kReduceBlocks, max(1, (most + kThreads - 1) / kThreads));
  bin_reduce<T><<<blocks, kThreads, 0, st>>>(a);
  const dim3 by_particle((nmax + kThreads - 1) / kThreads, a.n_arr);
  if (nmax > 0) bin_count<T><<<by_particle, kThreads, 0, st>>>(a);
  const dim3 by_tile((a.ncells + kScanTile - 1) / kScanTile, a.n_arr);
  bin_scan<<<by_tile, kScanThreads, 0, st>>>(a);
  if (nmax > 0) bin_scatter<<<by_particle, kThreads, 0, st>>>(a);
  const dim3 by_cell((a.ncells + kThreads - 1) / kThreads, a.n_arr);
  bin_sort<<<by_cell, kThreads, 0, st>>>(a);
  bin_sort_listed<<<dim3(kLongBlocks, a.n_arr), kLongThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace bin

extern "C" {

int bin_cells_args_size() { return static_cast<int>(sizeof(BinArgs)); }

int bin_cells_launch(const BinArgs* args, void* stream) {
  const BinArgs a = *args;
  if (!bin::args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.dtype == 0 ? bin::launch<float>(a, st)
                                       : bin::launch<double>(a, st));
}

const char* bin_cells_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
