// K4 `stats`: largest-contour selection per window.
//
// Replaces meterelf_tpu/ops/pallas_stats.py stats_select_fused
// (_stats_fused_kernel). From okey3 (owner*8 + closed*4 + masked*2 +
// boundary, owner 4096 off the support):
//   - bcount[owner] = boundary pixels of the owner (> 0 marks a top-level
//     component, the contours RETR_EXTERNAL lists);
//   - area2[owner] = doubled contourArea by the marching-squares rule of
//     components._cell_contrib: each 2x2 cell (r < 63, c < 63) whose
//     corner minimum m is an owner adds 2 if all four corners equal m and
//     1 if three do;
//   - keymax = max(area2*4096 + owner) over owners with bcount > 0, else
//     -1 (larger owner on area ties, as Python's stable sort);
//   - has_any = any masked pixel.
// Integer atomics make both histograms exact and independent of order.
// They give the per-owner totals of the TPU kernel, which assigns each
// cell's value to its first corner equal to m in raster order.
//
// What bounds it on the H100: its bytes, 16 KB read a window (0.005 ms for
// the flagship's 1024 windows); then shared-memory atomics, which
// serialise where the lanes of a warp add to one bin. The design: one CTA
// of 256 threads a window, one packed counter a bin (area2 << 16 |
// bcount: bcount <= 4096 and area2 <= 12288 never carry), so the bins take
// 16 KB and 8 CTAs (one wave of the flagship's windows) fit an SM. Each
// warp walks a band of 8 rows, a lane holding columns 2l and 2l + 1 of a
// row in registers: okey3 is read once, the cell's right corners come
// from the next lane by shuffle and its lower ones from the next row,
// loaded ahead (a band reads one row past its end). A lane sums what its
// two pixels and two cells add to one owner (an item of another owner,
// met where two owners meet, takes its own atomic), and a segmented sum
// over runs of equal owners across the warp's lanes leaves one atomicAdd
// a run (one reduction where the warp's row meets one owner). Rows that
// touch no owner skip all of it (warp-uniform). keymax
// is one scan of the 4096 packed bins. The TPU kernel's one-hot matmuls
// and row_spans restriction exist for its matrix unit and are not carried
// over.
//
// K7 `stats_select` (the same kernel, kContribIn = true) replaces
// meterelf_tpu/ops/pallas_stats.py stats_select (_stats_kernel), the
// METERELF_QUAD_STATS=hist_pallas variant. Its okey is owner*4 +
// masked*2 + boundary (K6's key) and the cell contributions come in
// beside it, computed outside the kernel as the JAX graph does
// (components.cell_contrib): each pixel adds (contrib & 3) << 16 |
// boundary to its own owner's bin in one atomic (owner 4096 drops out),
// aggregated over runs as K4's, and only keymax is written. Its bound is
// its bytes (two i32 planes read).
#include <cuda_runtime.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWin / kWarps;   // rows of one warp
constexpr int kAhead = 4;              // rows loaded ahead
constexpr unsigned kFull = 0xffffffffu;

// Adds each lane's packed value v to bins[key] (key kPix: nothing), one
// atomic a run of equal keys over consecutive lanes: a suffix sum inside
// each run leaves the run's total in its first lane. A warp whose keys
// are one owner and nothing takes one reduction.
__device__ __forceinline__ void add_runs(uint32_t* bins, int key,
                                         uint32_t v) {
  const int lane = threadIdx.x & 31;
  // one owner across the warp (the others nothing): one sum, one atomic
  const int kmin = __reduce_min_sync(kFull, key);
  if (__all_sync(kFull, key == kmin || key == kPix)) {
    const uint32_t t = __reduce_add_sync(kFull, key == kmin ? v : 0u);
    if (lane == 0 && kmin < kPix && t) atomicAdd(&bins[kmin], t);
    return;
  }
  const int prev = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned later = lane == 31 ? 0u : heads & (~0u << (lane + 1));
  const int end = later ? __ffs(later) - 1 : 32;  // the next run's first lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += t;
  }
  if (head && key < kPix && v) atomicAdd(&bins[key], v);
}

// The lane's item: the first (key, value) it meets sets its key, later
// ones of the same key add to it, and one of another key takes its own
// atomic at once.
struct Item {
  int key = kPix;
  uint32_t v = 0;
  __device__ __forceinline__ void add(uint32_t* bins, int k, uint32_t x) {
    if (!x) return;
    if (key == kPix) key = k;
    if (k == key) {
      v += x;
    } else {
      atomicAdd(&bins[k], x);
    }
  }
};

__device__ __forceinline__ int owner_of(int v, int shift) {
  return (int)min((unsigned)v >> shift, (unsigned)kPix);
}

// The marching-squares class of a 2x2 cell whose corners have owners
// a, b (top) and c, d (bottom): 2 if all four equal their minimum m, 1 if
// three do, else 0 (also when m is the sentinel); m in mn.
__device__ __forceinline__ uint32_t cell_class(int a, int b, int c, int d,
                                               int& mn) {
  mn = min(min(a, b), min(c, d));
  const int k = (a == mn) + (b == mn) + (c == mn) + (d == mn);
  return mn < kPix && k >= 3 ? (uint32_t)(k - 2) : 0u;
}

// Row r of a window as a lane holds it: columns 2l and 2l + 1, or the
// sentinel owner's key past the last row.
__device__ __forceinline__ int2 load_row(const int32_t* plane, int r,
                                         int fill) {
  const int lane = threadIdx.x & 31;
  return r < kWin ? *reinterpret_cast<const int2*>(plane + r * kWin + 2 * lane)
                  : make_int2(fill, fill);
}

// kContribIn = false: K4, okey3 in, contributions from the owner plane,
// keymax and has_any out. kContribIn = true: K7, okey and contrib in,
// keymax out.
template <bool kContribIn>
__global__ void __launch_bounds__(kThreads, 8)
    stats_kernel(const int32_t* __restrict__ okey,
                 const int32_t* __restrict__ contrib,
                 int32_t* __restrict__ keymax,
                 uint8_t* __restrict__ has_any) {
  __shared__ __align__(16) uint32_t bins[kPix];  // area2 << 16 | bcount
  __shared__ int red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* ok = okey + (size_t)blockIdx.x * kPix;
  const int32_t* ct = kContribIn ? contrib + (size_t)blockIdx.x * kPix : ok;
  constexpr int kShift = kContribIn ? 2 : 3;
  constexpr int kSentinel = kPix << kShift;  // okey of owner 4096
  // K4 reads one row past its band (the cells' lower corners)
  constexpr int kLoad = kContribIn ? kRows : kRows + 1;
  const int r0 = warp * kRows;

  int2 o[kLoad], c[kContribIn ? kRows : 1];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    o[i] = load_row(ok, r0 + i, kSentinel);
    if constexpr (kContribIn) c[i] = load_row(ct, r0 + i, 0);
  }
  for (int i = tid; i < kPix / 4; i += kThreads)
    reinterpret_cast<uint4*>(bins)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  int any = 0;
#if !defined(K4_PHASES) || K4_PHASES == 1
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i + kAhead < kLoad) {
      o[i + kAhead] = load_row(ok, r0 + i + kAhead, kSentinel);
      if constexpr (kContribIn)
        c[i + kAhead] = load_row(ct, r0 + i + kAhead, 0);
    }
    const int a0 = owner_of(o[i].x, kShift), a1 = owner_of(o[i].y, kShift);
    Item it;
    if constexpr (kContribIn) {
      it.add(bins, a0, a0 < kPix ? (uint32_t)(c[i].x & 3) << 16 |
                                       (o[i].x & 1) : 0u);
      it.add(bins, a1, a1 < kPix ? (uint32_t)(c[i].y & 3) << 16 |
                                       (o[i].y & 1) : 0u);
      if (__any_sync(kFull, it.key < kPix)) add_runs(bins, it.key, it.v);
    } else {
      any |= (o[i].x | o[i].y) >> 1 & 1;
      // the row below (the sentinel under row 63 gives class 0)
      const int b0 = owner_of(o[i + 1].x, kShift);
      const int b1 = owner_of(o[i + 1].y, kShift);
      if (__any_sync(kFull, min(min(a0, a1), min(b0, b1)) < kPix)) {
        // column 2l + 2 from the next lane (none right of column 63)
        int a2 = __shfl_down_sync(kFull, a0, 1);
        int b2 = __shfl_down_sync(kFull, b0, 1);
        if (lane == 31) a2 = b2 = kPix;
        int m0, m1;
        const uint32_t k0 = cell_class(a0, a1, b0, b1, m0);
        const uint32_t k1 = cell_class(a1, a2, b1, b2, m1);
        it.add(bins, a0, a0 < kPix ? (uint32_t)(o[i].x & 1) : 0u);
        it.add(bins, m0, k0 << 16);
        it.add(bins, a1, a1 < kPix ? (uint32_t)(o[i].y & 1) : 0u);
        it.add(bins, m1, k1 << 16);
        add_runs(bins, it.key, it.v);
      }
    }
  }
  __syncthreads();
#endif

  int best = -1;
#if !defined(K4_PHASES) || K4_PHASES == 2
#pragma unroll
  for (int j = 0; j < kPix / 4 / kThreads; ++j) {
    const int q = tid + j * kThreads;
    const uint4 v = reinterpret_cast<const uint4*>(bins)[q];
    const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e[u] & 0xffffu)
        best = max(best, (int)(e[u] >> 16) * kPix + 4 * q + u);
  }
#else
  best = bins[tid];
#endif
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) red[warp] = best;
  any = __syncthreads_or(any);
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) best = max(best, red[w]);
    keymax[blockIdx.x] = best;
    if constexpr (!kContribIn) has_any[blockIdx.x] = any != 0;
  }
}

}  // namespace

extern "C" int meterelf_stats(const int32_t* okey3, int K, int32_t* keymax,
                              uint8_t* has_any, void* stream) {
  stats_kernel<false><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      okey3, nullptr, keymax, has_any);
  return (int)cudaGetLastError();
}

extern "C" int meterelf_stats_select(const int32_t* okey,
                                     const int32_t* contrib, int K,
                                     int32_t* keymax, void* stream) {
  stats_kernel<true><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      okey, contrib, keymax, nullptr);
  return (int)cudaGetLastError();
}
