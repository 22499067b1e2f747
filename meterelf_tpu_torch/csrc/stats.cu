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
// What bounds it on the H100: shared-memory atomics, at most 2 per pixel
// on a 16 KB window. The design is one CTA per window with both
// 4096-bin histograms in shared memory (32 KB), the owner plane staged as
// u16, and one block max. The TPU kernel's one-hot matmuls and row_spans
// restriction exist for its matrix unit and are not carried over.
//
// K7 `stats_select` (the same kernel, kContribIn = true) replaces
// meterelf_tpu/ops/pallas_stats.py stats_select (_stats_kernel), the
// METERELF_QUAD_STATS=hist_pallas variant. Its okey is owner*4 +
// masked*2 + boundary (K6's key) and the cell contributions come in
// beside it, computed outside the kernel as the JAX graph does
// (components.cell_contrib): bcount and area2 = sum (contrib & 3) are
// binned under each pixel's own owner (owner 4096 drops out), and only
// keymax is written. Its bound is its bytes (two i32 planes read).
#include <cuda_runtime.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kThreads = 256;

// kContribIn = false: K4, okey3 in, contributions from the owner plane,
// keymax and has_any out. kContribIn = true: K7, okey and contrib in,
// keymax out.
template <bool kContribIn>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const int32_t* __restrict__ okey,
                 const int32_t* __restrict__ contrib,
                 int32_t* __restrict__ keymax,
                 uint8_t* __restrict__ has_any) {
  __shared__ int bcount[kPix];
  __shared__ int area2[kPix];
  __shared__ uint16_t own[kPix];
  __shared__ int red[kThreads / 32];
  const int tid = threadIdx.x;
  const int32_t* ok = okey + (size_t)blockIdx.x * kPix;
  constexpr int kShift = kContribIn ? 2 : 3;

  int any = 0;
  for (int i = tid; i < kPix; i += kThreads) {
    const int v = ok[i];
    bcount[i] = 0;
    area2[i] = 0;
    own[i] = (uint16_t)min((unsigned)v >> kShift, (unsigned)kPix);
    any |= (v >> 1) & 1;
  }
  __syncthreads();
  for (int i = tid; i < kPix; i += kThreads) {
    const int o = own[i];
    if (o < kPix && (ok[i] & 1)) atomicAdd(&bcount[o], 1);
    if constexpr (kContribIn) {
      const int c = contrib[(size_t)blockIdx.x * kPix + i] & 3;
      if (o < kPix && c) atomicAdd(&area2[o], c);
    } else {
      const int r = i >> 6, c = i & 63;
      if (r < kWin - 1 && c < kWin - 1) {
        const int o00 = o, o01 = own[i + 1];
        const int o10 = own[i + kWin], o11 = own[i + kWin + 1];
        const int mn = min(min(o00, o01), min(o10, o11));
        if (mn < kPix) {
          const int k = (o00 == mn) + (o01 == mn) + (o10 == mn) + (o11 == mn);
          const int cls = k == 4 ? 2 : (k == 3 ? 1 : 0);
          if (cls) atomicAdd(&area2[mn], cls);
        }
      }
    }
  }
  __syncthreads();

  int best = -1;
  for (int o = tid; o < kPix; o += kThreads) {
    if (bcount[o] > 0) best = max(best, area2[o] * kPix + o);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((tid & 31) == 0) red[tid >> 5] = best;
  any = __syncthreads_or(any);
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) best = max(best, red[w]);
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
