// K3 `ccl` and K6 `propagate`: connected components of each 64x64 needle
// mask, the findContours replacement.
//
// K3 replaces meterelf_tpu/ops/pallas_ccl.py propagate_quads
// (_ccl_kernel, pack_closed=True), the quad branch's CCL; K6 replaces
// pallas_ccl.py propagate (_ccl_kernel on the pair layout), the CCL of
// the general-geometry branch (components.analyze_batch). Both run the
// pass schedule of their reference, meterelf_tpu/ops/components.py
// _propagate_xla, in one kernel body; a compile-time flag picks the key:
// K3 okey3 = owner*8 + closed*4 + masked*2 + boundary, K6 okey =
// owner*4 + masked*2 + boundary (no closed bit). The TPU's pair layout
// [K/2, 64, 128] is not carried over: one CTA per window in both.
//   1. 8-connected labels (min flat index per component): each half-pass
//      is a 3x3 min glue, then segmented min sweeps along rows and then
//      columns, forward on even halves and backward on odd ones
//      (_ALT_DIRS), at most k_label halves;
//   2. the background 4-connected to beyond the dial disk ("outside"):
//      the same halves with any4 glue and segmented OR sweeps, at most
//      k_outside;
//   3. enclosed holes take the min label of their 3x3 neighbourhood, at
//      most k_fill passes;
//   4. the key, with owner 4096 off the support (masked | enclosed) and
//      boundary = masked next to outside (8-neighbourhood).
// A phase has converged when its last executed pass changed nothing. All
// passes are monotone (labels only fall, the outside only grows), so a
// pass that changes nothing is a fixpoint of every later pass: stopping
// there gives the state and the flag that running all `cap` passes gives.
//
// What bounds it on the H100: latency, not bytes or operations. A window
// is 16 KB in and 16 KB out, but a pass is a chain of dependent steps
// (glue, row sweep, column sweep) separated by barriers. The design keeps
// the whole window in one CTA's shared memory for every pass, rows padded
// to 65 words so that the 64 row sweepers hit 64 different banks, and
// exits each phase at its first pass that changes nothing
// (__syncthreads_or), so corpus windows pay 2-3 passes per phase. Many
// windows in flight per SM hide the barriers.
#include <cuda_runtime.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kStride = kWin + 1;  // padded shared row
constexpr int kThreads = 256;
constexpr int kPer = kPix / kThreads;  // cells per thread
constexpr int kBig = kPix;             // label sentinel

// cell j of thread t: flat index t + j*256, i.e. row t/64 + 4j, col t%64
__device__ __forceinline__ int cell_y(int tid, int j) {
  return (tid >> 6) + 4 * j;
}

// min over the in-window 3x3 neighbourhood (centre included)
__device__ __forceinline__ int min3x3(const int* f, int y, int x) {
  int v = f[y * kStride + x];
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= kWin) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= kWin) continue;
      v = min(v, f[yy * kStride + xx]);
    }
  }
  return v;
}

// segmented min sweep of one row (axis 0) or column (axis 1) over runs of
// cells where `in_run` is set; returns whether a value changed
__device__ bool min_sweep(int* f, const uint8_t* in_run, int line, int axis,
                          bool rev) {
  bool changed = false;
  int run = kBig;
  for (int s = 0; s < kWin; ++s) {
    const int t = rev ? kWin - 1 - s : s;
    const int p = axis == 0 ? line * kStride + t : t * kStride + line;
    if (in_run[p]) {
      const int v = f[p];
      if (run < v) {
        f[p] = run;
        changed = true;
      } else {
        run = v;
      }
    } else {
      run = kBig;
    }
  }
  return changed;
}

// segmented OR sweep over runs of background cells (m == 0)
__device__ bool or_sweep(uint8_t* o, const uint8_t* m, int line, int axis,
                         bool rev) {
  bool changed = false;
  uint8_t run = 0;
  for (int s = 0; s < kWin; ++s) {
    const int t = rev ? kWin - 1 - s : s;
    const int p = axis == 0 ? line * kStride + t : t * kStride + line;
    if (!m[p]) {
      if (run && !o[p]) {
        o[p] = 1;
        changed = true;
      }
      run |= o[p];
    } else {
      run = 0;
    }
  }
  return changed;
}

template <bool kClosedBit>
__global__ void __launch_bounds__(kThreads)
    ccl_kernel(const int32_t* __restrict__ bits, int k_label, int k_outside,
               int k_fill, int32_t* __restrict__ okey3,
               uint8_t* __restrict__ converged) {
  __shared__ int f[kWin * kStride];      // labels, then owners
  __shared__ uint8_t m[kWin * kStride];  // masked
  __shared__ uint8_t o[kWin * kStride];  // outside
  const int tid = threadIdx.x, x = tid & 63;
  const int32_t* in = bits + (size_t)blockIdx.x * kPix;

  int bv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int y = cell_y(tid, j), p = y * kStride + x;
    bv[j] = in[y * kWin + x];
    const int mk = bv[j] & 1;
    m[p] = mk;
    f[p] = mk ? y * kWin + x : kBig;
    o[p] = !mk && !(bv[j] & 2);
  }
  __syncthreads();

  // ---- 1. labels ----
  bool lab_conv = k_label == 0;
  for (int it = 0; it < k_label; ++it) {
    bool ch = false;
    int nv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int y = cell_y(tid, j);
      nv[j] = m[y * kStride + x] ? min3x3(f, y, x) : kBig;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = cell_y(tid, j) * kStride + x;
      if (nv[j] != f[p]) {
        f[p] = nv[j];
        ch = true;
      }
    }
    __syncthreads();
    const bool rev = it & 1;
    if (tid < kWin) ch |= min_sweep(f, m, tid, 0, rev);
    __syncthreads();
    if (tid < kWin) ch |= min_sweep(f, m, tid, 1, rev);
    if (!__syncthreads_or(ch)) {
      lab_conv = true;
      break;
    }
  }

  // ---- 2. outside flood ----
  bool out_conv = k_outside == 0;
  for (int it = 0; it < k_outside; ++it) {
    bool ch = false;
    uint8_t nv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int y = cell_y(tid, j), p = y * kStride + x;
      uint8_t v = o[p];
      if (!m[p] && !v) {
        v = (y > 0 && o[p - kStride]) || (y < kWin - 1 && o[p + kStride]) ||
            (x > 0 && o[p - 1]) || (x < kWin - 1 && o[p + 1]);
      }
      nv[j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = cell_y(tid, j) * kStride + x;
      if (nv[j] != o[p]) {
        o[p] = nv[j];
        ch = true;
      }
    }
    __syncthreads();
    const bool rev = it & 1;
    if (tid < kWin) ch |= or_sweep(o, m, tid, 0, rev);
    __syncthreads();
    if (tid < kWin) ch |= or_sweep(o, m, tid, 1, rev);
    if (!__syncthreads_or(ch)) {
      out_conv = true;
      break;
    }
  }

  // ---- 3. hole-ownership fill (f is kBig off the mask already) ----
  bool fill_conv = k_fill == 0;
  for (int it = 0; it < k_fill; ++it) {
    bool ch = false;
    int nv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int y = cell_y(tid, j), p = y * kStride + x;
      nv[j] = (!m[p] && !o[p]) ? min3x3(f, y, x) : f[p];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = cell_y(tid, j) * kStride + x;
      if (nv[j] != f[p]) {
        f[p] = nv[j];
        ch = true;
      }
    }
    if (!__syncthreads_or(ch)) {
      fill_conv = true;
      break;
    }
  }

  // ---- 4. okey3 ----
  int32_t* out = okey3 + (size_t)blockIdx.x * kPix;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int y = cell_y(tid, j), p = y * kStride + x;
    const int mk = m[p];
    int boundary = 0;
    if (mk) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= kWin) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= kWin) continue;
          boundary |= o[yy * kStride + xx];
        }
      }
    }
    const bool support = mk || !o[p];
    const int owner = support ? f[p] : kBig;
    if (kClosedBit) {
      const int closed = (bv[j] >> 2) & 1;
      out[y * kWin + x] = owner * 8 + closed * 4 + mk * 2 + boundary;
    } else {
      out[y * kWin + x] = owner * 4 + mk * 2 + boundary;
    }
  }
  if (tid == 0) converged[blockIdx.x] = lab_conv && out_conv && fill_conv;
}

}  // namespace

extern "C" int meterelf_ccl(const int32_t* bits, int K, int k_label,
                            int k_outside, int k_fill, int32_t* okey3,
                            uint8_t* converged, void* stream) {
  ccl_kernel<true><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      bits, k_label, k_outside, k_fill, okey3, converged);
  return (int)cudaGetLastError();
}

extern "C" int meterelf_propagate(const int32_t* bits, int K, int k_label,
                                  int k_outside, int k_fill, int32_t* okey,
                                  uint8_t* converged, void* stream) {
  ccl_kernel<false><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      bits, k_label, k_outside, k_fill, okey, converged);
  return (int)cudaGetLastError();
}
