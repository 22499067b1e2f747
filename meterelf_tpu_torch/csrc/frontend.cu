// K1 `frontend`: dial-cluster localisation for a batch of meter crops.
//
// Replaces meterelf_tpu/ops/pallas_frontend.py frontend_pallas
// (_frontend_core). Per image: the exact cv2 lightness L, the TM_CCOEFF
// score of the [th, tw] template at every valid offset, and the first
// maximum in row-major order (cv2.minMaxLoc).
//
// The score is computed exactly as the TPU kernel does (its module
// docstring, item 3): with both operands shifted by -128 they fit int8,
// so corr8 = sum (L-128)(T-128) is exact in i32 (|corr8| <= th*tw*128^2
// < 2^31), box' = sum (L-128) is exact, and
//     score = f32(corr8) + c1 * f32(box') + c0
// with each operation rounded once (c1 = 128 - tmean, c0 the f32 residual
// of the rounded template mean; both from the host in f64).
//
// What bounds it on the H100: int8 multiply-adds. 132 x 63 offsets x
// 119 x 188 taps = 186 M MACs per flagship image, 0.048 ms a batch of 256
// at the int8 tensor-core peak. The design puts them on Hopper's
// warpgroup product and keeps the image on the SM (corr_wgmma.cuh): one
// CTA of two warpgroups per image stages L - 128 as int8 in 16-byte
// column chunks that the tensor cores read by descriptor, and T - 128
// with zero margins from which each warp builds its rows of the band in
// registers, 105,872 bytes at the flagship shape (two CTAs an SM, so all
// 256 images of a batch are resident at once; the image is read from
// device memory once). Each warpgroup then runs half of the template
// rows as wgmma.m64n144k32 s8 products (an m64n128 and an m64n16 a k32
// step; x = 64 rows, y = oh rounded up to 16 columns, 8 k32 steps a
// template row): 952 steps a flagship image, 280.8 M MACs, 1.51x the
// MACs the function needs (the band's padding and the 12 y columns past
// oh). box' comes after the products from the same staged L' (a warp
// scan of each row, then column windows); corr8 goes to shared memory
// (the second warpgroup's half of the rows added to the first's), and
// every thread scores its share of the offsets and keeps their first
// maximum. Measured on an H100 SXM at 700 W (experiments/torch_k1_ab.py,
// 256 flagship crops): 0.166 ms, 178 SM clocks per k32 step and SM all
// told. The products take ~0.097 ms, ~100 clocks a step, as the loop
// alone does at four warpgroups an SM against 72 at the int8 peak
// (experiments/torch_wgmma_probe.py; a band built once, with no fence or
// wait, runs at ~85); the staging ~0.039 ms (reading the batch's 64 MB
// of crops takes 0.019 at 3.35 TB/s), box' ~0.019, the epilogue ~0.01:
// the two CTAs of an SM stage, multiply and reduce in step, so none of
// that is hidden behind the other's products.
// No superwindow is written: K2 reads the windows straight from the crop
// at (mx, my).
//
// K5 `frontend_windows` (frontend_kernel<true>) replaces
// meterelf_tpu/ops/pallas_frontend.py frontend_windows_pallas
// (_frontend_windows_kernel), the METERELF_FRONTEND=merged variant: the
// correlation and argmax of corr_mma.cuh's mma.sync.m16n8k32 loop
// (shared with K8 and K9; 162,804 bytes of staging at the flagship shape;
// on an H100 SXM at 700 W the loop spends ~5.3 SM clocks per mma where
// mma.sync alone sustains ~1.7, experiments/torch_corr_sweep.py: its
// shared-memory loads, ~3.6 wavefronts a mma, counted, not profiled, are
// the likeliest bound), then the same CTA reuses its shared memory for the
// 4 dial windows at (mx + ox, my + oy), through K2's body
// (window_bits.cuh: all four at once, 4 of its 16 warps a window, 2 KB of
// row words in the correlation's staging), and writes K2's bits layout.
// It is specialised to 4 dials, as the TPU kernel is. What it saves over
// K1 then K2: one launch and K2's second read of the window pixels (the
// crop is in L2 then anyway); its bound is K1's operations plus K2's. The
// TPU kernel's in-VMEM superwindow rotate and quad lane layout are not
// carried over.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#include "corr_mma.cuh"
#include "corr_wgmma.cuh"
#include "exact_color.cuh"
#include "meterelf_kernels.h"
#include "window_bits.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kDials = 4;  // K5's dial count (pallas_frontend.py:498)

struct WinGeom4 {
  int ox[kDials], oy[kDials];  // window origin, template coords
  int cx[kDials], cy[kDials];  // dial center, window coords
  int cr[kDials][3];           // color range (h, l, s)
};

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// L' = L - 128 of a packed pixel
struct LightnessL8 {
  __device__ int operator()(int p) const {
    return meterelf_lightness(p) - 128;
  }
};

// K1: the first maximum of the score over the block's offsets, with
// ties to the smaller row-major index. NB = n / 8 column blocks; two CTAs
// an SM where the accumulators (4 NB registers) leave room.
template <int NB>
__global__ void __launch_bounds__(corrwg::kThreads, NB <= 18 ? 2 : 1)
    frontend_kernel_wgmma(const int32_t* __restrict__ packed, int H, int W,
                          const uint8_t* __restrict__ tmpl, int th, int tw,
                          float c1, float c0, float* __restrict__ max_val,
                          int32_t* __restrict__ out_mx,
                          int32_t* __restrict__ out_my) {
  extern __shared__ __align__(128) unsigned char smem[];
  const corrwg::Layout g = corrwg::layout(H, W, th, tw);
  corrwg::stage(smem, g, packed + (size_t)blockIdx.x * H * W, tmpl, th, tw,
                LightnessL8());
  float best = -FLT_MAX;
  int best_i = INT_MAX;
  corrwg::correlate<NB>(smem, g, th, tw, [&](int y, int x, int acc,
                                             int box) {
    const float s = __fadd_rn(
        __fadd_rn(__int2float_rn(acc), __fmul_rn(c1, __int2float_rn(box))),
        c0);
    const int i = y * g.ow + x;
    if (better(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  });
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }
  __shared__ float red_s[corrwg::kWarps];
  __shared__ int red_i[corrwg::kWarps];
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = best;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < corrwg::kWarps; ++w) {
      if (better(red_s[w], red_i[w], best, best_i)) {
        best = red_s[w];
        best_i = red_i[w];
      }
    }
    max_val[blockIdx.x] = best;
    out_mx[blockIdx.x] = best_i % g.ow;
    out_my[blockIdx.x] = best_i / g.ow;
  }
}

template <bool kWindows>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const int32_t* __restrict__ packed, int H, int W,
                    const uint8_t* __restrict__ tmpl, int th, int tw,
                    float c1, float c0, float* __restrict__ max_val,
                    int32_t* __restrict__ out_mx,
                    int32_t* __restrict__ out_my, WinGeom4 wg,
                    const uint8_t* __restrict__ disk, int hue_shift,
                    int32_t* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const corr8::Layout g = corr8::layout(H, W, th, tw);
  int8_t* sL = reinterpret_cast<int8_t*>(smem);
  const int ow = g.ow;
  const int tid = threadIdx.x;
  const int32_t* img = packed + (size_t)blockIdx.x * H * W;

  // stage L - 128 (zero past row H and column W), then T - 128 and P
  for (int i = tid; i < g.lrows * g.ls; i += kThreads) {
    const int y = i / g.ls, x = i - y * g.ls;
    sL[i] = (int8_t)(y < H && x < W
                         ? meterelf_lightness(img[y * W + x]) - 128 : 0);
  }
  corr8::stage_template_and_sums(smem, g, H, tmpl, th, tw, kThreads);

  float best = -FLT_MAX;
  int best_i = INT_MAX;
  corr8::correlate<kThreads / 32>(smem, g, th, [&](int y, int x, int acc) {
    const float s = __fadd_rn(
        __fadd_rn(__int2float_rn(acc),
                  __fmul_rn(c1, __int2float_rn(corr8::box(smem, g, th, y,
                                                          x)))),
        c0);
    const int i = y * ow + x;
    if (better(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  });

  // block argmax, ties to the smaller row-major index
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }
  __shared__ float red_s[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_mx, s_my;
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = best;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      if (better(red_s[w], red_i[w], best, best_i)) {
        best = red_s[w];
        best_i = red_i[w];
      }
    }
    max_val[blockIdx.x] = best;
    out_mx[blockIdx.x] = s_mx = best_i % ow;
    out_my[blockIdx.x] = s_my = best_i / ow;
  }
  if constexpr (kWindows) {
    // every thread is past the correlation: its staging is free again
    __syncthreads();
    // the 4 windows at once, 4 warps a window
    constexpr int kWarps = kThreads / 32;
    const int d = (tid >> 5) / (kWarps / kDials);
    winbits::Win w;
    w.W = W;
    w.img = img + (size_t)(s_my + wg.oy[d]) * W + s_mx + wg.ox[d];
    w.sx = winbits::sample_start(wg.cx[d]);
    w.sy = winbits::sample_start(wg.cy[d]);
    for (int c = 0; c < 3; ++c) w.cr[c] = wg.cr[d][c];
    w.dk = disk + (size_t)d * winbits::kPix;
    w.out = bits + ((size_t)blockIdx.x * kDials + d) * winbits::kPix;
    winbits::window_bits<kWarps, kDials>(reinterpret_cast<uint64_t*>(smem),
                                         w, hue_shift);
  }
}

int frontend_windows_smem(int H, int W, int th, int tw) {
  const int bytes = corr8::layout(H, W, th, tw).bytes;
  const int win = winbits::smem_bytes(kDials);
  return win > bytes ? win : bytes;
}

template <int NB>
int launch_k1(const int32_t* packed, int B, int H, int W, const uint8_t* tmpl,
              int th, int tw, float c1, float c0, float* max_val, int32_t* mx,
              int32_t* my, int bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel_wgmma<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  frontend_kernel_wgmma<NB><<<B, corrwg::kThreads, bytes,
                              (cudaStream_t)stream>>>(
      packed, H, W, tmpl, th, tw, c1, c0, max_val, mx, my);
  return (int)cudaGetLastError();
}

int launch_k5(const int32_t* packed, int B, int H, int W, const uint8_t* tmpl,
              int th, int tw, float c1, float c0, float* max_val, int32_t* mx,
              int32_t* my, const WinGeom4& wg, const uint8_t* disk,
              int hue_shift, int32_t* bits, void* stream) {
  const int bytes = frontend_windows_smem(H, W, th, tw);
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  frontend_kernel<true><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      packed, H, W, tmpl, th, tw, c1, c0, max_val, mx, my, wg, disk,
      hue_shift, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int meterelf_frontend_smem_bytes(int H, int W, int th, int tw) {
  return corrwg::layout(H, W, th, tw).bytes;
}

extern "C" int meterelf_frontend(const int32_t* packed, int B, int H, int W,
                                 const uint8_t* tmpl, int th, int tw,
                                 float c1, float c0, float* max_val,
                                 int32_t* mx, int32_t* my, void* stream) {
  const corrwg::Layout g = corrwg::layout(H, W, th, tw);
  if (g.bytes < 0) return (int)cudaErrorInvalidValue;
#define K1_CASE(C)                                                        \
  case C:                                                                 \
    return launch_k1<2 * C>(packed, B, H, W, tmpl, th, tw, c1, c0, max_val, \
                            mx, my, g.bytes, stream);
  switch (g.n / 16) {  // n = 16 .. 208
    K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6)
    K1_CASE(7) K1_CASE(8) K1_CASE(9) K1_CASE(10) K1_CASE(11) K1_CASE(12)
    K1_CASE(13)
  }
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int meterelf_frontend_windows(
    const int32_t* packed, int B, int H, int W, const uint8_t* tmpl, int th,
    int tw, float c1, float c0, const int32_t* geom, const uint8_t* disk,
    int hue_shift, float* max_val, int32_t* mx, int32_t* my, int32_t* bits,
    void* stream) {
  WinGeom4 wg;
  for (int d = 0; d < kDials; ++d) {
    const int32_t* q = geom + 7 * d;
    wg.ox[d] = q[0];
    wg.oy[d] = q[1];
    wg.cx[d] = q[2];
    wg.cy[d] = q[3];
    for (int c = 0; c < 3; ++c) wg.cr[d][c] = q[4 + c];
  }
  return launch_k5(packed, B, H, W, tmpl, th, tw, c1, c0, max_val, mx, my,
                   wg, disk, hue_shift, bits, stream);
}
