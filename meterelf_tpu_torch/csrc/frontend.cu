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
// at the int8 tensor-core peak. The design puts them on the tensor cores
// and keeps the image on the SM: one CTA per image stages L-128 and T-128
// as int8 in shared memory beside the column prefix of the row-window
// sums of L-128 (162,804 bytes at the flagship shape, so the image is read
// from device memory once), and its 16 warps run the correlation as an
// implicit GEMM of mma.sync.m16n8k32 int8 instructions (corr_mma.cuh,
// shared with K8 and K9): 56,644 a flagship image, 4,096 MACs each, 1.25x
// the MACs the function needs (the band's padding). Beside each mma a
// warp issues one ldmatrix and its share of the band fragment's shared
// loads; the score and the argmax run on the accumulators in registers.
// On an H100 SXM at 700 W the loop spends ~5.3 SM clocks per mma where
// mma.sync alone sustains ~1.7 (experiments/torch_corr_sweep.py): those
// shared-memory loads (~3.6 wavefronts a mma, counted, not profiled) are
// the likeliest bound now, beside ~0.05 ms a batch of serial staging.
// No superwindow is written: K2 reads the windows straight from the crop
// at (mx, my).
//
// K5 `frontend_windows` (the same kernel, kWindows = true) replaces
// meterelf_tpu/ops/pallas_frontend.py frontend_windows_pallas
// (_frontend_windows_kernel), the METERELF_FRONTEND=merged variant: after
// K1's correlation and argmax the same CTA reuses its shared memory for the
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

int frontend_smem(int H, int W, int th, int tw, bool windows) {
  const int bytes = corr8::layout(H, W, th, tw).bytes;
  const int win = winbits::smem_bytes(kDials);
  return windows && win > bytes ? win : bytes;
}

template <bool kWindows>
int launch(const int32_t* packed, int B, int H, int W, const uint8_t* tmpl,
           int th, int tw, float c1, float c0, float* max_val, int32_t* mx,
           int32_t* my, const WinGeom4& wg, const uint8_t* disk,
           int hue_shift, int32_t* bits, void* stream) {
  const int bytes = frontend_smem(H, W, th, tw, kWindows);
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel<kWindows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  frontend_kernel<kWindows><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      packed, H, W, tmpl, th, tw, c1, c0, max_val, mx, my, wg, disk,
      hue_shift, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int meterelf_frontend_smem_bytes(int H, int W, int th, int tw) {
  return frontend_smem(H, W, th, tw, false);
}

extern "C" int meterelf_frontend(const int32_t* packed, int B, int H, int W,
                                 const uint8_t* tmpl, int th, int tw,
                                 float c1, float c0, float* max_val,
                                 int32_t* mx, int32_t* my, void* stream) {
  return launch<false>(packed, B, H, W, tmpl, th, tw, c1, c0, max_val, mx,
                       my, WinGeom4{}, nullptr, 0, nullptr, stream);
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
  return launch<true>(packed, B, H, W, tmpl, th, tw, c1, c0, max_val, mx, my,
                      wg, disk, hue_shift, bits, stream);
}
