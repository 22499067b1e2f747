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
// What bounds it on the H100: integer multiply-adds. 132 x 63 offsets x
// 119 x 188 taps = 186 M MACs per flagship image. The design keeps it on
// the SM: one CTA per image stages L-128 and T-128 as int8 in shared
// memory, beside the per-row window sums of L-128 (153,400 bytes at the
// flagship shape, so the image is read from device memory once), and each
// thread computes 4 neighbouring x offsets with __dp4a (4 MACs per
// instruction) from two 32-bit shared loads and three byte permutes per
// template word. The box sum comes from per-row window sums staged once
// per image. No superwindow is written: K2 reads the windows straight
// from the crop at (mx, my).
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#include "exact_color.cuh"
#include "meterelf_kernels.h"

namespace {

constexpr int kThreads = 512;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct FrontendLayout {
  int ls;        // bytes per staged L row (>= W + 8, 16-aligned)
  int ts;        // bytes per staged template row (tw rounded up to 4)
  int off_t;     // byte offset of the template
  int off_rw;    // byte offset of the row-window sums
  int bytes;     // total dynamic shared memory
};

__host__ __device__ inline FrontendLayout frontend_layout(int H, int W,
                                                          int th, int tw) {
  FrontendLayout g;
  const int ow = W - tw + 1;
  g.ls = round_up(W + 8, 16);
  g.ts = round_up(tw, 4);
  g.off_t = H * g.ls;
  g.off_rw = round_up(g.off_t + th * g.ts, 16);
  // + 4 ints: the last x group may read up to 3 sums past the end
  g.bytes = g.off_rw + (H * ow + 4) * 4;
  return g;
}

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const int32_t* __restrict__ packed, int H, int W,
                    const uint8_t* __restrict__ tmpl, int th, int tw,
                    float c1, float c0, float* __restrict__ max_val,
                    int32_t* __restrict__ out_mx,
                    int32_t* __restrict__ out_my) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FrontendLayout g = frontend_layout(H, W, th, tw);
  int8_t* sL = reinterpret_cast<int8_t*>(smem);
  int8_t* sT = reinterpret_cast<int8_t*>(smem + g.off_t);
  int* sRW = reinterpret_cast<int*>(smem + g.off_rw);
  const int oh = H - th + 1, ow = W - tw + 1;
  const int tid = threadIdx.x;
  const int32_t* img = packed + (size_t)blockIdx.x * H * W;

  // stage L - 128 (zero past column W) and T - 128 (zero past tw)
  for (int i = tid; i < H * g.ls; i += kThreads) {
    const int y = i / g.ls, x = i - y * g.ls;
    sL[i] = (int8_t)(x < W ? meterelf_lightness(img[y * W + x]) - 128 : 0);
  }
  for (int i = tid; i < th * g.ts; i += kThreads) {
    const int y = i / g.ts, x = i - y * g.ts;
    sT[i] = (int8_t)(x < tw ? (int)tmpl[y * tw + x] - 128 : 0);
  }
  __syncthreads();

  // row-window sums: sRW[y, x] = sum_{c < tw} (L-128)[y, x + c]
  for (int y = tid; y < H; y += kThreads) {
    const int8_t* row = sL + y * g.ls;
    int s = 0;
    for (int c = 0; c < tw; ++c) s += row[c];
    sRW[y * ow] = s;
    for (int x = 1; x < ow; ++x) {
      s += row[x + tw - 1] - row[x - 1];
      sRW[y * ow + x] = s;
    }
  }
  if (tid < 4) sRW[H * ow + tid] = 0;
  __syncthreads();

  // correlation: work item = (y, group of 4 x offsets)
  const int ngx = (ow + 3) / 4;
  const int nwords = g.ts / 4;
  float best = -FLT_MAX;
  int best_i = INT_MAX;
  for (int it = tid; it < oh * ngx; it += kThreads) {
    const int y = it / ngx;
    const int x0 = (it - y * ngx) * 4;
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    for (int r = 0; r < th; ++r) {
      const int* lrow = reinterpret_cast<const int*>(sL + (y + r) * g.ls + x0);
      const int* trow = reinterpret_cast<const int*>(sT + r * g.ts);
      int w0 = lrow[0];
      for (int cw = 0; cw < nwords; ++cw) {
        const int w1 = lrow[cw + 1];
        const int t = trow[cw];
        a0 = __dp4a(w0, t, a0);
        a1 = __dp4a((int)__byte_perm(w0, w1, 0x4321), t, a1);
        a2 = __dp4a((int)__byte_perm(w0, w1, 0x5432), t, a2);
        a3 = __dp4a((int)__byte_perm(w0, w1, 0x6543), t, a3);
        w0 = w1;
      }
      const int* rw = sRW + (y + r) * ow + x0;
      b0 += rw[0];
      b1 += rw[1];
      b2 += rw[2];
      b3 += rw[3];
    }
    const int acc[4] = {a0, a1, a2, a3};
    const int box[4] = {b0, b1, b2, b3};
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      if (x0 + dx < ow) {
        const float s = __fadd_rn(
            __fadd_rn(__int2float_rn(acc[dx]),
                      __fmul_rn(c1, __int2float_rn(box[dx]))),
            c0);
        const int i = y * ow + x0 + dx;
        if (better(s, i, best, best_i)) {
          best = s;
          best_i = i;
        }
      }
    }
  }

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
    out_mx[blockIdx.x] = best_i % ow;
    out_my[blockIdx.x] = best_i / ow;
  }
}

}  // namespace

extern "C" int meterelf_frontend_smem_bytes(int H, int W, int th, int tw) {
  return frontend_layout(H, W, th, tw).bytes;
}

extern "C" int meterelf_frontend(const int32_t* packed, int B, int H, int W,
                                 const uint8_t* tmpl, int th, int tw,
                                 float c1, float c0, float* max_val,
                                 int32_t* mx, int32_t* my, void* stream) {
  const int bytes = frontend_layout(H, W, th, tw).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  frontend_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      packed, H, W, tmpl, th, tw, c1, c0, max_val, mx, my);
  return (int)cudaGetLastError();
}
