// K8 `match_scores`: the full TM_CCOEFF score map of each image.
//
// Replaces meterelf_tpu/ops/pallas_match2.py match_scores_pallas_fused
// (_fused_kernel): lightness [B, H, W] f32 (integer values 0..255),
// template [th, tw] u8, tmean f32 -> scores = corr - tmean * box as f32
// [B, oh, ow], where corr = sum L*T and box = sum L over the template
// window at each offset. The scorer-only decode branch takes it
// (pipeline/decode.py) and locates the first maximum afterwards.
//
// Exactness: with L' = L - 128 and T' = T - 128 (int8),
//     corr = sum L'T' + 128 * sum L' + 128 * Tsum,   box = sum L' + 128*N,
// and |corr| <= th * tw * 255^2 < 2^31 inside the gate (th <= 128,
// tw <= 192), so corr and box are exact integers, and
//     score = f32(corr) - tmean * f32(box)
// with each operation rounded once (__fmul_rn, __fsub_rn; --fmad=false).
// The TPU kernel sums its 119 row partials in f32, so its map differs
// from this one in the last bits (tests/test_torch_general.py states the
// measured tolerance); the plain version (ops/match.py) equals this one
// bit for bit.
//
// What bounds it on the H100: int8 multiply-adds, as K1 (47.63 G MACs per
// flagship batch of 256, 0.048 ms at the int8 tensor-core peak). The
// design is K1's: one CTA per image stages L' and T' in shared memory
// (162,804 bytes at the flagship shape), and the implicit GEMM of
// corr_mma.cuh runs the correlation on the int8 tensor cores
// (mma.sync.m16n8k32, 1.25x the function's MACs with the band's padding);
// each lane writes the map from its accumulators instead of an argmax.
// As in K1, the shared-memory loads beside each mma (one ldmatrix, a
// share of the band's), not the tensor cores, are the likeliest bound of
// the loop (frontend.cu).
//
// K9 `match_corr` (the same kernel, kScore = false) replaces
// meterelf_tpu/ops/pallas_match.py match_scores_pallas (_corr_kernel),
// the v1 scorer, which only the tests and experiments call: the exact
// corr = sum L*T as an i32, written once as f32 [B, oh, ow] (rounded to
// nearest). The box sum and corr - tmean * box stay outside, in torch, as
// the JAX function keeps them outside its kernel (ops/match.py
// match_scores_v1). Its bound is K8's operations.
#include <cuda_runtime.h>

#include "corr_mma.cuh"
#include "meterelf_kernels.h"

namespace {

constexpr int kThreads = 512;

template <bool kScore>
__global__ void __launch_bounds__(kThreads)
    match_kernel(const float* __restrict__ lightness, int H, int W,
                 const uint8_t* __restrict__ tmpl, int th, int tw,
                 int tsum, float tmean, float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const corr8::Layout g = corr8::layout(H, W, th, tw);
  int8_t* sL = reinterpret_cast<int8_t*>(smem);
  const int ow = g.ow;
  const int tid = threadIdx.x;
  const float* img = lightness + (size_t)blockIdx.x * H * W;

  for (int i = tid; i < g.lrows * g.ls; i += kThreads) {
    const int y = i / g.ls, x = i - y * g.ls;
    sL[i] = (int8_t)(y < H && x < W ? (int)img[y * W + x] - 128 : 0);
  }
  corr8::stage_template_and_sums(smem, g, H, tmpl, th, tw, kThreads);

  const unsigned n128 = 128u * (unsigned)(th * tw);
  const unsigned t128 = 128u * (unsigned)tsum;
  float* out = scores + (size_t)blockIdx.x * g.oh * ow;
  corr8::correlate<kThreads / 32>(smem, g, th, [&](int y, int x, int acc) {
    const unsigned box = (unsigned)corr8::box(smem, g, th, y, x);
    // unsigned: the terms wrap, the sum is the exact corr < 2^31
    const int corr = (int)((unsigned)acc + 128u * box + t128);
    if constexpr (kScore) {
      const int bx = (int)(box + n128);
      out[y * ow + x] = __fsub_rn(__int2float_rn(corr),
                                  __fmul_rn(tmean, __int2float_rn(bx)));
    } else {
      out[y * ow + x] = __int2float_rn(corr);
    }
  });
}

template <bool kScore>
int launch(const float* lightness, int B, int H, int W, const uint8_t* tmpl,
           int th, int tw, int tsum, float tmean, float* out, void* stream) {
  const int bytes = corr8::layout(H, W, th, tw).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      match_kernel<kScore>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  match_kernel<kScore><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      lightness, H, W, tmpl, th, tw, tsum, tmean, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int meterelf_match_scores(const float* lightness, int B, int H,
                                     int W, const uint8_t* tmpl, int th,
                                     int tw, int tsum, float tmean,
                                     float* scores, void* stream) {
  return launch<true>(lightness, B, H, W, tmpl, th, tw, tsum, tmean, scores,
                      stream);
}

extern "C" int meterelf_match_corr(const float* lightness, int B, int H,
                                   int W, const uint8_t* tmpl, int th, int tw,
                                   int tsum, float* corr, void* stream) {
  return launch<false>(lightness, B, H, W, tmpl, th, tw, tsum, 0.0f, corr,
                       stream);
}
