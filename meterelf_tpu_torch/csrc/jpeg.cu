// K10 `backhalf_planes` and K11 `upsample_color_pack`: the JPEG back-half
// of the coefficient feed.
//
// K10 replaces meterelf_tpu/ops/pallas_jpeg.py fused_backhalf_planes
// (_fused_kernel): frequency-plane DCT coefficients (compact 12-bit int8
// wire or dense i16, io/jpeg.py) and the per-image quant tables in,
// packed-BGR i32 crops out, with dequantisation, libjpeg's ISLOW IDCT
// (jidctint.c), h2v2 fancy upsampling (jdsample.c), fixed-point
// YCbCr->BGR (jdcolor.c), crop and zero staging in one pass. K11 replaces
// upsample_color_pack (_tail_kernel): the same tail on spatial u8 planes,
// for the block-layout feed whose IDCT runs outside the kernel.
//
// Numerics: bit-identical to ops/jpegdec.py. The butterfly runs in
// uint32, whose adds, multiplies and left shifts wrap mod 2^32 exactly
// as the JAX package's int32 graph does (signed overflow would be
// undefined in CUDA C); DESCALE adds the rounding bias in uint32 and then
// shifts the int32 reinterpretation arithmetically.
//
// What bounds them: chip_smoke.py counts the int32 operations the
// function needs (its OPS_PER_* and backhalf_blocks_needed) and the bytes
// each kernel must move; PERF.md section 6 has the bounds. K10 reads
// 156,672 B of compact coefficients and writes 250 KB of crops per
// flagship image. The design: one CTA per (image, 16 output rows).
// It stages the luma block rows under its rows and the chroma block rows
// under them plus the one-sample halo above and below (at most 3 block
// rows per plane) as IDCT'd u8 samples in shared memory (48 B per window
// column), one thread per 8x8 block with the whole 2-D butterfly in
// registers, then writes each output pixel from the staged samples. The
// chroma halo rows are recomputed from their blocks rather than read
// from a neighbouring CTA. The TPU kernel's int8-limb matrix-unit IDCT,
// sublane interleaves and lane rolls exist only for Mosaic and are gone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;     // output rows per CTA
constexpr int kStageRows = 24;    // staged rows per plane: 3 block rows

// jidctint.c FIX(x) at CONST_BITS = 13
constexpr uint32_t F_0_298631336 = 2446u;
constexpr uint32_t F_0_390180644 = 3196u;
constexpr uint32_t F_0_541196100 = 4433u;
constexpr uint32_t F_0_765366865 = 6270u;
constexpr uint32_t F_0_899976223 = 7373u;
constexpr uint32_t F_1_175875602 = 9633u;
constexpr uint32_t F_1_501321110 = 12299u;
constexpr uint32_t F_1_847759065 = 15137u;
constexpr uint32_t F_1_961570560 = 16069u;
constexpr uint32_t F_2_053119869 = 16819u;
constexpr uint32_t F_2_562915447 = 20995u;
constexpr uint32_t F_3_072711026 = 25172u;

// jdcolor.c build_ycc_rgb_table at SCALEBITS = 16
constexpr int FIX_1_40200 = 91881;
constexpr int FIX_1_77200 = 116130;
constexpr int FIX_0_71414 = 46802;
constexpr int FIX_0_34414 = 22554;
constexpr int ONE_HALF = 1 << 15;

// Window geometry, from the host geom[10] array (meterelf_kernels.h).
struct Geom {
  int lh, lw;              // luma plane rows, cols (chroma: lh/2, lw/2)
  int oy, ox, rh, rw;      // crop origin in the window, crop size
  int ch_valid, cw_valid;  // valid chroma samples (upsampling clamp)
  int ph, pw;              // staging shape of the output (>= rh, rw)
};

__device__ __forceinline__ uint32_t descale(uint32_t x, int n) {
  return (uint32_t)((int32_t)(x + (1u << (n - 1))) >> n);
}

// One ISLOW butterfly over v[0..7] at stride s, in place, descaled by n.
__device__ __forceinline__ void idct8(uint32_t* v, int s, int n) {
  uint32_t z2 = v[2 * s], z3 = v[6 * s];
  uint32_t z1 = (z2 + z3) * F_0_541196100;
  const uint32_t t2 = z1 - z3 * F_1_847759065;
  const uint32_t t3 = z1 + z2 * F_0_765366865;
  z2 = v[0];
  z3 = v[4 * s];
  const uint32_t e0 = (z2 + z3) << 13;
  const uint32_t e1 = (z2 - z3) << 13;
  const uint32_t t10 = e0 + t3, t13 = e0 - t3;
  const uint32_t t11 = e1 + t2, t12 = e1 - t2;

  uint32_t o0 = v[7 * s], o1 = v[5 * s], o2 = v[3 * s], o3 = v[s];
  z1 = o0 + o3;
  z2 = o1 + o2;
  z3 = o0 + o2;
  uint32_t z4 = o1 + o3;
  const uint32_t z5 = (z3 + z4) * F_1_175875602;
  o0 *= F_0_298631336;
  o1 *= F_2_053119869;
  o2 *= F_3_072711026;
  o3 *= F_1_501321110;
  z1 = (0u - z1) * F_0_899976223;
  z2 = (0u - z2) * F_2_562915447;
  z3 = (0u - z3) * F_1_961570560 + z5;
  z4 = (0u - z4) * F_0_390180644 + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;

  v[0] = descale(t10 + o3, n);
  v[s] = descale(t11 + o2, n);
  v[2 * s] = descale(t12 + o1, n);
  v[3 * s] = descale(t13 + o0, n);
  v[4 * s] = descale(t13 - o0, n);
  v[5 * s] = descale(t12 - o1, n);
  v[6 * s] = descale(t11 - o2, n);
  v[7 * s] = descale(t10 - o3, n);
}

// 2-D IDCT of one dequantised block c[r*8 + col] (pass 1 down the
// columns, pass 2 along the rows, as jidctint.c), level shift and clamp,
// written as u8 rows of dst at row stride ds.
__device__ __forceinline__ void idct_block(uint32_t* c, uint8_t* dst,
                                           int ds) {
#pragma unroll
  for (int col = 0; col < 8; ++col) idct8(c + col, 8, 11);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    idct8(c + 8 * r, 1, 18);
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      const int v = (int32_t)c[8 * r + col] + 128;
      dst[r * ds + col] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// Upsampled chroma at window pixel (wy, wx): the jdsample.c triangle
// filter, vertical 3:1 then horizontal 3:1 with +8/+7 by column parity,
// neighbours clamped at the image edge (ch_valid, cw_valid). C holds
// chroma rows from row0 on, at row stride cs.
__device__ __forceinline__ int chroma_at(const uint8_t* C, int row0, int cs,
                                         int wy, int wx, const Geom& g) {
  const int r = wy >> 1, c = wx >> 1;
  const int nr = (wy & 1) ? min(r + 1, g.ch_valid - 1) : max(r - 1, 0);
  const int nc = (wx & 1) ? min(c + 1, g.cw_valid - 1) : max(c - 1, 0);
  const uint8_t* a = C + (r - row0) * cs;
  const uint8_t* b = C + (nr - row0) * cs;
  const int near = 3 * a[c] + b[c];
  const int far = 3 * a[nc] + b[nc];
  return (3 * near + far + ((wx & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ int32_t ycc_packed(int y, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  int r = y + ((FIX_1_40200 * cr + ONE_HALF) >> 16);
  int b = y + ((FIX_1_77200 * cb + ONE_HALF) >> 16);
  int g = y + ((-FIX_0_34414 * cb - FIX_0_71414 * cr + ONE_HALF) >> 16);
  r = min(max(r, 0), 255);
  g = min(max(g, 0), 255);
  b = min(max(b, 0), 255);
  return b | (g << 8) | (r << 16);
}

// Coefficients of block (br, bx) of plane p (0 = Y, 1 = Cb, 2 = Cr) of
// image img, dequantised, into c[64]. Dense planes are i16 [rows, cols];
// compact planes are int8 [rows*3/2, cols] (lo bytes, then row-pair hi
// nibbles), v = sign-extend-12(hi << 8 | lo).
template <bool kCompact>
__device__ __forceinline__ void load_block(const void* plane, int img,
                                           int rows, int cols, int br,
                                           int bx, const uint16_t* q,
                                           uint32_t* c) {
  if (kCompact) {
    const int8_t* base = (const int8_t*)plane
                         + (size_t)img * (rows * 3 / 2) * cols;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int pr = 8 * br + r;
      const uint2 lo = *(const uint2*)(base + (size_t)pr * cols + 8 * bx);
      const uint2 hi = *(const uint2*)(base + (size_t)(rows + (pr >> 1))
                                       * cols + 8 * bx);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t lo_w = k < 4 ? lo.x : lo.y;
        const uint32_t hi_w = k < 4 ? hi.x : hi.y;
        const int sh = 8 * (k & 3);
        const int l8 = (lo_w >> sh) & 255, h8 = (hi_w >> sh) & 255;
        const int nib = (r & 1) ? (h8 >> 4) : (h8 & 15);
        const int v = (nib << 8) | l8;
        c[8 * r + k] = (uint32_t)(v - ((v & 0x800) << 1)) * q[8 * r + k];
      }
    }
  } else {
    const int16_t* base = (const int16_t*)plane + (size_t)img * rows * cols;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint4 w = *(const uint4*)(base + (size_t)(8 * br + r) * cols
                                      + 8 * bx);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int v = (int16_t)(words[k >> 1] >> (16 * (k & 1)));
        c[8 * r + k] = (uint32_t)v * q[8 * r + k];
      }
    }
  }
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
    backhalf_planes_kernel(const void* __restrict__ fy,
                           const void* __restrict__ fcb,
                           const void* __restrict__ fcr,
                           const uint16_t* __restrict__ qt, Geom g,
                           int32_t* __restrict__ out) {
  extern __shared__ uint8_t stage[];   // Y [24][lw], Cb, Cr [24][lw/2]
  __shared__ uint16_t q[3 * 64];
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int cw = g.lw / 2, ch = g.lh / 2;
  uint8_t* sy = stage;
  uint8_t* scb = stage + kStageRows * g.lw;
  uint8_t* scr = scb + kStageRows * cw;

  const int y0 = blockIdx.x * kTileRows;
  const int y1 = min(y0 + kTileRows, g.ph);
  const int yk = min(y1, g.rh);          // crop rows of this tile end here
  // first staged luma and chroma block rows (valid when y0 < yk)
  const int lb0 = (g.oy + y0) >> 3;
  const int clo = max(((g.oy + y0) >> 1) - 1, 0);
  const int cb0 = clo >> 3;
  if (y0 < yk) {
    for (int i = tid; i < 3 * 64; i += kThreads) q[i] = qt[img * 192 + i];
    __syncthreads();
    const int lb1 = (g.oy + yk - 1) >> 3;
    const int chi = min(((g.oy + yk - 1) >> 1) + 1, g.ch_valid - 1);
    const int cb1 = chi >> 3;
    const int nbx = g.lw / 8, nbxc = cw / 8;
    const int nl = (lb1 - lb0 + 1) * nbx, nc = (cb1 - cb0 + 1) * nbxc;
    for (int j = tid; j < nl + 2 * nc; j += kThreads) {
      uint32_t c[64];
      if (j < nl) {
        const int br = lb0 + j / nbx, bx = j % nbx;
        load_block<kCompact>(fy, img, g.lh, g.lw, br, bx, q, c);
        idct_block(c, sy + (br - lb0) * 8 * g.lw + 8 * bx, g.lw);
      } else {
        const int k = (j - nl) % nc, p = (j - nl) / nc;
        const int br = cb0 + k / nbxc, bx = k % nbxc;
        load_block<kCompact>(p ? fcr : fcb, img, ch, cw, br, bx,
                             q + 64 * (1 + p), c);
        idct_block(c, (p ? scr : scb) + (br - cb0) * 8 * cw + 8 * bx, cw);
      }
    }
    __syncthreads();
  }
  int32_t* o = out + (size_t)img * g.ph * g.pw;
  const int n = (y1 - y0) * g.pw;
  for (int i = tid; i < n; i += kThreads) {
    const int y = y0 + i / g.pw, x = i % g.pw;
    int32_t v = 0;
    if (y < g.rh && x < g.rw) {
      const int wy = g.oy + y, wx = g.ox + x;
      v = ycc_packed(sy[(wy - 8 * lb0) * g.lw + wx],
                     chroma_at(scb, 8 * cb0, cw, wy, wx, g),
                     chroma_at(scr, 8 * cb0, cw, wy, wx, g));
    }
    o[(size_t)y * g.pw + x] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    upsample_color_pack_kernel(const uint8_t* __restrict__ y,
                               const uint8_t* __restrict__ cb,
                               const uint8_t* __restrict__ cr, int B,
                               Geom g, int32_t* __restrict__ out) {
  const size_t per = (size_t)g.ph * g.pw;
  const size_t n = per * B;
  const int cw = g.lw / 2;
  const size_t cplane = (size_t)(g.lh / 2) * cw;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const int img = (int)(i / per);
    const int rem = (int)(i % per);
    const int oy = rem / g.pw, ox = rem % g.pw;
    int32_t v = 0;
    if (oy < g.rh && ox < g.rw) {
      const int wy = g.oy + oy, wx = g.ox + ox;
      v = ycc_packed(y[(size_t)img * g.lh * g.lw + (size_t)wy * g.lw + wx],
                     chroma_at(cb + img * cplane, 0, cw, wy, wx, g),
                     chroma_at(cr + img * cplane, 0, cw, wy, wx, g));
    }
    out[i] = v;
  }
}

Geom geom_from(const int32_t* a) {
  return Geom{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9]};
}

// dynamic shared memory of K10: Y rows of lw, Cb and Cr rows of lw/2
// (ops/jpegdec.backhalf_ok admits a window when this plus the static
// quant tables fit a block)
int backhalf_smem_bytes(int lw) { return kStageRows * (lw + lw); }

}  // namespace

extern "C" int meterelf_backhalf_planes(const void* fy, const void* fcb,
                                        const void* fcr, int compact,
                                        const uint16_t* qt, int B,
                                        const int32_t* geom, int32_t* out,
                                        void* stream) {
  const Geom g = geom_from(geom);
  const int smem = backhalf_smem_bytes(g.lw);
  const dim3 grid((g.ph + kTileRows - 1) / kTileRows, B);
  cudaError_t e;
  if (compact) {
    e = cudaFuncSetAttribute(backhalf_planes_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    backhalf_planes_kernel<true><<<grid, kThreads, smem,
                                   (cudaStream_t)stream>>>(fy, fcb, fcr, qt,
                                                           g, out);
  } else {
    e = cudaFuncSetAttribute(backhalf_planes_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    backhalf_planes_kernel<false><<<grid, kThreads, smem,
                                    (cudaStream_t)stream>>>(fy, fcb, fcr, qt,
                                                            g, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int meterelf_upsample_color_pack(const uint8_t* y,
                                            const uint8_t* cb,
                                            const uint8_t* cr, int B,
                                            const int32_t* geom,
                                            int32_t* out, void* stream) {
  const Geom g = geom_from(geom);
  const size_t n = (size_t)B * g.ph * g.pw;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  upsample_color_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      y, cb, cr, B, g, out);
  return (int)cudaGetLastError();
}
