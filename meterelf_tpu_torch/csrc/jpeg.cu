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
// flagship image, and its operations bound it.
//
// K10's design: one CTA per (image, band), a band being one chroma block
// row k of the window (window rows 16k..16k+15) that holds crop rows, so
// no two CTAs IDCT the same block. A band stages as u8 samples in shared
// memory (26 B a window column) the luma blocks under its crop rows and
// the crop's columns and the chroma blocks of row k under the crop's
// chroma columns and their one-sample halo, one thread a block with the
// whole 2-D butterfly in registers; the two chroma halo rows 8k-1 and
// 8k+8, where a crop pixel reads them, are single rows of the
// neighbouring blocks (that row's entry of each column pass, then one row
// pass: idct8_edge, bit-equal to idct8), not whole blocks. Single rows
// start on a warp of their own so that no warp runs both. The tail maps
// warps to output rows and lanes to window column pairs (2c, 2c+1): no
// integer division, and the vertical 3:1 sums of chroma columns c-1, c,
// c+1 read once a pair. The last band also writes the staging rows below
// the crop. For the flagship window an image runs 1,536 full IDCTs and 992
// single rows, against 2,528 full IDCTs when 16-row tiles started at the
// crop's rows (1,568 blocks needed). The TPU kernel's int8-limb
// matrix-unit IDCT, sublane interleaves and lane rolls exist only for
// Mosaic and are gone.
//
// K11 reads 69,632 B of u8 planes and writes 250 KB of crops per flagship
// image: by the count of chip_smoke.py its bytes bound it, the write
// most; on the card its integer instructions take longer (PERF.md
// section 6). Its design: one CTA per (image, band, column tile), a band
// being window rows 32k..32k+31 (the rows 2r and 2r+1, which share the
// near chroma row r, fall in one band) and a tile 256 output columns, so
// the staging stays 27,904 B whatever the window's width; no integer
// division. Staging, every global load of the CTA issued before its first
// shared store: a warp per window row (4 a warp), a lane per 8 chroma
// columns (8-byte loads of the near and neighbour rows of both planes)
// makes the vertical 3:1 sums of the row over the tile's chroma columns
// and their one-column halo, Cb and Cr packed in the halves of a word,
// and a lane per 8 luma columns copies the row's luma; one lane makes, in
// a slot of its own, the sums of the far column cw_valid-1, which every
// column past it reads as its right neighbour (jdsample.c's clamp at the
// image edge) wherever the tile lies. The neighbour row is read where it
// lies, so a crop row past the valid chroma rows reads row ch_valid-1
// however far above the band. Then a warp per output row and a lane per
// 4 output columns from the row's first 16-byte boundary (a head of 0-3
// and a tail of 0-3 pixels apart): the luma as two aligned words and a
// funnel shift, the horizontal 3:1 of both planes in one word operation a
// pixel, the colour of each of the 4 pixels (ycc_packed, as K10), one
// 16-byte store. Rows and columns of the staging shape outside the crop
// are written as zeros in the same pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 16;     // window rows of a band: 1 chroma block row
constexpr int kChromaRows = 10;   // staged chroma rows: the row and 2 halos
constexpr int kTailShift = 5;     // K11: a band is 32 window rows
constexpr int kTailRows = 1 << kTailShift;
constexpr int kTileCols = 256;    // K11: output columns of a tile (64 quads)
// K11: staged chroma columns of a window row, in words: at most 144 (the
// tile's 131 and their halo, from a multiple of 8, in groups of 8) then
// the far slot
constexpr int kFarSlot = 144;
constexpr int kSlotPitch = 148;
// K11: staged luma bytes of a window row: at most 34 words of 8 (the
// tile's 260 columns from a multiple of 8), and room for a quad's second
// word past the last
constexpr int kLumaPitch = 280;
constexpr uint32_t kEven = 0x00080008u;   // jdsample.c rounding, both halves
constexpr uint32_t kOdd = 0x00070007u;

// 3 runs both of K10's phases; experiments/torch_k10_ab.py --split builds
// 1 (the IDCT alone) and 2 (the tail alone on zeros) to time them apart
#ifndef K10_PHASES
#define K10_PHASES 3
#endif

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

// Level shift, clamp and store of 8 IDCT outputs as u8.
__device__ __forceinline__ void store_row(const uint32_t* v, uint8_t* dst) {
#pragma unroll
  for (int col = 0; col < 8; ++col) {
    const int x = (int32_t)v[col] + 128;
    dst[col] = (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
  }
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
    store_row(c + 8 * r, dst + r * ds);
  }
}

// Upsampled chroma at window columns 2c (even) and 2c+1 (odd) of one
// row: the jdsample.c triangle filter, vertical 3:1 then horizontal 3:1
// with +8/+7 by column parity, neighbours clamped at the image edge
// (ch_valid, cw_valid), the vertical 3:1 sums of columns lc = max(c-1, 0),
// c and rc = min(c+1, cw_valid-1) of the row a and its neighbour row b
// read once for the pair.
__device__ __forceinline__ void chroma_pair(const uint8_t* a,
                                            const uint8_t* b, int c, int lc,
                                            int rc, int& even, int& odd) {
  const int mid = 3 * (3 * a[c] + b[c]);
  even = (mid + 3 * a[lc] + b[lc] + 8) >> 4;
  odd = (mid + 3 * a[rc] + b[rc] + 7) >> 4;
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

// Outputs 0 and 7 alone of idct8 over v[0..7] at stride s (t10 + o3 and
// t10 - o3, descaled by n): the same uint32 expressions, restricted to
// the terms those two outputs use, so the value is bit-equal to idct8's.
__device__ __forceinline__ uint32_t idct8_edge(const uint32_t* v, int s,
                                               int n, bool last) {
  uint32_t z2 = v[2 * s], z3 = v[6 * s];
  uint32_t z1 = (z2 + z3) * F_0_541196100;
  const uint32_t t3 = z1 + z2 * F_0_765366865;
  z2 = v[0];
  z3 = v[4 * s];
  const uint32_t e0 = (z2 + z3) << 13;
  const uint32_t t10 = e0 + t3;

  const uint32_t o0 = v[7 * s], o1 = v[5 * s], o2 = v[3 * s];
  uint32_t o3 = v[s];
  z1 = o0 + o3;
  z3 = o0 + o2;
  uint32_t z4 = o1 + o3;
  const uint32_t z5 = (z3 + z4) * F_1_175875602;
  o3 *= F_1_501321110;
  z1 = (0u - z1) * F_0_899976223;
  z4 = (0u - z4) * F_0_390180644 + z5;
  o3 += z1 + z4;
  return descale(last ? t10 - o3 : t10 + o3, n);
}

// Sample row 0 (last = false) or 7 (last = true) alone of a dequantised
// block's 2-D IDCT: that row's entry of each column pass, then one row
// pass, written as 8 u8 to dst.
__device__ __forceinline__ void idct_edge_row(const uint32_t* c, bool last,
                                              uint8_t* dst) {
  uint32_t w[8];
#pragma unroll
  for (int col = 0; col < 8; ++col) w[col] = idct8_edge(c + col, 8, 11, last);
  idct8(w, 1, 18);
  store_row(w, dst);
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
    backhalf_planes_kernel(const void* __restrict__ fy,
                           const void* __restrict__ fcb,
                           const void* __restrict__ fcr,
                           const uint16_t* __restrict__ qt, Geom g,
                           int32_t* __restrict__ out) {
  // Y [16][lw]: window rows 16k..16k+15; Cb, Cr [10][lw/2]: chroma rows
  // 8k-1 (halo), 8k..8k+7, 8k+8 (halo)
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ uint16_t q[3 * 64];
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int cw = g.lw / 2, ch = g.lh / 2;
  uint8_t* sy = stage;
  uint8_t* scb = stage + kBandRows * g.lw;
  uint8_t* scr = scb + kChromaRows * cw;

  const int k = (g.oy >> 4) + blockIdx.x;   // the band's chroma block row
  const int wy0 = max(16 * k, g.oy);          // its crop rows [wy0, wy1)
  const int wy1 = min(16 * k + 16, g.oy + g.rh);
  if (K10_PHASES & 1) {
    if (wy0 < wy1 && g.rw > 0) {
      for (int i = tid; i < 3 * 64; i += kThreads) q[i] = qt[img * 192 + i];
      __syncthreads();
      // luma blocks under the band's crop rows and the crop's columns;
      // chroma blocks of row k under the crop's chroma columns and their
      // one-sample halo; the halo rows 8k-1 and 8k+8 where a crop pixel
      // reads them (the filter's clamps)
      const int lr0 = wy0 >> 3, nlr = ((wy1 - 1) >> 3) - lr0 + 1;
      const int lx0 = g.ox >> 3;
      const int nlx = ((g.ox + g.rw - 1) >> 3) - lx0 + 1;
      const int cx0 = max((g.ox >> 1) - 1, 0) >> 3;
      const int ncx = (min(((g.ox + g.rw - 1) >> 1) + 1, g.cw_valid - 1)
                       >> 3) - cx0 + 1;
      const bool up = k > 0 && wy0 == 16 * k;
      const bool down = wy1 == 16 * k + 16 && 8 * k + 8 <= g.ch_valid - 1;
      const int nl = nlr * nlx, nfull = nl + 2 * ncx;
      const int s0 = (nfull + 31) & ~31;   // single rows start on a warp
      const int njobs = s0 + ((int)up + (int)down) * 2 * ncx;
      for (int j = tid; j < njobs; j += kThreads) {
        uint32_t c[64];
        if (j < nfull) {
          const void* plane;
          int rows, cols, br, bx, ds;
          const uint16_t* qq;
          uint8_t* dst;
          if (j < nl) {
            const int second = j >= nlx;
            br = lr0 + second;
            bx = lx0 + j - (second ? nlx : 0);
            plane = fy;
            rows = g.lh;
            cols = g.lw;
            qq = q;
            dst = sy + (8 * br - 16 * k) * g.lw + 8 * bx;
            ds = g.lw;
          } else {
            const int jj = j - nl, p = jj >= ncx;
            br = k;
            bx = cx0 + jj - (p ? ncx : 0);
            plane = p ? fcr : fcb;
            rows = ch;
            cols = cw;
            qq = q + 64 * (1 + p);
            dst = (p ? scr : scb) + cw + 8 * bx;
            ds = cw;
          }
          load_block<kCompact>(plane, img, rows, cols, br, bx, qq, c);
          idct_block(c, dst, ds);
        } else if (j >= s0) {
          const int jj = j - s0, second = jj >= 2 * ncx;
          const int jh = jj - (second ? 2 * ncx : 0), p = jh >= ncx;
          const int bx = cx0 + jh - (p ? ncx : 0);
          const bool below = second || !up;
          load_block<kCompact>(p ? fcr : fcb, img, ch, cw,
                               below ? k + 1 : k - 1, bx, q + 64 * (1 + p),
                               c);
          idct_edge_row(c, !below,
                        (p ? scr : scb) + (below ? 9 : 0) * cw + 8 * bx);
        }
      }
    }
  } else {   // the tail alone (experiments/torch_k10_ab.py --split)
    for (int i = tid; i < (kBandRows + kChromaRows) * g.lw / 4;
         i += kThreads)
      ((uint32_t*)stage)[i] = 0;
  }
  __syncthreads();
  if (!(K10_PHASES & 2)) {   // the IDCT alone: keep it with a checksum
    if (tid < 32) {
      uint32_t s = ((const uint32_t*)stage)[tid];
      for (int m = 16; m; m >>= 1) s ^= __shfl_xor_sync(~0u, s, m);
      if (tid == 0) out[(size_t)img * g.ph * g.pw + blockIdx.x] = s;
    }
    return;
  }
  // output rows [ys, ye): the band's crop rows, and for the last band
  // the staging rows below the crop. A warp takes one row at a time, a
  // lane one window column pair (2c, 2c+1), which lands on output columns
  // x = 2c - ox and x + 1 (x = -1 for the first pair of an odd ox)
  int32_t* o = out + (size_t)img * g.ph * g.pw;
  const int ys = max(16 * k - g.oy, 0);
  const int ye = blockIdx.x + 1 == gridDim.x ? g.ph : wy1 - g.oy;
  const int c0 = g.ox >> 1;
  const int npairs = (g.pw + (g.ox & 1) + 1) >> 1;
  for (int y = ys + (tid >> 5); y < ye; y += kThreads / 32) {
    int32_t* orow = o + (size_t)y * g.pw;
    const bool crop = y < g.rh;
    const int wy = g.oy + y, r = wy >> 1;
    const int nr = (wy & 1) ? min(r + 1, g.ch_valid - 1) : max(r - 1, 0);
    const uint8_t* ly = sy + (wy - 16 * k) * g.lw;
    const int ra = (r - 8 * k + 1) * cw, rb = (nr - 8 * k + 1) * cw;
    for (int j = tid & 31; j < npairs; j += 32) {
      const int c = c0 + j, x = 2 * c - g.ox;
      int32_t v0 = 0, v1 = 0;
      if (crop && x < g.rw) {
        const int lc = max(c - 1, 0), rc = min(c + 1, g.cw_valid - 1);
        const uint32_t yy = *(const uint16_t*)(ly + 2 * c);
        int cb0, cb1, cr0, cr1;
        chroma_pair(scb + ra, scb + rb, c, lc, rc, cb0, cb1);
        chroma_pair(scr + ra, scr + rb, c, lc, rc, cr0, cr1);
        v0 = ycc_packed(yy & 255, cb0, cr0);
        if (x + 1 < g.rw) v1 = ycc_packed(yy >> 8, cb1, cr1);
      }
      if (x >= 0) orow[x] = v0;
      if (x + 1 < g.pw) orow[x + 1] = v1;
    }
  }
}

// The vertical 3:1 sums 3 * near + neighbour of 4 chroma columns, each
// as one word: Cb's in the low half, Cr's in the high half (at most
// 1,020). a, b: Cb's near and neighbour rows' 4 samples; c, d: Cr's.
__device__ __forceinline__ uint4 vsums4(uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d) {
  const uint32_t cb01 = 3 * __byte_perm(a, 0, 0x4140)
                        + __byte_perm(b, 0, 0x4140);
  const uint32_t cb23 = 3 * __byte_perm(a, 0, 0x4342)
                        + __byte_perm(b, 0, 0x4342);
  const uint32_t cr01 = 3 * __byte_perm(c, 0, 0x4140)
                        + __byte_perm(d, 0, 0x4140);
  const uint32_t cr23 = 3 * __byte_perm(c, 0, 0x4342)
                        + __byte_perm(d, 0, 0x4342);
  return make_uint4(__byte_perm(cb01, cr01, 0x5410),
                    __byte_perm(cb01, cr01, 0x7632),
                    __byte_perm(cb23, cr23, 0x5410),
                    __byte_perm(cb23, cr23, 0x7632));
}

// One pixel from luma y and the packed vertical sums of its chroma column
// (mid) and of its neighbour column (side: the left one for an even
// window column, bias kEven; the right one for an odd, kOdd): the
// horizontal 3:1 of both planes in one word (each half stays below 4,096,
// so no carry crosses), then colour.
__device__ __forceinline__ int32_t tail_px(uint32_t y, uint32_t mid,
                                           uint32_t side, uint32_t bias) {
  const uint32_t t = 3 * mid + side + bias;
  return ycc_packed((int)y, (int)((t >> 4) & 255), (int)(t >> 20));
}

// The pixel of luma y at window column wx of a crop row: v holds the
// row's packed sums from chroma column c0 on, the far column's in slot
// kFarSlot.
__device__ __forceinline__ int32_t tail_pixel(const uint32_t* v, uint32_t y,
                                              int wx, int c0, int cw_valid) {
  const int c = wx >> 1, m = c - c0;
  if (wx & 1)
    return tail_px(y, v[m], v[c + 1 < cw_valid ? m + 1 : kFarSlot], kOdd);
  return tail_px(y, v[m], v[max(m - 1, 0)], kEven);
}

// Window columns wx..wx+3 of a crop row, all inside the crop, wx & 1 == P:
// the luma as two aligned words of the staged row (lw from luma column l0
// on, l0 a multiple of 8) and a funnel shift, the packed sums of the (up
// to) five chroma columns they read, four pixels.
template <int P>
__device__ __forceinline__ int4 tail_quad(const uint32_t* v,
                                          const uint8_t* lw, int l0, int wx,
                                          int c0, int cw_valid) {
  const int o = wx - l0, s = o & 3;
  const uint32_t* l32 = (const uint32_t*)(lw + o - s);
  const uint32_t lum = __funnelshift_r(l32[0], l32[1], 8 * s);
  const int c = wx >> 1, m = c - c0;
  const uint32_t m0 = v[m], m1 = v[m + 1];
  const uint32_t r0 = v[c + 1 < cw_valid ? m + 1 : kFarSlot];
  const uint32_t r1 = v[c + 2 < cw_valid ? m + 2 : kFarSlot];
  const uint32_t y0 = lum & 255, y1 = (lum >> 8) & 255;
  const uint32_t y2 = (lum >> 16) & 255, y3 = lum >> 24;
  if (P == 0)   // columns 2c, 2c+1, 2c+2, 2c+3
    return make_int4(tail_px(y0, m0, v[max(m - 1, 0)], kEven),
                     tail_px(y1, m0, r0, kOdd), tail_px(y2, m1, m0, kEven),
                     tail_px(y3, m1, r1, kOdd));
  const uint32_t m2 = v[m + 2];   // columns 2c+1, 2c+2, 2c+3, 2c+4
  return make_int4(tail_px(y0, m0, r0, kOdd), tail_px(y1, m1, m0, kEven),
                   tail_px(y2, m1, r1, kOdd), tail_px(y3, m2, m1, kEven));
}

// 8 bytes at p, 4-byte aligned, 8-byte aligned when a8; when half, the
// row ends after the first 4 (a row of 4 mod 8 samples, never a8) and the
// last 4 read as zeros.
__device__ __forceinline__ uint2 load8(const uint8_t* p, bool a8,
                                       bool half) {
  if (a8) return *(const uint2*)p;
  return make_uint2(*(const uint32_t*)p,
                    half ? 0u : *(const uint32_t*)(p + 4));
}

// One CTA per (image blockIdx.x, band blockIdx.y, column tile blockIdx.z).
__global__ void __launch_bounds__(kThreads)
    upsample_color_pack_kernel(const uint8_t* __restrict__ y,
                               const uint8_t* __restrict__ cb,
                               const uint8_t* __restrict__ cr, Geom g,
                               int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sv[kTailRows][kSlotPitch];
  __shared__ __align__(16) uint8_t sl[kTailRows][kLumaPitch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int img = blockIdx.x, t = blockIdx.z;
  // the band: window rows [w0, w0 + 32), output rows [ys, ye), crop rows
  // [ys, yc)
  const int w0 = ((g.oy >> kTailShift) + blockIdx.y) << kTailShift;
  const int ys = max(w0 - g.oy, 0);
  const int ye = min(w0 + kTailRows - g.oy, g.ph);
  const int yc = min(ye, g.rh);
  const int cw = g.lw >> 1;
  const size_t cplane = (size_t)(g.lh >> 1) * cw;
  const uint8_t* pcb = cb + img * cplane;
  const uint8_t* pcr = cr + img * cplane;

  // the tile's crop columns [x0, x1] (a row's quads start at its head,
  // 0-3, so a tile's pixels reach 3 columns past 256 t + 255); their
  // chroma columns and halo [c0, c1] and luma columns from l0, c0 and l0
  // multiples of 8
  const int x0 = kTileCols * t;
  const int x1 = min(x0 + kTileCols + 3, g.rw - 1);
  const int c0 = max(((g.ox + x0) >> 1) - 1, 0) & ~7;
  const int c1 = min(((g.ox + x1) >> 1) + 1, cw - 1);
  const int groups = x0 <= x1 ? ((c1 - c0) >> 3) + 1 : 0;
  const int l0 = (g.ox + x0) & ~7;
  const int words = x0 <= x1 ? ((g.ox + x1 - l0) >> 3) + 1 : 0;
  const bool a8 = (cw & 7) == 0;   // chroma rows 8-byte aligned

  // every global load of the CTA first, then the shared stores: a warp per
  // crop row (rows ys + warp + 8 i), a lane per 8 chroma columns (lane
  // `groups` takes the far column) and per 8 luma columns (words lane and
  // lane + 32)
  uint2 cs[kTailRows / 8][4], ls[kTailRows / 8][2];
#pragma unroll
  for (int i = 0; i < kTailRows / 8; ++i) {
    const int yy = ys + warp + 8 * i;
    if (yy >= yc) continue;
    const int wy = g.oy + yy, r = wy >> 1;
    const int nr = (wy & 1) ? min(r + 1, g.ch_valid - 1) : max(r - 1, 0);
    const uint8_t* rows[4] = {pcb + r * cw, pcb + nr * cw, pcr + r * cw,
                              pcr + nr * cw};
    if (lane < groups) {
      const int c = c0 + 8 * lane;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        cs[i][p] = load8(rows[p] + c, a8, c + 4 >= cw);
    } else if (lane == groups) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        cs[i][p] = make_uint2(rows[p][g.cw_valid - 1], 0u);
    }
    const uint8_t* ly = y + ((size_t)img * g.lh + wy) * g.lw + l0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < words)
        ls[i][h] = *(const uint2*)(ly + 8 * (lane + 32 * h));
  }
#pragma unroll
  for (int i = 0; i < kTailRows / 8; ++i) {
    const int yy = ys + warp + 8 * i;
    if (yy >= yc) continue;
    uint32_t* v = sv[g.oy + yy - w0];
    if (lane < groups) {
      ((uint4*)v)[2 * lane] = vsums4(cs[i][0].x, cs[i][1].x, cs[i][2].x,
                                     cs[i][3].x);
      ((uint4*)v)[2 * lane + 1] = vsums4(cs[i][0].y, cs[i][1].y, cs[i][2].y,
                                         cs[i][3].y);
    } else if (lane == groups) {
      v[kFarSlot] = vsums4(cs[i][0].x, cs[i][1].x, cs[i][2].x, cs[i][3].x).x;
    }
    uint8_t* l = sl[g.oy + yy - w0];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < words) ((uint2*)l)[lane + 32 * h] = ls[i][h];
  }
  __syncthreads();

  // a warp per output row; the row's groups of 4 columns start at its
  // first 16-byte boundary: the head [0, head) is group -1 (tile 0), the
  // tail [head + 4 nq, pw) group nq, quads the groups between; tile t
  // takes groups 64 t .. 64 t + 63, a lane one group in 32 of those that
  // hold pixels (flagship: 62 quads and a head or a tail, 2 a lane)
  for (int yy = ys + warp; yy < ye; yy += kThreads / 32) {
    const size_t e0 = ((size_t)img * g.ph + yy) * g.pw;
    int32_t* orow = out + e0;
    const int head = (int)((0 - e0) & 3);
    const int nq = (g.pw - head) >> 2;
    const int jb = 64 * t - (t == 0 && head > 0);
    const int je = min(64 * t + 63, ((g.pw - head) & 3) ? nq : nq - 1);
    const bool crop = yy < g.rh;
    const int row = crop ? g.oy + yy - w0 : 0;
    const uint32_t* v = sv[row];
    const uint8_t* lrow = sl[row];
    const bool odd = (g.ox + head) & 1;
    for (int j = jb + lane; j <= je; j += 32) {
      const int x = head + 4 * j;
      if (j >= 0 && j < nq) {
        int4 q = make_int4(0, 0, 0, 0);
        if (crop && x + 3 < g.rw) {
          q = odd ? tail_quad<1>(v, lrow, l0, g.ox + x, c0, g.cw_valid)
                  : tail_quad<0>(v, lrow, l0, g.ox + x, c0, g.cw_valid);
        } else if (crop && x < g.rw) {   // the crop's last 1-3 columns
          const int wx = g.ox + x, o = wx - l0;
          q.x = tail_pixel(v, lrow[o], wx, c0, g.cw_valid);
          if (x + 1 < g.rw)
            q.y = tail_pixel(v, lrow[o + 1], wx + 1, c0, g.cw_valid);
          if (x + 2 < g.rw)
            q.z = tail_pixel(v, lrow[o + 2], wx + 2, c0, g.cw_valid);
        }
        *(int4*)(orow + x) = q;
      } else {
        for (int xx = max(x, 0); xx < min(x + 4, g.pw); ++xx) {
          const int wx = g.ox + xx;
          orow[xx] = crop && xx < g.rw
                         ? tail_pixel(v, lrow[wx - l0], wx, c0, g.cw_valid)
                         : 0;
        }
      }
    }
  }
}

Geom geom_from(const int32_t* a) {
  return Geom{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9]};
}

// dynamic shared memory of K10: 16 Y rows of lw, 10 Cb and 10 Cr rows of
// lw/2, 26 B a window column (ops/jpegdec.backhalf_ok admits a window when
// 48 B a column plus the static quant tables fit a block: a looser need
// than this one)
int backhalf_smem_bytes(int lw) {
  return kBandRows * lw + 2 * kChromaRows * (lw / 2);
}

}  // namespace

extern "C" int meterelf_backhalf_planes(const void* fy, const void* fcb,
                                        const void* fcr, int compact,
                                        const uint16_t* qt, int B,
                                        const int32_t* geom, int32_t* out,
                                        void* stream) {
  const Geom g = geom_from(geom);
  const int smem = backhalf_smem_bytes(g.lw);
  // one CTA a band (chroma block row) that holds crop rows
  const int bands = g.rh > 0 ? ((g.oy + g.rh - 1) >> 4) - (g.oy >> 4) + 1 : 1;
  const dim3 grid(bands, B);
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
  if (B == 0 || g.ph <= 0 || g.pw <= 0) return 0;
  // bands of window rows 32k..32k+31 that hold staging rows; tiles of 256
  // output columns (the last may hold only a row's tail)
  const int bands =
      ((g.oy + g.ph - 1) >> kTailShift) - (g.oy >> kTailShift) + 1;
  const dim3 grid(B, bands, g.pw / kTileCols + 1);
  upsample_color_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      y, cb, cr, g, out);
  return (int)cudaGetLastError();
}
