// The per-window body that K2 (windows.cu) and K5 (frontend.cu) share.
//
// For one 64x64 dial window at (x0, y0) of a packed-BGR crop: exact
// HLS_FULL with the wrapping hue shift, the dial colour as the
// integer-rounded mean of the 5x5 centre sample ((2S + 25) // 50), inRange
// +-color_range clipped to [0, 255], and a 3x3 close whose dilate reads 0
// and erode reads 1 outside the window (cv2 borders; no leak between
// windows). Writes bits = masked | disk<<1 | closed<<2 | raw<<3 for the
// window's 4096 pixels.
//
// Design: every warp works on one window and on a band of its rows.
//   1. The colour first: lanes 0-24 convert the 5x5 sample straight from
//      the crop and two warp reductions give the sums, so the warp holds
//      lo/hi in registers with no barrier (each warp of a window repeats
//      it: one pixel a lane).
//   2. HLS straight to a mask bit: a lane converts columns l and l + 32 of
//      each of the band's rows (loads issued a group of rows ahead), tests
//      the three channels in registers and two __ballot_sync make the
//      row's raw mask as one 64-bit word (bit x = column x) in shared
//      memory: 512 bytes a window, no H/L/S planes. The saturation and the
//      hue, the two divisions, are computed only where some lane of the
//      warp still passes the lightness (then the saturation) test.
//   3. After one barrier, the close on row words, rows rolling through
//      registers: dilate = OR of (w | w<<1 | w>>1) over rows r-1..r+1 with
//      zero rows and bits outside; erode = the AND of the same shape with
//      all-ones rows outside and a 1 shifted in at bits 0 and 63.
//   4. The write-out: lane l builds columns 2l and 2l + 1 from the
//      closed, raw and disk bits and stores them as one int2 (a warp
//      writes a row, 256 bytes, coalesced).
// The body ends with a barrier, so the block may run it again with the
// same shared memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_color.cuh"

namespace winbits {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of nw windows: their raw masks as row words.
constexpr int smem_bytes(int nw) { return nw * kWin * (int)sizeof(uint64_t); }

// Start of the 5x5 colour sample around centre c, as the JAX graph's
// lax.dynamic_slice takes it: a negative start wraps (+64, Python-style
// indexing), then the start is clamped so the sample stays in the window.
// A centre at row/column 0 or 1 thus samples the window's far edge.
__device__ __forceinline__ int sample_start(int c) {
  int s = c - 2;
  if (s < 0) s += kWin;
  return min(max(s, 0), kWin - 5);
}

// One window, as a warp sees it.
struct Win {
  const int32_t* img;  // the window's top-left pixel in the crop
  int W;               // the crop's row stride
  int sx, sy;          // start of the colour sample (sample_start)
  int cr[3];           // colour range (h, l, s)
  const uint8_t* dk;   // the dial's disk [64, 64] (0/1)
  int32_t* out;        // the window's bits [64, 64]
};

// The window's inRange bounds lo/hi (h, l, s), in every lane of the warp.
__device__ __forceinline__ void colour_bounds(const Win& w, int hue_shift,
                                              int lo[3], int hi[3]) {
  const int lane = threadIdx.x & 31;
  int h = 0, l = 0, s = 0;
  if (lane < 25) {
    const int yy = lane / 5, xx = lane - 5 * yy;
    meterelf_hls(w.img[(w.sy + yy) * w.W + w.sx + xx], hue_shift, h, l, s);
  }
  // sums of 25 values below 256 fit 16 bits: h and l in one word
  const unsigned hl = __reduce_add_sync(kFull, (unsigned)(h | l << 16));
  const int sum[3] = {(int)(hl & 0xffffu), (int)(hl >> 16),
                      (int)__reduce_add_sync(kFull, (unsigned)s)};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int color = (2 * sum[c] + 25) / 50;
    lo[c] = min(max(color - w.cr[c], 0), 255);
    hi[c] = min(max(color + w.cr[c], 0), 255);
  }
}

// Whether packed pixel p lies in [lo, hi] in all three channels: the
// exact chain of meterelf_hls, with the saturation and the hue left out
// where no lane of the warp needs them (warp-uniform branches: every lane
// of the warp calls it).
__device__ __forceinline__ bool in_range(int p, int hue_shift,
                                         const int lo[3], const int hi[3]) {
  float b, g, r;
  meterelf_unpack(p, b, g, r);
  const float vmax = fmaxf(fmaxf(r, g), b);
  const float vmin = fminf(fminf(r, g), b);
  const float l = __fmul_rn(__fadd_rn(vmax, vmin), 0.5f);
  const int L = meterelf_sat_u8(__fmul_rn(l, 255.0f));
  bool in = L >= lo[1] && L <= hi[1];
  if (!__any_sync(kFull, in)) return false;
  const int S = meterelf_saturation(vmax, vmin, l);
  in = in && S >= lo[2] && S <= hi[2];
  if (!__any_sync(kFull, in)) return false;
  const int H = meterelf_hue(b, g, r, vmax, vmin, hue_shift);
  return in && H >= lo[0] && H <= hi[0];
}

__device__ __forceinline__ uint64_t grow(uint64_t v) {
  return v | v << 1 | v >> 1;  // 0 shifted in: dilate's border
}

__device__ __forceinline__ uint64_t shrink(uint64_t v) {
  return v & (v << 1 | 1ull) & (v >> 1 | 1ull << 63);  // erode's border
}

// Rows r0 .. r0 + kRows - 1 of one window: the close of the raw row words
// `raw` (all 64 rows written) and the bits written out.
template <int kRows>
__device__ __forceinline__ void close_rows(const uint64_t* raw, const Win& w,
                                           int r0) {
  const int lane = threadIdx.x & 31;
  auto word = [&](int q) { return q >= 0 && q < kWin ? raw[q] : 0ull; };
  // dilated row q from the grown raw rows q-1, q, q+1; all ones outside
  auto dil = [](int q, uint64_t a, uint64_t b, uint64_t c) {
    return q >= 0 && q < kWin ? a | b | c : ~0ull;
  };
  uint64_t g_prev = grow(word(r0 - 1)), g_cur = grow(word(r0));
  uint64_t g_next = grow(word(r0 + 1));
  uint64_t e_prev = shrink(dil(r0 - 1, grow(word(r0 - 2)), g_prev, g_cur));
  uint64_t e_cur = shrink(dil(r0, g_prev, g_cur, g_next));
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    const unsigned dd =
        *reinterpret_cast<const uint16_t*>(w.dk + r * kWin + 2 * lane);
    const uint64_t g_2 = grow(word(r + 2));
    const uint64_t e_next = shrink(dil(r + 1, g_cur, g_next, g_2));
    const uint64_t closed = e_prev & e_cur & e_next;
    const unsigned c = (unsigned)(closed >> 2 * lane) & 3u;
    const unsigned m = (unsigned)(raw[r] >> 2 * lane) & 3u;
    const int d0 = (dd & 0xffu) != 0, d1 = (dd >> 8) != 0;
    const int c0 = c & 1, c1 = c >> 1;
    int2 o;
    o.x = (c0 & d0) | d0 << 1 | c0 << 2 | (int)(m & 1) << 3;
    o.y = (c1 & d1) | d1 << 1 | c1 << 2 | (int)(m >> 1) << 3;
    *reinterpret_cast<int2*>(w.out + r * kWin + 2 * lane) = o;
    g_cur = g_next;
    g_next = g_2;
    e_prev = e_cur;
    e_cur = e_next;
  }
}

// Every thread of a block of kWarps warps calls it, on kNW windows: warp
// k works on window k / (kWarps / kNW), whose Win it passes. words: kNW *
// 64 row words of shared memory.
template <int kWarps, int kNW>
__device__ inline void window_bits(uint64_t* words, const Win& w,
                                   int hue_shift) {
  static_assert(kWarps % kNW == 0, "whole warps a window");
  constexpr int kPer = kWarps / kNW;   // warps of one window
  static_assert(kWin % kPer == 0, "whole rows a warp");
  constexpr int kRows = kWin / kPer;   // rows of one warp
  constexpr int kGroup = kRows < 4 ? kRows : 4;  // rows loaded together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* raw = words + (warp / kPer) * kWin;
  const int r0 = (warp % kPer) * kRows;
#if defined(K2_PHASES) && K2_PHASES == 3
  // the close and write-out alone, on rows of a fixed pattern
  if (lane == 0)
    for (int i = 0; i < kRows; ++i)
      raw[r0 + i] = (uint64_t)(r0 + i + 1) * 0x9e3779b97f4a7c15ull;
  __syncthreads();
  close_rows<kRows>(raw, w, r0);
  __syncthreads();
  return;
#endif
  int lo[3], hi[3];
  int px[2][kGroup][2];
  auto load = [&](int g, int buf) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int32_t* row = w.img + (r0 + g * kGroup + u) * w.W;
      px[buf][u][0] = row[lane];
      px[buf][u][1] = row[lane + 32];
    }
  };
  load(0, 0);
#if defined(K2_PHASES) && K2_PHASES == 1
  for (int c = 0; c < 3; ++c) lo[c] = 64, hi[c] = 192;
#else
  colour_bounds(w, hue_shift, lo, hi);
#endif
#if defined(K2_PHASES) && K2_PHASES == 2
  if (lane < 3) w.out[(warp % kPer) * 3 + lane] = lo[lane] + hi[lane];
  return;
#endif
#pragma unroll
  for (int g = 0; g < kRows / kGroup; ++g) {
    if (g + 1 < kRows / kGroup) load(g + 1, (g + 1) & 1);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const unsigned a = __ballot_sync(
          kFull, in_range(px[g & 1][u][0], hue_shift, lo, hi));
      const unsigned b = __ballot_sync(
          kFull, in_range(px[g & 1][u][1], hue_shift, lo, hi));
      const uint64_t row = a | (uint64_t)b << 32;
#if defined(K2_PHASES) && K2_PHASES == 1
      if (lane == 0)
        reinterpret_cast<uint64_t*>(w.out)[r0 + g * kGroup + u] = row;
#else
      if (lane == 0) raw[r0 + g * kGroup + u] = row;
#endif
    }
  }
#if defined(K2_PHASES) && K2_PHASES == 1
  return;
#endif
  __syncthreads();
  close_rows<kRows>(raw, w, r0);
  __syncthreads();
}

}  // namespace winbits
