// The per-window body that K2 (windows.cu) and K5 (frontend.cu) share.
//
// For one 64x64 dial window at (x0, y0) of a packed-BGR crop: exact
// HLS_FULL with the wrapping hue shift, the dial colour as the
// integer-rounded mean of the 5x5 centre sample ((2S + 25) // 50), inRange
// +-color_range clipped to [0, 255], and a 3x3 close whose dilate reads 0
// and erode reads 1 outside the window (cv2 borders; no leak between
// windows). Writes bits = masked | disk<<1 | closed<<2 | raw<<3 for the
// window's 4096 pixels. Every thread of the block calls it; it ends with a
// barrier, so the block may call it again with the same shared memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_color.cuh"

namespace winbits {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kPad = kWin + 2;

// Shared memory of one window: the H/L/S planes and the padded raw and
// dilated masks (21,024 bytes).
struct Smem {
  uint8_t h[kPix], l[kPix], s[kPix];
  uint8_t raw[kPad * kPad];  // raw mask, border 0
  uint8_t dil[kPad * kPad];  // dilated mask, border 1
  int lo[3], hi[3];
};

// Start of the 5x5 colour sample around centre c, as the JAX graph's
// lax.dynamic_slice takes it: a negative start wraps (+64, Python-style
// indexing), then the start is clamped so the sample stays in the window.
// A centre at row/column 0 or 1 thus samples the window's far edge.
__device__ __forceinline__ int sample_start(int c) {
  int s = c - 2;
  if (s < 0) s += kWin;
  return min(max(s, 0), kWin - 5);
}

// img: one crop [H, W] (only its width is needed); (x0, y0) the window's
// top-left pixel; (cx, cy) the dial centre in window coordinates; cr_* the
// colour range; dk the dial's disk [64, 64] (0/1); out the window's bits.
__device__ inline void window_bits(Smem& sm, const int32_t* __restrict__ img,
                                   int W, int x0, int y0, int cx, int cy,
                                   int cr_h, int cr_l, int cr_s,
                                   const uint8_t* __restrict__ dk,
                                   int hue_shift, int32_t* __restrict__ out,
                                   int nthreads) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kPad * kPad; i += nthreads) {
    const int y = i / kPad, x = i - y * kPad;
    if (y == 0 || y == kPad - 1 || x == 0 || x == kPad - 1) {
      sm.raw[i] = 0;
      sm.dil[i] = 1;
    }
  }
  for (int i = tid; i < kPix; i += nthreads) {
    const int y = i >> 6, x = i & 63;
    int h, l, s;
    meterelf_hls(img[(y0 + y) * W + x0 + x], hue_shift, h, l, s);
    sm.h[i] = (uint8_t)h;
    sm.l[i] = (uint8_t)l;
    sm.s[i] = (uint8_t)s;
  }
  __syncthreads();

  if (tid < 3) {
    // the 5x5 sample; a center within 2 px of the edge moves it as the
    // reference path's dynamic slice does (sample_start)
    const uint8_t* plane = tid == 0 ? sm.h : (tid == 1 ? sm.l : sm.s);
    const int cr = tid == 0 ? cr_h : (tid == 1 ? cr_l : cr_s);
    const int sx = sample_start(cx);
    const int sy = sample_start(cy);
    int sum = 0;
    for (int yy = 0; yy < 5; ++yy)
      for (int xx = 0; xx < 5; ++xx) sum += plane[(sy + yy) * kWin + sx + xx];
    const int color = (2 * sum + 25) / 50;
    sm.lo[tid] = min(max(color - cr, 0), 255);
    sm.hi[tid] = min(max(color + cr, 0), 255);
  }
  __syncthreads();

  for (int i = tid; i < kPix; i += nthreads) {
    const int y = i >> 6, x = i & 63;
    const bool raw = sm.h[i] >= sm.lo[0] && sm.h[i] <= sm.hi[0] &&
                     sm.l[i] >= sm.lo[1] && sm.l[i] <= sm.hi[1] &&
                     sm.s[i] >= sm.lo[2] && sm.s[i] <= sm.hi[2];
    sm.raw[(y + 1) * kPad + x + 1] = raw;
  }
  __syncthreads();
  for (int i = tid; i < kPix; i += nthreads) {
    const int y = i >> 6, x = i & 63;
    uint8_t v = 0;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) v |= sm.raw[(y + dy) * kPad + x + dx];
    sm.dil[(y + 1) * kPad + x + 1] = v;
  }
  __syncthreads();

  for (int i = tid; i < kPix; i += nthreads) {
    const int y = i >> 6, x = i & 63;
    int closed = 1;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        closed &= sm.dil[(y + dy) * kPad + x + dx];
    const int dsk = dk[i] != 0;
    const int raw = sm.raw[(y + 1) * kPad + x + 1];
    out[i] = (closed & dsk) | (dsk << 1) | (closed << 2) | (raw << 3);
  }
  __syncthreads();
}

}  // namespace winbits
