// K2 `windows`: per-dial needle masks for the located dial cluster.
//
// Replaces meterelf_tpu/ops/pallas_windows.py window_bits_quads
// (bits_from_sw, _hls_planes, _close3_blocked). For each (image, dial)
// 64x64 window at (mx + ox, my + oy) of the crop: exact HLS_FULL with the
// wrapping hue shift, the dial color as the integer-rounded mean of the
// 5x5 center sample ((2S + 25) // 50), inRange +-color_range clipped to
// [0, 255], and a 3x3 close whose dilate reads 0 and erode reads 1
// outside the window (cv2 borders; no leak between windows).
//
// What bounds it on the H100: almost nothing. 4096 pixels per window,
// each a few dozen f32 ops including three IEEE divisions, and 16 KB
// read + 16 KB written per window. The design is one CTA of 256 threads
// per window (16 pixels each), with the H/L/S planes and the padded
// raw/dilated masks in shared memory, so each pixel is read from device
// memory once and each bit plane written once. The Dekker division and
// the lane-rotated quad layout of the TPU kernel are not needed here:
// __fdiv_rn is IEEE division, and each window is its own CTA.
#include <cuda_runtime.h>

#include "exact_color.cuh"
#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kThreads = 256;
constexpr int kPad = kWin + 2;
constexpr int kMaxDials = 8;

struct WinGeom {
  int ox[kMaxDials], oy[kMaxDials];  // window origin, template coords
  int cx[kMaxDials], cy[kMaxDials];  // dial center, window coords
  int cr[kMaxDials][3];              // color range (h, l, s)
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

__global__ void __launch_bounds__(kThreads)
    windows_kernel(const int32_t* __restrict__ packed, int H, int W,
                   const int32_t* __restrict__ mx,
                   const int32_t* __restrict__ my, WinGeom g, int D,
                   const uint8_t* __restrict__ disk, int hue_shift,
                   int32_t* __restrict__ bits) {
  __shared__ uint8_t sH[kPix], sL[kPix], sS[kPix];
  __shared__ uint8_t sRaw[kPad * kPad];  // raw mask, border 0
  __shared__ uint8_t sDil[kPad * kPad];  // dilated mask, border 1
  __shared__ int sLo[3], sHi[3];
  const int d = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int x0 = mx[b] + g.ox[d], y0 = my[b] + g.oy[d];
  const int32_t* img = packed + (size_t)b * H * W;

  for (int i = tid; i < kPad * kPad; i += kThreads) {
    const int y = i / kPad, x = i - y * kPad;
    if (y == 0 || y == kPad - 1 || x == 0 || x == kPad - 1) {
      sRaw[i] = 0;
      sDil[i] = 1;
    }
  }
  for (int i = tid; i < kPix; i += kThreads) {
    const int y = i >> 6, x = i & 63;
    int h, l, s;
    meterelf_hls(img[(y0 + y) * W + x0 + x], hue_shift, h, l, s);
    sH[i] = (uint8_t)h;
    sL[i] = (uint8_t)l;
    sS[i] = (uint8_t)s;
  }
  __syncthreads();

  if (tid < 3) {
    // the 5x5 sample; a center within 2 px of the edge moves it as the
    // reference path's dynamic slice does (sample_start)
    const uint8_t* plane = tid == 0 ? sH : (tid == 1 ? sL : sS);
    const int sx = sample_start(g.cx[d]);
    const int sy = sample_start(g.cy[d]);
    int sum = 0;
    for (int yy = 0; yy < 5; ++yy)
      for (int xx = 0; xx < 5; ++xx) sum += plane[(sy + yy) * kWin + sx + xx];
    const int color = (2 * sum + 25) / 50;
    sLo[tid] = min(max(color - g.cr[d][tid], 0), 255);
    sHi[tid] = min(max(color + g.cr[d][tid], 0), 255);
  }
  __syncthreads();

  for (int i = tid; i < kPix; i += kThreads) {
    const int y = i >> 6, x = i & 63;
    const bool raw = sH[i] >= sLo[0] && sH[i] <= sHi[0] &&
                     sL[i] >= sLo[1] && sL[i] <= sHi[1] &&
                     sS[i] >= sLo[2] && sS[i] <= sHi[2];
    sRaw[(y + 1) * kPad + x + 1] = raw;
  }
  __syncthreads();
  for (int i = tid; i < kPix; i += kThreads) {
    const int y = i >> 6, x = i & 63;
    uint8_t v = 0;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) v |= sRaw[(y + dy) * kPad + x + dx];
    sDil[(y + 1) * kPad + x + 1] = v;
  }
  __syncthreads();

  const uint8_t* dk = disk + (size_t)d * kPix;
  int32_t* out = bits + ((size_t)b * D + d) * kPix;
  for (int i = tid; i < kPix; i += kThreads) {
    const int y = i >> 6, x = i & 63;
    int closed = 1;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        closed &= sDil[(y + dy) * kPad + x + dx];
    const int dsk = dk[i] != 0;
    const int raw = sRaw[(y + 1) * kPad + x + 1];
    out[i] = (closed & dsk) | (dsk << 1) | (closed << 2) | (raw << 3);
  }
}

}  // namespace

extern "C" int meterelf_windows(const int32_t* packed, int B, int H, int W,
                                const int32_t* mx, const int32_t* my,
                                const int32_t* geom, int D,
                                const uint8_t* disk, int hue_shift,
                                int32_t* bits, void* stream) {
  if (D < 1 || D > kMaxDials) return (int)cudaErrorInvalidValue;
  WinGeom g;
  for (int d = 0; d < D; ++d) {
    const int32_t* q = geom + 7 * d;
    g.ox[d] = q[0];
    g.oy[d] = q[1];
    g.cx[d] = q[2];
    g.cy[d] = q[3];
    for (int c = 0; c < 3; ++c) g.cr[d][c] = q[4 + c];
  }
  windows_kernel<<<dim3(D, B), kThreads, 0, (cudaStream_t)stream>>>(
      packed, H, W, mx, my, g, D, disk, hue_shift, bits);
  return (int)cudaGetLastError();
}
