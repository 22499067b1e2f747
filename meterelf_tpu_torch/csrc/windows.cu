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
// __fdiv_rn is IEEE division, and each window is its own CTA. The window
// body lives in window_bits.cuh, which K5 (frontend.cu) runs too.
#include <cuda_runtime.h>

#include "meterelf_kernels.h"
#include "window_bits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDials = 8;

struct WinGeom {
  int ox[kMaxDials], oy[kMaxDials];  // window origin, template coords
  int cx[kMaxDials], cy[kMaxDials];  // dial center, window coords
  int cr[kMaxDials][3];              // color range (h, l, s)
};

__global__ void __launch_bounds__(kThreads)
    windows_kernel(const int32_t* __restrict__ packed, int H, int W,
                   const int32_t* __restrict__ mx,
                   const int32_t* __restrict__ my, WinGeom g, int D,
                   const uint8_t* __restrict__ disk, int hue_shift,
                   int32_t* __restrict__ bits) {
  __shared__ winbits::Smem sm;
  const int d = blockIdx.x, b = blockIdx.y;
  winbits::window_bits(sm, packed + (size_t)b * H * W, W, mx[b] + g.ox[d],
                       my[b] + g.oy[d], g.cx[d], g.cy[d], g.cr[d][0],
                       g.cr[d][1], g.cr[d][2],
                       disk + (size_t)d * winbits::kPix, hue_shift,
                       bits + ((size_t)b * D + d) * winbits::kPix, kThreads);
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
