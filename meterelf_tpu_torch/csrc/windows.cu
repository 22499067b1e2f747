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
// What bounds it on the H100: its bytes. 4096 pixels a window, 16 KB read
// and 16 KB written, 0.010 ms for the flagship's 1024 windows at 3.35
// TB/s; the HLS chain (two IEEE divisions and ~60 other fp32 and int
// instructions a pixel) comes second. The design (window_bits.cuh): each
// warp takes the colour sample itself, converts its band of rows straight
// into raw-mask row words with __ballot_sync (512 bytes of shared memory
// a window, no H/L/S planes, the divisions skipped where no lane of the
// warp passes the lightness test), and after one barrier closes the row
// words in registers and writes one int2 a lane. kThreads = 128 (4 warps
// of 16 rows) and one window a CTA: 1024 CTAs of ~1 KB fit the SMs in one
// wave. The Dekker division and the lane-rotated quad layout of the TPU
// kernel are not needed here: __fdiv_rn is IEEE division, and each window
// is its own CTA. The window body lives in window_bits.cuh, which K5
// (frontend.cu) runs too.
#include <cuda_runtime.h>

#include "meterelf_kernels.h"
#include "window_bits.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps of 16 rows, one window a CTA
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
  __shared__ uint64_t words[winbits::kWin];
  // the block's window k = b * D + d
  const int k = blockIdx.x;
  const int b = k / D, d = k - b * D;
  winbits::Win w;
  w.W = W;
  w.img = packed + ((size_t)b * H + my[b] + g.oy[d]) * W + mx[b] + g.ox[d];
  w.sx = winbits::sample_start(g.cx[d]);
  w.sy = winbits::sample_start(g.cy[d]);
  for (int c = 0; c < 3; ++c) w.cr[c] = g.cr[d][c];
  w.dk = disk + (size_t)d * winbits::kPix;
  w.out = bits + (size_t)k * winbits::kPix;
  winbits::window_bits<kThreads / 32, 1>(words, w, hue_shift);
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
  windows_kernel<<<B * D, kThreads, 0, (cudaStream_t)stream>>>(
      packed, H, W, mx, my, g, D, disk, hue_shift, bits);
  return (int)cudaGetLastError();
}
