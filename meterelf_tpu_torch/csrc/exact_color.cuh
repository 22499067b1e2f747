// OpenCV 3.4 float-path BGR -> HLS_FULL / L, bit-exact.
//
// Every f32 operation is spelled with its round-to-nearest intrinsic, so
// the chain stays the reference's own (u8 * (1/255) -> RGB2HLS_f ->
// saturate_cast) whatever the compiler flags: no FMA contraction (the
// library is also built with --fmad=false), IEEE division (__fdiv_rn),
// half-even rounding (rintf). Counterparts: meterelf_tpu/ops/color.py
// bgr_planes_to_hls / lightness_from_planes and the port's plain
// versions in meterelf_tpu_torch/ops/color.py.
#pragma once
#include <stdint.h>

// f32(1) / f32(255) and f32(256) / f32(360), correctly rounded
#define METERELF_INV255 __int_as_float(0x3b808081)
#define METERELF_HSCALE __int_as_float(0x3f360b61)

__device__ __forceinline__ int meterelf_sat_u8(float x) {
  return (int)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ void meterelf_unpack(int p, float& b, float& g,
                                                float& r) {
  b = __fmul_rn((float)(p & 255), METERELF_INV255);
  g = __fmul_rn((float)((p >> 8) & 255), METERELF_INV255);
  r = __fmul_rn((float)((p >> 16) & 255), METERELF_INV255);
}

// cv2 L channel of one packed pixel, 0..255
__device__ __forceinline__ int meterelf_lightness(int p) {
  float b, g, r;
  meterelf_unpack(p, b, g, r);
  const float vmax = fmaxf(fmaxf(r, g), b);
  const float vmin = fminf(fminf(r, g), b);
  const float l = __fmul_rn(__fadd_rn(vmax, vmin), 0.5f);
  return meterelf_sat_u8(__fmul_rn(l, 255.0f));
}

// S channel of HLS_FULL (0..255) from a pixel's unit-plane max, min and
// l: the denominator is selected first, then divided once. That is the
// same IEEE operation on the same operands as the reference's select of
// two quotients, so a pixel makes two divisions (S, H) and not three.
__device__ __forceinline__ int meterelf_saturation(float vmax, float vmin,
                                                   float l) {
  if (vmax == vmin) return 0;
  const float den = l < 0.5f ? __fadd_rn(vmax, vmin)
                             : __fsub_rn(__fsub_rn(2.0f, vmax), vmin);
  return meterelf_sat_u8(
      __fmul_rn(__fdiv_rn(__fsub_rn(vmax, vmin), den), 255.0f));
}

// H channel of HLS_FULL with the wrapping hue shift (uint8 wraparound)
__device__ __forceinline__ int meterelf_hue(float b, float g, float r,
                                            float vmax, float vmin,
                                            int hue_shift) {
  if (vmax == vmin) return hue_shift & 255;
  const float diff60 = __fdiv_rn(60.0f, __fsub_rn(vmax, vmin));
  float h;
  if (vmax == r) {
    h = __fmul_rn(__fsub_rn(g, b), diff60);
  } else if (vmax == g) {
    h = __fadd_rn(__fmul_rn(__fsub_rn(b, r), diff60), 120.0f);
  } else {
    h = __fadd_rn(__fmul_rn(__fsub_rn(r, g), diff60), 240.0f);
  }
  if (h < 0.0f) h = __fadd_rn(h, 360.0f);
  return (meterelf_sat_u8(__fmul_rn(h, METERELF_HSCALE)) + hue_shift) & 255;
}

// HLS_FULL of one packed pixel with the wrapping hue shift
__device__ __forceinline__ void meterelf_hls(int p, int hue_shift, int& ho,
                                             int& lo, int& so) {
  float b, g, r;
  meterelf_unpack(p, b, g, r);
  const float vmax = fmaxf(fmaxf(r, g), b);
  const float vmin = fminf(fminf(r, g), b);
  const float l = __fmul_rn(__fadd_rn(vmax, vmin), 0.5f);
  ho = meterelf_hue(b, g, r, vmax, vmin, hue_shift);
  lo = meterelf_sat_u8(__fmul_rn(l, 255.0f));
  so = meterelf_saturation(vmax, vmin, l);
}
