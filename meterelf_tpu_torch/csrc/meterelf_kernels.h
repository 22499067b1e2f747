// C interface of the port's CUDA kernels (one shared library, loaded
// with ctypes by meterelf_tpu_torch/_build.py).
//
// Every function launches its kernel on `stream` (a cudaStream_t passed
// as void*), does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 = launched). Pointers are device
// pointers unless a comment says otherwise; arrays are C-contiguous.
#pragma once
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// K1: exact cv2 lightness + TM_CCOEFF as an exact int8 correlation,
// first-max row-major argmax. packed [B, H, W] i32 (b | g<<8 | r<<16),
// tmpl [th, tw] u8. c1 = 128 - tmean (f32), c0 = the f32 residual of
// the f32-rounded template mean. Out: max_val [B] f32, mx/my [B] i32.
// Takes crops within 256 x 256 with at most 128 x and 208 y offsets
// (else returns cudaErrorInvalidValue).
int meterelf_frontend(const int32_t* packed, int B, int H, int W,
                      const uint8_t* tmpl, int th, int tw,
                      float c1, float c0,
                      float* max_val, int32_t* mx, int32_t* my,
                      void* stream);

// Shared memory K1 needs for one image (bytes), or -1 for a geometry it
// does not take; the wrapper refuses geometries above the card's
// per-block limit.
int meterelf_frontend_smem_bytes(int H, int W, int th, int tw);

// K5: K1, then in the same block K2's windows of its 4 dials at the
// located (mx, my). geom (HOST pointer) holds 7 ints per dial as K2's;
// disk [4, 64, 64] u8. Out: max_val [B] f32, mx/my [B] i32 as K1's, bits
// [B, 4, 64, 64] i32 as K2's.
int meterelf_frontend_windows(const int32_t* packed, int B, int H, int W,
                              const uint8_t* tmpl, int th, int tw,
                              float c1, float c0, const int32_t* geom,
                              const uint8_t* disk, int hue_shift,
                              float* max_val, int32_t* mx, int32_t* my,
                              int32_t* bits, void* stream);

// K2: the D dial windows of each image at (mx + ox_d, my + oy_d):
// exact HLS_FULL + hue shift, 5x5 center sample, inRange, 3x3 close.
// geom (HOST pointer) holds 7 ints per dial: ox, oy, cx, cy, cr_h, cr_l,
// cr_s. disk [D, 64, 64] u8 (0/1). Out: bits [B, D, 64, 64] i32 =
// masked | disk<<1 | closed<<2 | raw<<3.
int meterelf_windows(const int32_t* packed, int B, int H, int W,
                     const int32_t* mx, const int32_t* my,
                     const int32_t* geom, int D, const uint8_t* disk,
                     int hue_shift, int32_t* bits, void* stream);

// K3: per 64x64 window, 8-connected labels, the 4-connected outside
// flood, the hole-ownership fill and the boundary bit, under pass caps.
// bits [K, 64, 64] i32 as K2 writes them. Out: okey3 [K, 64, 64] i32 =
// owner*8 + closed*4 + masked*2 + boundary (owner 4096 off support),
// converged [K] u8.
int meterelf_ccl(const int32_t* bits, int K, int k_label, int k_outside,
                 int k_fill, int32_t* okey3, uint8_t* converged,
                 void* stream);

// K6: K3 without the closed bit (the general-geometry branch's CCL).
// bits [K, 64, 64] i32, bits 0-1 read (masked | disk<<1). Out: okey
// [K, 64, 64] i32 = owner*4 + masked*2 + boundary, converged [K] u8.
int meterelf_propagate(const int32_t* bits, int K, int k_label,
                       int k_outside, int k_fill, int32_t* okey,
                       uint8_t* converged, void* stream);

// K8: the TM_CCOEFF score map. lightness [B, H, W] f32 (integers
// 0..255), tmpl [th, tw] u8 with tsum its sum, tmean f32. Out: scores
// [B, H-th+1, W-tw+1] f32 = corr - tmean*box, corr and box exact.
int meterelf_match_scores(const float* lightness, int B, int H, int W,
                          const uint8_t* tmpl, int th, int tw, int tsum,
                          float tmean, float* scores, void* stream);

// K9: the exact correlation corr = sum L*T (i32) of every offset, written
// as f32 [B, H-th+1, W-tw+1]. lightness and tmpl as K8's.
int meterelf_match_corr(const float* lightness, int B, int H, int W,
                        const uint8_t* tmpl, int th, int tw, int tsum,
                        float* corr, void* stream);

// K4: per window, marching-squares areas and boundary counts per owner;
// keymax = max(area2*4096 + owner) over owners with a boundary pixel,
// else -1; has_any = any masked pixel. okey3 [K, 4096] i32.
int meterelf_stats(const int32_t* okey3, int K, int32_t* keymax,
                   uint8_t* has_any, void* stream);

// K7: okey [K, 4096] i32 = owner*4 + masked*2 + boundary, contrib [K,
// 4096] i32 cell contributions (low 2 bits read). Out: keymax [K] i32 =
// max(area2*4096 + owner) over owners with a boundary pixel, else -1,
// both histograms binned under each pixel's owner.
int meterelf_stats_select(const int32_t* okey, const int32_t* contrib,
                          int K, int32_t* keymax, void* stream);

// JPEG back-half geometry (HOST pointer geom, 10 ints): lh, lw (luma
// plane of the coefficient window), oy, ox, rh, rw (crop in the window),
// ch_valid, cw_valid (valid chroma samples), ph, pw (output staging
// shape; pixels outside the crop are written 0).
//
// K10: frequency-plane coefficients -> packed BGR crops. compact = 1:
// fy [B, lh*3/2, lw], fcb/fcr [B, lh*3/4, lw/2] int8 (compact wire);
// compact = 0: fy [B, lh, lw], fcb/fcr [B, lh/2, lw/2] i16. Planes must
// be 16-byte aligned. qt [B, 3, 64] u16, natural order. Out: [B, ph, pw]
// i32 (b | g<<8 | r<<16).
int meterelf_backhalf_planes(const void* fy, const void* fcb,
                             const void* fcr, int compact,
                             const uint16_t* qt, int B,
                             const int32_t* geom, int32_t* out,
                             void* stream);

// K11: spatial u8 planes y [B, lh, lw], cb/cr [B, lh/2, lw/2] -> [B, ph,
// pw] packed BGR i32 (upsample, colour, crop).
int meterelf_upsample_color_pack(const uint8_t* y, const uint8_t* cb,
                                 const uint8_t* cr, int B,
                                 const int32_t* geom, int32_t* out,
                                 void* stream);

// K12: the dial angle statistics and the value, per window of B images
// x D dials (1 <= D <= 8). src: okey3 [B, D, 4096] i32 with keymax [B,
// D] i32 (region = 0; the needle is the selected owner of a big blob,
// else the closed bit), or the needle region [B, D, 4096] bool (region =
// 1; keymax unused). The geometry (ParamArrays' fields): disk_idx,
// disk_valid [D, n_disk] i32 / u8, disk_sx2 and disk_sy2 [D, n_disk];
// ann_idx, ann_valid [D, n_ann] i32 / u8, ann_x, ann_y, ann_angle and
// ann_sqd [D, n_ann]; neg_sign [D] i32; zero_turn [D]; the floating
// fields f32 (geom_f32 = 1) or f64. n_disk and n_ann in 1..4096. p0..p3:
// value_perm (read when D == 4). Out: position [B, D] f64, readable [B,
// D] u8, value [B] f64 (0 unless D == 4).
int meterelf_readout(const void* src, int region, const int32_t* keymax,
                     int B, int D, const int32_t* disk_idx,
                     const uint8_t* disk_valid, const void* disk_sx2,
                     const void* disk_sy2, int n_disk,
                     const int32_t* ann_idx, const uint8_t* ann_valid,
                     const void* ann_x, const void* ann_y,
                     const void* ann_angle, const void* ann_sqd, int n_ann,
                     const int32_t* neg_sign, const void* zero_turn,
                     int geom_f32, int p0, int p1, int p2, int p3,
                     double* position, uint8_t* readable, double* value,
                     void* stream);

// K13: the decode's error codes and converged reduction, and every
// BatchResult field, per row of B images x D dials (1 <= D <= 8).
// load_ok [B] u8, max_val [B] f32, mx/my [B] i32; threshold the match
// threshold as f32; has_any and conv [B, D] u8 (a dial's masked image is
// nonempty; its CCL converged); position [B, D] f64, readable [B, D] u8
// and value [B] f64 (K12's outputs). Out, each a device pointer (into
// one buffer, ops/result.py layout): err, first_bad_dial,
// unreadable_bits [B] i32; match_val [B] f32; match_x, match_y [B] i32;
// dial_pos [B, D] f64; readable_out [B, D] u8; value_out [B] f64;
// converged [B] u8.
int meterelf_result_pack(const uint8_t* load_ok, const float* max_val,
                         const int32_t* mx, const int32_t* my,
                         float threshold, const uint8_t* has_any,
                         const uint8_t* conv, const double* position,
                         const uint8_t* readable, const double* value,
                         int B, int D, int32_t* err,
                         int32_t* first_bad_dial, int32_t* unreadable_bits,
                         float* match_val, int32_t* match_x,
                         int32_t* match_y, double* dial_pos,
                         uint8_t* readable_out, double* value_out,
                         uint8_t* converged, void* stream);

#ifdef __cplusplus
}
#endif
