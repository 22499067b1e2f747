// The exact int8 template correlation that K1/K5 (frontend.cu) and K8/K9
// (match.cu) share, as an implicit GEMM on Hopper's int8 tensor cores.
//
// With L' = L - 128 and T' = T - 128 both int8, per image
//     corr8[y, x] = sum_{r, c} L'[y + r, x + c] T'[r, c]   (exact in i32:
//                   |corr8| <= th * tw * 128^2 < 2^31)
//     box'[y, x]  = sum_{r, c} L'[y + r, x + c]
// For each template row r, corr8 is the product of a band matrix built
// from T' row r with the staged L' rows r .. r + oh - 1:
//     corr8[y, x] = sum_r sum_k A_r[x, k] B_r[k, y],
//     A_r[x, k] = T'[r, k - x] if 0 <= k - x < tw, else 0,
//     B_r[k, y] = L'[y + r, k],
// run as mma.sync.m16n8k32 (s8 x s8 -> s32) with M = x (ow padded to 16),
// N = y (oh padded to 8), and for an x tile at x0 only the nj k32 steps
// k0 = x0 + 32 j that hold its band (nj = ceil((tw + 15) / 32)). Every
// product is exact and every partial sum is below 2^31, so the result
// equals the plain version bit for bit in any order.
//
// The band fragment, A_r[x0 + m, x0 + 32 j + kk] = T'[r, 32 j + kk - m],
// does not depend on the tile: a warp builds it once per (r, j) in
// registers, two aligned 32-bit shared loads and one byte permute per
// fragment register, from the staged template row, whose 16-byte zero
// margins on both sides make the band's edges read zeros. It then runs it
// against each of its tiles, whose L' fragment is one ldmatrix from
// 16-byte-aligned row segments (x0 is a multiple of 16; the row stride is
// 16 bytes times an odd number, so the 8 rows of a matrix fall in
// distinct banks). Rows and columns past the image are staged as zeros.
//
// box' = P[y + th, x] - P[y, x], with P the column prefix sum of the
// row-window sums, P[y', x] = sum_{y'' < y'} sum_{c < tw} L'[y'', x + c],
// staged beside the operands.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace corr8 {

constexpr int kMargin = 16;    // zero bytes before each staged template row
constexpr int kMaxTiles = 8;   // (16 x, 8 y) tiles a warp holds at once

struct Layout {
  int oh, ow;    // valid offsets
  int mt, nt;    // 16-wide x tiles, 8-high y tiles
  int nj;        // k32 steps per template row
  int ls;        // bytes per staged L' row: 16 * odd, >= 16 (mt - 1) + 32 nj
  int lrows;     // staged L' rows: 8 nt + th - 1 (those past H are zero)
  int ts;        // bytes per staged template row: margins + 32 nj
  int off_t;     // byte offset of the template
  int off_p;     // byte offset of P, [H + 1, ow] i32
  int bytes;     // total dynamic shared memory
};

__host__ __device__ inline Layout layout(int H, int W, int th, int tw) {
  Layout g;
  g.oh = H - th + 1;
  g.ow = W - tw + 1;
  g.mt = (g.ow + 15) / 16;
  g.nt = (g.oh + 7) / 8;
  g.nj = (tw + 15 + 31) / 32;
  g.ls = 16 * (g.mt - 1) + 32 * g.nj;
  if (g.ls % 32 == 0) g.ls += 16;
  g.lrows = 8 * g.nt + th - 1;
  g.ts = 32 * g.nj + 2 * kMargin;
  g.off_t = g.lrows * g.ls;
  g.off_p = g.off_t + th * g.ts;
  g.bytes = g.off_p + (H + 1) * g.ow * 4;
  return g;
}

// Stage T' with its zero margins and, once sL holds L' (zero past row H
// and column W), P. Ends with a barrier.
__device__ inline void stage_template_and_sums(
    unsigned char* smem, const Layout& g, int H,
    const uint8_t* __restrict__ tmpl, int th, int tw, int nthreads) {
  const int8_t* sL = reinterpret_cast<const int8_t*>(smem);
  int8_t* sT = reinterpret_cast<int8_t*>(smem + g.off_t);
  int* sP = reinterpret_cast<int*>(smem + g.off_p);
  const int ow = g.ow, tid = threadIdx.x;
  for (int i = tid; i < th * g.ts; i += nthreads) {
    const int y = i / g.ts, c = i - y * g.ts - kMargin;
    sT[i] = (int8_t)(c >= 0 && c < tw ? (int)tmpl[y * tw + c] - 128 : 0);
  }
  __syncthreads();  // sL, staged by the caller, is read across rows below
  // row-window sums of row y into P row y + 1
  for (int y = tid; y < H; y += nthreads) {
    const int8_t* row = sL + y * g.ls;
    int* out = sP + (y + 1) * ow;
    int s = 0;
    for (int c = 0; c < tw; ++c) s += row[c];
    out[0] = s;
    for (int x = 1; x < ow; ++x) {
      s += row[x + tw - 1] - row[x - 1];
      out[x] = s;
    }
  }
  __syncthreads();
  for (int x = tid; x < ow; x += nthreads) {
    int s = 0;
    sP[x] = 0;
    for (int y = 1; y <= H; ++y) {
      s += sP[y * ow + x];
      sP[y * ow + x] = s;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int box(const unsigned char* smem, const Layout& g,
                                   int th, int y, int x) {
  const int* sP = reinterpret_cast<const int*>(smem + g.off_p);
  return sP[(y + th) * g.ow + x] - sP[y * g.ow + x];
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& b0,
                                        uint32_t& b1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kN tiles of one warp, t0 .. t0 + kN - 1: their corr8 in registers over
// every template row and k32 step, then epi(y, x, corr8) for each valid
// offset (y < oh, x < ow) of the lane's accumulators.
template <int kN, class Epi>
__device__ __forceinline__ void warp_tiles(const unsigned char* smem,
                                           const Layout& g, int th, int t0,
                                           Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // The lane's band bytes: fragment registers a[1], a[0], a[3], a[2] hold
  // the 4 template bytes from 32 j + 4 tq - gq - 8, -0, +8 and +16, so
  // from staged byte kMargin + 32 j + 4 tq - gq - 8 on, the lane reads 8
  // consecutive aligned words a step; all four share the byte shift
  // (-gq) & 3.
  const uint32_t* sT = reinterpret_cast<const uint32_t*>(smem + g.off_t) +
                       ((kMargin - 8 + 4 * tq - gq) >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)((-gq) & 3);
  const uint32_t sL = (uint32_t)__cvta_generic_to_shared(smem);
  uint32_t base[kN];
  int acc[kN][4];
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    const int mt = (t0 + t) / g.nt, nt = t0 + t - mt * g.nt;
    // ldmatrix rows: lanes 0-7 the 8 rows at k0, lanes 8-15 at k0 + 16
    base[t] = sL + (8 * nt + (lane & 7)) * g.ls + 16 * mt +
              16 * ((lane >> 3) & 1);
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
  }
  for (int r = 0; r < th; ++r) {
    const uint32_t* trow = sT + r * (g.ts / 4);
    const uint32_t lrow = r * g.ls;
    for (int j = 0; j < g.nj; ++j) {
      const uint32_t* w = trow + 8 * j;
      uint32_t a[4];
      a[1] = __byte_perm(w[0], w[1], sel);  // rows gq + 8, k 4 tq ..
      a[0] = __byte_perm(w[2], w[3], sel);  // rows gq,     k 4 tq ..
      a[3] = __byte_perm(w[4], w[5], sel);  // rows gq + 8, k 16 + 4 tq ..
      a[2] = __byte_perm(w[6], w[7], sel);  // rows gq,     k 16 + 4 tq ..
      const uint32_t off = lrow + 32 * j;
      uint32_t b[kN][2];
#pragma unroll
      for (int t = 0; t < kN; ++t) ldsm_x2(base[t] + off, b[t][0], b[t][1]);
#pragma unroll
      for (int t = 0; t < kN; ++t) mma_s8(acc[t], a, b[t][0], b[t][1]);
    }
  }
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    const int mt = (t0 + t) / g.nt, nt = t0 + t - mt * g.nt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // accumulator i: row (x) gq + 8 (i / 2), column (y) 2 tq + i % 2
      const int x = 16 * mt + gq + 8 * (i >> 1);
      const int y = 8 * nt + 2 * tq + (i & 1);
      if (x < g.ow && y < g.oh) epi(y, x, acc[t][i]);
    }
  }
}

// The block's corr8, after stage_template_and_sums: the mt * nt tiles are
// dealt to the kWarps warps in passes of at most kMaxTiles a warp (warp w
// takes tiles [(p * kWarps + w) * nb, + nb) in pass p), each warp's count
// a compile-time constant so that its accumulators stay in registers.
template <int kWarps, class Epi>
__device__ __forceinline__ void correlate(const unsigned char* smem,
                                          const Layout& g, int th, Epi&& epi) {
  const int warp = threadIdx.x >> 5;
  const int ntiles = g.mt * g.nt;
  const int passes =
      (ntiles + kWarps * kMaxTiles - 1) / (kWarps * kMaxTiles);
  const int nb = (ntiles + kWarps * passes - 1) / (kWarps * passes);
  static_assert(kMaxTiles == 8, "the dispatch below covers 1 .. 8 tiles");
  for (int p = 0; p < passes; ++p) {
    const int t0 = (p * kWarps + warp) * nb;
    switch (min(nb, ntiles - t0)) {  // the same in every lane of a warp
      case 1: warp_tiles<1>(smem, g, th, t0, epi); break;
      case 2: warp_tiles<2>(smem, g, th, t0, epi); break;
      case 3: warp_tiles<3>(smem, g, th, t0, epi); break;
      case 4: warp_tiles<4>(smem, g, th, t0, epi); break;
      case 5: warp_tiles<5>(smem, g, th, t0, epi); break;
      case 6: warp_tiles<6>(smem, g, th, t0, epi); break;
      case 7: warp_tiles<7>(smem, g, th, t0, epi); break;
      case 8: warp_tiles<8>(smem, g, th, t0, epi); break;
      default: break;  // no tile left for this warp
    }
  }
}

}  // namespace corr8
