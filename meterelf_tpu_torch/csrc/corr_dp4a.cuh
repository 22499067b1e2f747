// The exact int8 template correlation that K1 (frontend.cu) and K8
// (match.cu) share.
//
// With L' = L - 128 and T' = T - 128 both fit int8, so one CTA per image
// stages them in shared memory beside the per-row window sums of L', and
// each thread computes 4 neighbouring x offsets of one output row with
// __dp4a (4 MACs per instruction) from two 32-bit shared loads and three
// byte permutes per template word:
//     corr8[y, x] = sum_{r, c} L'[y + r, x + c] T'[r, c]   (exact in i32:
//                   |corr8| <= th * tw * 128^2 < 2^31)
//     box'[y, x]  = sum_{r, c} L'[y + r, x + c]
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace corr8 {

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Layout {
  int ls;        // bytes per staged L' row (>= W + 8, 16-aligned)
  int ts;        // bytes per staged template row (tw rounded up to 4)
  int off_t;     // byte offset of the template
  int off_rw;    // byte offset of the row-window sums
  int bytes;     // total dynamic shared memory
};

__host__ __device__ inline Layout layout(int H, int W, int th, int tw) {
  Layout g;
  const int ow = W - tw + 1;
  g.ls = round_up(W + 8, 16);
  g.ts = round_up(tw, 4);
  g.off_t = H * g.ls;
  g.off_rw = round_up(g.off_t + th * g.ts, 16);
  // + 4 ints: the last x group may read up to 3 sums past the end
  g.bytes = g.off_rw + (H * ow + 4) * 4;
  return g;
}

// Stage T' (zero past tw) and, once sL holds L' (zero past column W), the
// row-window sums sRW[y, x] = sum_{c < tw} L'[y, x + c]. Ends with a
// barrier.
__device__ inline void stage_template_and_sums(
    unsigned char* smem, const Layout& g, int H, int W,
    const uint8_t* __restrict__ tmpl, int th, int tw, int nthreads) {
  const int8_t* sL = reinterpret_cast<const int8_t*>(smem);
  int8_t* sT = reinterpret_cast<int8_t*>(smem + g.off_t);
  int* sRW = reinterpret_cast<int*>(smem + g.off_rw);
  const int ow = W - tw + 1, tid = threadIdx.x;
  for (int i = tid; i < th * g.ts; i += nthreads) {
    const int y = i / g.ts, x = i - y * g.ts;
    sT[i] = (int8_t)(x < tw ? (int)tmpl[y * tw + x] - 128 : 0);
  }
  __syncthreads();
  for (int y = tid; y < H; y += nthreads) {
    const int8_t* row = sL + y * g.ls;
    int s = 0;
    for (int c = 0; c < tw; ++c) s += row[c];
    sRW[y * ow] = s;
    for (int x = 1; x < ow; ++x) {
      s += row[x + tw - 1] - row[x - 1];
      sRW[y * ow + x] = s;
    }
  }
  if (tid < 4) sRW[H * ow + tid] = 0;
  __syncthreads();
}

// corr8 and box' at (y, x0 .. x0 + 3).
__device__ __forceinline__ void corr4(const unsigned char* smem,
                                      const Layout& g, int ow, int th,
                                      int y, int x0, int acc[4],
                                      int box[4]) {
  const int8_t* sL = reinterpret_cast<const int8_t*>(smem);
  const int8_t* sT = reinterpret_cast<const int8_t*>(smem + g.off_t);
  const int* sRW = reinterpret_cast<const int*>(smem + g.off_rw);
  const int nwords = g.ts / 4;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  for (int r = 0; r < th; ++r) {
    const int* lrow = reinterpret_cast<const int*>(sL + (y + r) * g.ls + x0);
    const int* trow = reinterpret_cast<const int*>(sT + r * g.ts);
    int w0 = lrow[0];
    for (int cw = 0; cw < nwords; ++cw) {
      const int w1 = lrow[cw + 1];
      const int t = trow[cw];
      a0 = __dp4a(w0, t, a0);
      a1 = __dp4a((int)__byte_perm(w0, w1, 0x4321), t, a1);
      a2 = __dp4a((int)__byte_perm(w0, w1, 0x5432), t, a2);
      a3 = __dp4a((int)__byte_perm(w0, w1, 0x6543), t, a3);
      w0 = w1;
    }
    const int* rw = sRW + (y + r) * ow + x0;
    b0 += rw[0];
    b1 += rw[1];
    b2 += rw[2];
    b3 += rw[3];
  }
  acc[0] = a0;
  acc[1] = a1;
  acc[2] = a2;
  acc[3] = a3;
  box[0] = b0;
  box[1] = b1;
  box[2] = b2;
  box[3] = b3;
}

}  // namespace corr8
