// K3 `ccl` and K6 `propagate`: connected components of each 64x64 needle
// mask, the findContours replacement.
//
// K3 replaces meterelf_tpu/ops/pallas_ccl.py propagate_quads
// (_ccl_kernel, pack_closed=True), the quad branch's CCL; K6 replaces
// pallas_ccl.py propagate (_ccl_kernel on the pair layout), the CCL of
// the general-geometry branch (components.analyze_batch). Both run the
// pass schedule of their reference, meterelf_tpu/ops/components.py
// _propagate_xla, pass for pass, in one kernel body; a compile-time flag
// picks the key: K3 okey3 = owner*8 + closed*4 + masked*2 + boundary, K6
// okey = owner*4 + masked*2 + boundary (no closed bit).
//   1. 8-connected labels (min flat index per component): each half-pass
//      is a Jacobi 3x3 min glue, then segmented min sweeps along rows and
//      then columns, forward on even halves and backward on odd ones
//      (_ALT_DIRS), at most k_label halves;
//   2. the background 4-connected to beyond the dial disk ("outside"):
//      the same halves with any4 glue and segmented OR sweeps, at most
//      k_outside;
//   3. enclosed holes take the min label of their 3x3 neighbourhood
//      (Jacobi), at most k_fill passes;
//   4. the key, with owner 4096 off the support (masked | enclosed) and
//      boundary = masked next to outside (8-neighbourhood).
// The kernel runs phase 2 first: the outside reads no label.
// A phase has converged when its last executed pass changed nothing. All
// steps are monotone (labels only fall, the outside only grows), so a
// pass that changes nothing is a fixpoint of every later pass: stopping
// there gives the state and the flag that running all `cap` passes gives,
// and a capped window keeps the partial state of this schedule.
//
// What bounds it on the H100: not bytes (16 KB in and 16 KB out a window,
// 0.010 ms for 1024 windows at 3.35 TB/s) but the chain of dependent
// steps a pass is. The TPU kernel runs each sweep as a log-step scan
// across lanes (_blk_scan, nsteps=6); a walk of 64 cells a line, by 64
// threads while the rest of the block waits, costs 128 dependent shared
// memory steps a pass. This design keeps every sweep a log-step scan:
//   - the outside flood runs on bit planes: one 64-bit word a row, two
//     rows a lane, in the registers of every warp (each warp computes the
//     same words, so the fill and the key read them with no barrier).
//     any4 is word shifts plus the neighbour rows by shuffle; the row
//     sweep a Kogge-Stone fill inside the word (x |= g & (x << s),
//     g &= g << s, s = 1..32; mirrored backward, g the background); the
//     column sweep the same recurrence across the 64 row words, two in a
//     lane then five shuffle steps; no shared memory, no barrier;
//   - labels are uint16 in shared memory (0..4096, 4096 the sentinel),
//     two buffers so that the 3x3 glue reads the pre-pass state while
//     the row sweep writes (glue and row sweep are one step of one warp
//     a row). A sweep of a line is one warp: two cells a lane, the
//     segmented min turned into a plain prefix max of run-id * 8192 +
//     (8191 - label) (the reference's own offset trick, run ids by
//     popcount of the wall word), five shuffle steps. Rows and columns
//     are dealt round-robin to the four warps; each warp lists its lines
//     with a masked cell once (the others hold 4096 in both buffers and
//     are skipped) and sweeps them kLines at a time, independent shuffle
//     chains that the scheduler interleaves. The row stride of 65 cells
//     puts a column's 64 cells in 32 banks;
//   - the fill touches only rows with enclosed cells, and when the
//     window has none it is the one pass that changes nothing (converged,
//     as the reference) and touches no memory.
// One window a CTA of four warps, 19,712 bytes of shared memory and at
// most 48 registers (10 CTAs an SM): 1024 (K3) or 1280 (K6) windows fill
// the 132 SMs in one wave. A pass has two barriers (after the row step,
// and the OR of "changed" after the column step).
#include <cuda_runtime.h>

#include "meterelf_kernels.h"

namespace {

typedef unsigned long long u64;

constexpr int kWin = 64;
constexpr int kPix = kWin * kWin;
constexpr int kWarps = 4;
constexpr int kLines = 2;          // lines a warp sweeps at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kWin + 1;  // u16 cells a label row (odd: see above)
constexpr int kBig = kPix;         // label sentinel
constexpr int kSeg = 8192;         // > any label: the run-id offset
constexpr unsigned kAll = 0xffffffffu;

struct Smem {
  uint16_t lab[2][kWin * kStride];  // labels, then owners (ping-pong)
  u64 masked[kWin];                 // row words: bit x of word y = (y, x)
  u64 disk[kWin];
  u64 closed[kWin];
  u64 masked_t[kWin];               // column words: bit y of word x
  u64 boundary[kWin];
  u64 enclosed[kWin];
};

// Segmented min scans of N lines (rows or columns), two cells a lane at
// positions 2*lane and 2*lane + 1; `wall` has a bit at each position that
// ends a run (a non-masked cell, whose value is kBig). Equal to the
// serial sweep: each cell takes the min over its run up to it in scan
// order. The key rid * kSeg + (kSeg - 1 - v), rid = walls at or before
// the cell in scan order, turns it into an unsegmented prefix max. The N
// lines' shuffle chains are independent, so the scheduler interleaves
// them.
template <int N>
__device__ __forceinline__ void seg_min_scan(int (&v0)[N], int (&v1)[N],
                                             const u64 (&wall)[N], bool rev,
                                             int lane) {
  const int p0 = 2 * lane;
  int k[N], t[N];
  if (!rev) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r0 = __popcll(wall[i] & ((2ull << p0) - 1));
      const int r1 = r0 + (int)((wall[i] >> (p0 + 1)) & 1);
      k[i] = r0 * kSeg + (kSeg - 1 - v0[i]);
      t[i] = max(r1 * kSeg + (kSeg - 1 - v1[i]), k[i]);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int u = __shfl_up_sync(kAll, t[i], d);
        if (lane >= d) t[i] = max(t[i], u);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int e = __shfl_up_sync(kAll, t[i], 1);
      if (lane == 0) e = 0;
      v0[i] = kSeg - 1 - (max(k[i], e) & (kSeg - 1));
      v1[i] = kSeg - 1 - (t[i] & (kSeg - 1));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r1 = __popcll(wall[i] >> (p0 + 1));
      const int r0 = r1 + (int)((wall[i] >> p0) & 1);
      k[i] = r1 * kSeg + (kSeg - 1 - v1[i]);
      t[i] = max(r0 * kSeg + (kSeg - 1 - v0[i]), k[i]);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int u = __shfl_down_sync(kAll, t[i], d);
        if (lane + d < 32) t[i] = max(t[i], u);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int e = __shfl_down_sync(kAll, t[i], 1);
      if (lane == 31) e = 0;
      v0[i] = kSeg - 1 - (t[i] & (kSeg - 1));
      v1[i] = kSeg - 1 - (max(k[i], e) & (kSeg - 1));
    }
  }
}

// 3x3 min of N rows y at the lane's cells (2*lane, 2*lane + 1) from
// labels `f`: the centres (c0, c1) and the minima (g0, g1)
template <int N>
__device__ __forceinline__ void min3x3_rows(const uint16_t* f,
                                            const int (&y)[N], int lane,
                                            int (&c0)[N], int (&c1)[N],
                                            int (&g0)[N], int (&g1)[N]) {
  const int x0 = 2 * lane;
  int v0[N], v1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint16_t* row = f + y[i] * kStride + x0;
    const int up = y[i] > 0 ? -kStride : 0;
    const int dn = y[i] < kWin - 1 ? kStride : 0;
    c0[i] = row[0];
    c1[i] = row[1];
    v0[i] = min(c0[i], min((int)row[up], (int)row[dn]));
    v1[i] = min(c1[i], min((int)row[up + 1], (int)row[dn + 1]));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int left = __shfl_up_sync(kAll, v1[i], 1);
    int right = __shfl_down_sync(kAll, v0[i], 1);
    if (lane == 0) left = kBig;
    if (lane == 31) right = kBig;
    g0[i] = min(min(left, v0[i]), v1[i]);
    g1[i] = min(min(v0[i], v1[i]), right);
  }
}

// the next N lines of a warp's list `todo` (bit j: line warp + kWarps*j);
// slots past its end repeat the first line and are marked not real
template <int N>
__device__ __forceinline__ void next_lines(unsigned& todo, int warp,
                                           int (&line)[N], bool (&real)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    real[i] = todo != 0;
    line[i] = real[i] ? warp + kWarps * (__ffs(todo) - 1) : line[0];
    todo &= todo - 1;
  }
}

// segmented OR fill inside a row word: x_t |= g_t & x_{t-1} in scan
// order, g the background (the cells a run passes through)
__device__ __forceinline__ u64 row_fill(u64 x, u64 g, bool rev) {
  if (!rev) {
#pragma unroll
    for (int s = 1; s < kWin; s <<= 1) {
      x |= g & (x << s);
      g &= g << s;
    }
  } else {
#pragma unroll
    for (int s = 1; s < kWin; s <<= 1) {
      x |= g & (x >> s);
      g &= g >> s;
    }
  }
  return x;
}

// the same fill down (or up) the columns: all 64 columns at once, rows
// 2*lane (a0, background p0) and 2*lane + 1 (a1, p1) in this lane
__device__ __forceinline__ void col_fill(u64& a0, u64& a1, u64 p0, u64 p1,
                                         bool rev, int lane) {
  if (!rev) {
    u64 x = a1 | (p1 & a0), q = p1 & p0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 xu = __shfl_up_sync(kAll, x, d);
      const u64 qu = __shfl_up_sync(kAll, q, d);
      if (lane >= d) {
        x |= q & xu;
        q &= qu;
      }
    }
    u64 e = __shfl_up_sync(kAll, x, 1);
    if (lane == 0) e = 0;
    a0 |= p0 & e;
    a1 = x;
  } else {
    u64 x = a0 | (p0 & a1), q = p0 & p1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 xd = __shfl_down_sync(kAll, x, d);
      const u64 qd = __shfl_down_sync(kAll, q, d);
      if (lane + d < 32) {
        x |= q & xd;
        q &= qd;
      }
    }
    u64 e = __shfl_down_sync(kAll, x, 1);
    if (lane == 31) e = 0;
    a1 |= p1 & e;
    a0 = x;
  }
}

template <bool kClosedBit>
__global__ void __launch_bounds__(kThreads, 10)
    ccl_kernel(const int32_t* __restrict__ bits, int k_label, int k_outside,
               int k_fill, int32_t* __restrict__ okey,
               uint8_t* __restrict__ converged) {
  __shared__ Smem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* in = bits + (size_t)blockIdx.x * kPix;

  // ---- load: bit words by ballot (a warp reads half a row), labels ----
#pragma unroll 8
  for (int j = 0; j < kPix / kThreads; ++j) {
    const int p = j * kThreads + tid, y = p >> 6, x = p & 63;
    const int b = in[p];
    const unsigned mk = __ballot_sync(kAll, b & 1);
    const unsigned dk = __ballot_sync(kAll, b & 2);
    const unsigned cl = kClosedBit ? __ballot_sync(kAll, b & 4) : 0u;
    if (lane == 0) {
      const int h = 2 * y + (x >> 5);
      reinterpret_cast<unsigned*>(s.masked)[h] = mk;
      reinterpret_cast<unsigned*>(s.disk)[h] = dk;
      if (kClosedBit) reinterpret_cast<unsigned*>(s.closed)[h] = cl;
    }
    s.lab[0][y * kStride + x] = (b & 1) ? p : kBig;
    s.lab[1][y * kStride + x] = kBig;
  }
  __syncthreads();

  // ---- column mask words (the column sweeps' walls and skips) ----
  {
    const u64 lo = s.masked[lane], hi = s.masked[lane + 32];
    for (int c = warp; c < kWin; c += kWarps) {
      const unsigned a = __ballot_sync(kAll, (lo >> c) & 1);
      const unsigned b = __ballot_sync(kAll, (hi >> c) & 1);
      if (lane == 0) s.masked_t[c] = a | ((u64)b << 32);
    }
  }

  // ---- 2. outside flood on row words, in every warp's registers ----
  // the lane's two positions along a line: its rows of the bit words,
  // its cells of a row or column sweep
  const int i0 = 2 * lane, i1 = i0 + 1;
  const u64 m0 = s.masked[i0], m1 = s.masked[i1];
  const u64 bg0 = ~m0, bg1 = ~m1;
  u64 o0 = bg0 & ~s.disk[i0], o1 = bg1 & ~s.disk[i1];
  bool out_conv = k_outside == 0;
  for (int it = 0; it < k_outside; ++it) {
    const bool rev = it & 1;
    const u64 up = __shfl_up_sync(kAll, o1, 1);    // row i0 - 1
    const u64 dn = __shfl_down_sync(kAll, o0, 1);  // row i1 + 1
    u64 n0 = o0 | (bg0 & ((o0 << 1) | (o0 >> 1) | (lane ? up : 0) | o1));
    u64 n1 = o1 | (bg1 & ((o1 << 1) | (o1 >> 1) | o0 | (lane < 31 ? dn : 0)));
    n0 = row_fill(n0, bg0, rev);
    n1 = row_fill(n1, bg1, rev);
    col_fill(n0, n1, bg0, bg1, rev, lane);
    const bool ch = __any_sync(kAll, n0 != o0 || n1 != o1);
    o0 = n0;
    o1 = n1;
    if (!ch) {
      out_conv = true;
      break;
    }
  }
  // boundary = masked & any8(outside); enclosed = background & ~outside
  {
    const u64 h0 = o0 | (o0 << 1) | (o0 >> 1), h1 = o1 | (o1 << 1) | (o1 >> 1);
    const u64 hu = __shfl_up_sync(kAll, h1, 1), hd = __shfl_down_sync(kAll, h0, 1);
    if (warp == 0) {
      s.boundary[i0] = m0 & ((lane ? hu : 0) | h0 | h1);
      s.boundary[i1] = m1 & (h0 | h1 | (lane < 31 ? hd : 0));
      s.enclosed[i0] = bg0 & ~o0;
      s.enclosed[i1] = bg1 & ~o1;
    }
  }
  const bool any_enclosed = __any_sync(kAll, ((bg0 & ~o0) | (bg1 & ~o1)) != 0);
  __syncthreads();

  // ---- 1. labels ----
  // this warp's rows (row warp + kWarps*j at bit j) and columns with a
  // masked cell; the others hold kBig in both buffers and are skipped
  const unsigned my_rows = __ballot_sync(
      kAll, lane < kWin / kWarps && s.masked[warp + kWarps * lane] != 0);
  const unsigned my_cols = __ballot_sync(
      kAll, lane < kWin / kWarps && s.masked_t[warp + kWarps * lane] != 0);
  uint16_t* src = s.lab[0];
  uint16_t* dst = s.lab[1];
  bool lab_conv = k_label == 0;
  for (int it = 0; it < k_label; ++it) {
    const bool rev = it & 1;
    bool ch = false;
    // glue from src and row sweep, kLines rows a warp at a time, into dst
    for (unsigned todo = my_rows; todo;) {
      int y[kLines], c0[kLines], c1[kLines], v0[kLines], v1[kLines];
      bool real[kLines];
      u64 wall[kLines];
      next_lines(todo, warp, y, real);
      min3x3_rows(src, y, lane, c0, c1, v0, v1);
#pragma unroll
      for (int k = 0; k < kLines; ++k) {
        const u64 m = s.masked[y[k]];
        if (!((m >> i0) & 1)) v0[k] = kBig;
        if (!((m >> i1) & 1)) v1[k] = kBig;
        wall[k] = ~m;
      }
      seg_min_scan(v0, v1, wall, rev, lane);
#pragma unroll
      for (int k = 0; k < kLines; ++k) {
        if (!real[k]) continue;
        ch |= v0[k] != c0[k] || v1[k] != c1[k];
        dst[y[k] * kStride + i0] = v0[k];
        dst[y[k] * kStride + i1] = v1[k];
      }
    }
    __syncthreads();
    // column sweep in place, kLines columns a warp at a time
    for (unsigned todo = my_cols; todo;) {
      int c[kLines], a0[kLines], a1[kLines], v0[kLines], v1[kLines];
      bool real[kLines];
      u64 wall[kLines];
      next_lines(todo, warp, c, real);
#pragma unroll
      for (int k = 0; k < kLines; ++k) {
        a0[k] = v0[k] = dst[i0 * kStride + c[k]];
        a1[k] = v1[k] = dst[i1 * kStride + c[k]];
        wall[k] = ~s.masked_t[c[k]];
      }
      seg_min_scan(v0, v1, wall, rev, lane);
#pragma unroll
      for (int k = 0; k < kLines; ++k) {
        if (!real[k]) continue;
        if (v0[k] != a0[k]) dst[i0 * kStride + c[k]] = v0[k];
        if (v1[k] != a1[k]) dst[i1 * kStride + c[k]] = v1[k];
        ch |= v0[k] != a0[k] || v1[k] != a1[k];
      }
    }
    const bool any = __syncthreads_or(ch);
    uint16_t* t = src;
    src = dst;
    dst = t;
    if (!any) {
      lab_conv = true;
      break;
    }
  }

  // ---- 3. hole-ownership fill (src is kBig off the mask) ----
  bool fill_conv = true;
  if (any_enclosed && k_fill > 0) {
    // both buffers equal off the enclosed cells, which alone change
    const unsigned* a = reinterpret_cast<const unsigned*>(src);
    unsigned* b = reinterpret_cast<unsigned*>(dst);
    for (int i = tid; i < kWin * kStride / 2; i += kThreads) b[i] = a[i];
    __syncthreads();
    fill_conv = false;
    for (int it = 0; it < k_fill; ++it) {
      bool ch = false;
      for (int y = warp; y < kWin; y += kWarps) {
        const u64 e = s.enclosed[y];
        if (!e) continue;
        int yy[1] = {y}, c0[1], c1[1], g0[1], g1[1];
        min3x3_rows(src, yy, lane, c0, c1, g0, g1);
        const int v0 = ((e >> i0) & 1) ? g0[0] : c0[0];
        const int v1 = ((e >> i1) & 1) ? g1[0] : c1[0];
        ch |= v0 != c0[0] || v1 != c1[0];
        dst[y * kStride + i0] = v0;
        dst[y * kStride + i1] = v1;
      }
      const bool any = __syncthreads_or(ch);
      uint16_t* t = src;
      src = dst;
      dst = t;
      if (!any) {
        fill_conv = true;
        break;
      }
    }
  }

  // ---- 4. the key ----
  int32_t* out = okey + (size_t)blockIdx.x * kPix;
#pragma unroll 8
  for (int j = 0; j < kPix / kThreads; ++j) {
    const int p = j * kThreads + tid, y = p >> 6, x = p & 63;
    const int owner = src[y * kStride + x];
    const int mk = (int)((s.masked[y] >> x) & 1);
    const int bd = (int)((s.boundary[y] >> x) & 1);
    if (kClosedBit) {
      const int cl = (int)((s.closed[y] >> x) & 1);
      out[p] = owner * 8 + cl * 4 + mk * 2 + bd;
    } else {
      out[p] = owner * 4 + mk * 2 + bd;
    }
  }
  if (tid == 0) converged[blockIdx.x] = lab_conv && out_conv && fill_conv;
}

}  // namespace

extern "C" int meterelf_ccl(const int32_t* bits, int K, int k_label,
                            int k_outside, int k_fill, int32_t* okey3,
                            uint8_t* converged, void* stream) {
  ccl_kernel<true><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      bits, k_label, k_outside, k_fill, okey3, converged);
  return (int)cudaGetLastError();
}

extern "C" int meterelf_propagate(const int32_t* bits, int K, int k_label,
                                  int k_outside, int k_fill, int32_t* okey,
                                  uint8_t* converged, void* stream) {
  ccl_kernel<false><<<K, kThreads, 0, (cudaStream_t)stream>>>(
      bits, k_label, k_outside, k_fill, okey, converged);
  return (int)cudaGetLastError();
}
