// K1's exact int8 template correlation on Hopper's warpgroup product,
// wgmma.mma_async.m64nNk32.s32.s8.s8 (frontend.cu; K5, K8 and K9 still
// run corr_mma.cuh's mma.sync loop).
//
// With L' = L - 128 and T' = T - 128 both int8, per image
//     corr8[y, x] = sum_{r, c} L'[y + r, x + c] T'[r, c]   (exact in i32:
//                   |corr8| <= th * tw * 128^2 < 2^31)
//     box'[y, x]  = sum_{r, c} L'[y + r, x + c]
// For each template row r, corr8 is a product of a band built from T'
// row r with the L' rows r .. r + oh - 1:
//     corr8[y, x] = sum_r sum_k A_r[x, k] B_r[k, y],
//     A_r[x, k] = T'[r, k - x] (zero outside 0 <= k - x < tw),
//     B_r[k, y] = L'[y + r, k].
// M = x: an x tile of 64 rows is one warpgroup product (ow <= 128: one or
// two tiles). N = y: oh rounded up to 16, as products of 128, 64, 32 and
// 16 columns (the s8 shapes step by 16). K = image columns: an x tile at
// x0 runs the nj = ceil((63 + tw) / 32) k32 steps from x0 that hold its
// band, less those past the last image column. Every product is exact
// and every partial sum is below 2^31, so any order of sums is bit for
// bit the plain version's.
//
// A comes from registers. Warp q of a warpgroup holds rows 16 q .. 16 q
// + 15 of the band, A_r[x0 + 16 q + m, x0 + 32 j + kk] = T'[r, 32 j + kk
// - 16 q - m], which is the same for every x tile: each of its 4
// registers is two aligned 32-bit shared loads and one byte permute from
// the staged template row. Template rows are staged at a stride of ts >=
// tw + max(64, ow - 1) bytes with zeros between them and 64 zero bytes
// before row 0, so the band's edges read zeros wherever they meet an
// image column (k - x < 0, or tw <= k - x <= W - 1 - x); past that the
// band may read the next row, against staged zero columns.
//
// B is read by the tensor cores straight from shared memory. L' is staged
// in 16-byte column chunks, byte (s, k) at (k / 16) ch + 16 s + k % 16,
// so that every no-swizzle core matrix (8 rows of 16 bytes) is 128
// contiguous bytes for any row shift: B_r is a K-major descriptor that
// starts 16 r bytes into chunk x0 / 16 + 2 j, with SBO = 128 (the next 8
// rows) and LBO = ch (the next 16 bytes of k); checked on the card by
// experiments/torch_wgmma_probe.py. ch = 16 mod 128 keeps the staging
// stores free of bank conflicts. Rows past H are not staged: only y
// columns past oh read them. Columns W .. 32 ceil(W / 32) - 1 are staged
// as zeros.
//
// Two warpgroups: with one x tile each sums half of the template rows and
// the halves are added in shared memory; with two x tiles each takes one.
// A warpgroup double-buffers its A registers, so one product is in flight
// while the next band is built (wgmma.wait_group 1). After the products,
// L' gives box' (row windows of each staged row by a warp scan into
// region B, then column windows into region A, where L' was), corr8 goes
// to region B, and every thread runs epi(y, x, corr8, box') on its share
// of the offsets.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace corrwg {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHW = 256;     // crop rows and columns: one row a warp
constexpr int kMaxOw = 128;     // two 64-row x tiles
constexpr int kMaxOh = 208;     // the gate's largest oh, 193, rounded up
constexpr int kTMargin = 64;    // zero bytes before template row 0
constexpr int kScanWords = 264; // a warp's row prefix: words 3 .. 259

// Dynamic shared memory, two regions. A: L' during the products, then
// box' [ow, ds] i32. B: T' during the products, then the row-window sums
// Rw [H, ow] i16 and the warps' prefix rows, then corr8 [64 nm, ds] i32.
struct Layout {
  int H, W, oh, ow;
  int nm;        // 64-row x tiles
  int n;         // y columns of a product: oh rounded up to 16
  int nj;        // k32 steps of a whole x tile
  int kc;        // staged 16-byte column chunks: 2 ceil(W / 32)
  int ch;        // bytes a chunk: >= 16 H, = 16 mod 128
  int ts;        // bytes a staged template row
  int t_bytes;   // the staged template
  int ds;        // words a row of box' and of corr8: n + 8
  int off_b;     // byte offset of region B
  int off_scan;  // byte offset of the prefix rows within region B
  int bytes;     // the whole, or -1 where the geometry is not taken
};

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout layout(int H, int W, int th, int tw) {
  Layout g;
  g.H = H;
  g.W = W;
  g.oh = H - th + 1;
  g.ow = W - tw + 1;
  g.nm = (g.ow + 63) / 64;
  g.n = round_up(g.oh, 16);
  g.nj = (63 + tw + 31) / 32;
  g.kc = 2 * ((W + 31) / 32);
  g.ch = round_up(16 * H - 16, 128) + 16;
  g.ts = round_up(tw + imax(64, g.ow - 1), 16);
  // the last template row's band reads end 32 nj + 68 bytes past its start
  g.t_bytes = round_up(
      imax(kTMargin + th * g.ts, (th - 1) * g.ts + 32 * g.nj + 68), 16);
  g.ds = g.n + 8;
  // the last chunk's descriptor reads rows up to th - 2 + n
  const int l_bytes = (g.kc - 1) * g.ch + 16 * (th - 1 + g.n);
  g.off_b = round_up(imax(l_bytes, 4 * g.ow * g.ds), 128);
  g.off_scan = round_up(2 * H * g.ow, 16);
  const int rw_bytes = g.off_scan + 4 * kWarps * kScanWords;
  const int x_bytes = 4 * 64 * g.nm * g.ds;
  g.bytes = g.off_b + imax(g.t_bytes, imax(rw_bytes, x_bytes));
  if (g.oh < 1 || g.oh > kMaxOh || g.ow < 1 || g.ow > kMaxOw ||
      H > kMaxHW || W > kMaxHW)
    g.bytes = -1;
  return g;
}

// ---- the warpgroup product ----

__device__ __forceinline__ void mma_n16(int* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void mma_n32(int* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void mma_n64(int* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void mma_n128(int* d, const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// d[0 .. 4 NB) += A B over 8 NB columns (NB even), as products of 128,
// 64, 32 and 16 columns; column block i (8 columns) starts 128 i bytes
// further into the chunk, 8 i in the descriptor's address field
template <int NB, int B0 = 0>
__device__ __forceinline__ void product(int* d, const uint32_t* a,
                                        uint64_t b) {
  constexpr int left = NB - B0;
  const uint64_t at = b + 8 * B0;
  if constexpr (left >= 16) {
    mma_n128(d + 4 * B0, a, at);
    product<NB, B0 + 16>(d, a, b);
  } else if constexpr (left >= 8) {
    mma_n64(d + 4 * B0, a, at);
    product<NB, B0 + 8>(d, a, b);
  } else if constexpr (left >= 4) {
    mma_n32(d + 4 * B0, a, at);
    product<NB, B0 + 4>(d, a, b);
  } else if constexpr (left >= 2) {
    mma_n16(d + 4 * B0, a, at);
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// K-major, no swizzle: start address, LBO = lbo, SBO = 128 (16-byte units)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)(addr >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// ---- staging ----

// 8 consecutive pixels, 16- or 8-byte loads where aligned; n < 8 reads n
__device__ __forceinline__ void load8(const int32_t* __restrict__ p, int n,
                                      int v[8]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == 8 && (a & 15) == 0) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(p));
    const int4 w = __ldg(reinterpret_cast<const int4*>(p) + 1);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    v[4] = w.x, v[5] = w.y, v[6] = w.z, v[7] = w.w;
  } else if (n == 8 && (a & 7) == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 u = __ldg(reinterpret_cast<const int2*>(p) + e);
      v[2 * e] = u.x, v[2 * e + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? __ldg(p + e) : 0;
  }
}

// L' = lp(pixel) in [-128, 127] of the image [H, W] into the column
// chunks of region A: lane l of a warp takes columns 8 l .. 8 l + 7 of a
// row (zeros from W on), 4 rows a warp in flight; and T' = T - 128 with
// its zero margins into region B. Ends with the async-proxy fence and a
// barrier, so that the tensor cores see both. One copy for every N: not
// inlined.
template <class Lp>
__device__ __noinline__ void stage(unsigned char* smem, const Layout g,
                                   const int32_t* __restrict__ img,
                                   const uint8_t* __restrict__ tmpl, int th,
                                   int tw, Lp lp) {
  constexpr int kRows = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = 8 * lane;
  const int nv = min(max(g.W - k0, 0), 8);
  if (k0 < 16 * g.kc) {
    unsigned char* dst = smem + (lane >> 1) * g.ch + 8 * (lane & 1);
    for (int s0 = warp; s0 < g.H; s0 += kRows * kWarps) {
      int v[kRows][8];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int s = s0 + q * kWarps;
        if (s < g.H) load8(img + (size_t)s * g.W + k0, nv, v[q]);
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int s = s0 + q * kWarps;
        if (s >= g.H) break;
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < nv)
            w[e >> 2] |= (uint32_t)(lp(v[q][e]) & 255) << (8 * (e & 3));
        *reinterpret_cast<uint2*>(dst + 16 * s) = make_uint2(w[0], w[1]);
      }
    }
  }
  uint32_t* sT = reinterpret_cast<uint32_t*>(smem + g.off_b);
  for (int q = threadIdx.x; q < g.t_bytes / 4; q += kThreads) {
    const int b = 4 * q - kTMargin;
    const int r = b >= 0 ? b / g.ts : th, c = b - r * g.ts;
    uint32_t w = 0u;
    if (r < th) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < tw)
          w |= (uint32_t)(tmpl[r * tw + c + e] ^ 0x80u) << (8 * e);
    }
    sT[q] = w;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- the three phases after staging ----

// One warpgroup's corr8 of x tile `tile` over template rows [r0, r1), in
// its accumulators: fragment register 4 i + e of lane (gq, tq) in warp q
// holds x = 64 tile + 16 q + gq + 8 (e / 2), y = 8 i + 2 tq + e % 2.
template <int NB>
__device__ __forceinline__ void warpgroup_sums(int (&acc)[4 * NB],
                                               const unsigned char* smem,
                                               const Layout& g, int tile,
                                               int r0, int r1) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) acc[i] = 0;
  const int x0 = 64 * tile;
  const int nj = min(g.nj, (g.W - x0 + 31) / 32);
  const int steps = (r1 - r0) * nj;  // the same in the whole warpgroup
  if (steps <= 0) return;
  // Band registers a[1], a[0], a[3], a[2] hold the 4 template bytes from
  // 32 j + 4 tq - 16 q - gq - 8, -0, +8 and +16: from staged byte
  // kTMargin + that of row r on, 8 consecutive aligned words, all four
  // with the byte shift (-gq) & 3.
  const uint32_t* tbase = reinterpret_cast<const uint32_t*>(smem + g.off_b) +
                         ((kTMargin - 8 - 16 * q + 4 * tq - gq) >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)((-gq) & 3);
  const int tsw = g.ts / 4;
  const uint64_t d0 =
      b_desc((uint32_t)__cvta_generic_to_shared(smem) + (x0 / 16) * g.ch,
             g.ch);
  auto build = [&](uint32_t* a, int r, int j) {
    const uint32_t* w = tbase + r * tsw + 8 * j;
    a[1] = __byte_perm(w[0], w[1], sel);
    a[0] = __byte_perm(w[2], w[3], sel);
    a[3] = __byte_perm(w[4], w[5], sel);
    a[2] = __byte_perm(w[6], w[7], sel);
  };
  auto issue = [&](const uint32_t* a, int r, int j) {
    wg_fence();
    product<NB>(acc, a, d0 + ((2 * j * g.ch + 16 * r) >> 4));
    wg_commit();
  };
  // (r, j) of the next step to build; a step's A stays untouched until
  // the wait after the next step's issue has seen it through
  int r = r0, j = 0;
  auto next = [&]() {
    if (++j == nj) {
      j = 0;
      ++r;
    }
  };
  uint32_t a0[4], a1[4];
  build(a0, r, j);
  for (int s = 0;;) {
    issue(a0, r, j);
    next();
    if (++s == steps) break;
    wg_wait<1>();
    build(a1, r, j);
    issue(a1, r, j);
    next();
    if (++s == steps) break;
    wg_wait<1>();
    build(a0, r, j);
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// box' [x][y] (row stride ds) into region A from the staged L', through
// Rw [s][x] = sum_{c < tw} L'[s, x + c] (i16: |Rw| <= 128 tw <= 2^15) in
// region B. Starts and ends with a barrier.
__device__ inline void box_sums(unsigned char* smem, const Layout& g, int th,
                                int tw) {
  __syncthreads();  // every product has read L' and T'
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int16_t* rw = reinterpret_cast<int16_t*>(smem + g.off_b);
  // Pk[j] = sum_{k < j} L'[s, k] at word j + 3 of the warp's row
  int* pk = reinterpret_cast<int*>(smem + g.off_b + g.off_scan) +
            warp * kScanWords;
  const bool live = 8 * lane < 16 * g.kc;
  const unsigned char* src = smem + (lane >> 1) * g.ch + 8 * (lane & 1);
  for (int s = warp; s < g.H; s += kWarps) {
    const uint2 v = live ? *reinterpret_cast<const uint2*>(src + 16 * s)
                         : make_uint2(0u, 0u);
    int p[8], run = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run += (int)(int8_t)((e < 4 ? v.x : v.y) >> (8 * (e & 3)));
      p[e] = run;
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const int ex = incl - run;
    int4* out = reinterpret_cast<int4*>(pk + 8 * lane + 4);
    out[0] = make_int4(ex + p[0], ex + p[1], ex + p[2], ex + p[3]);
    out[1] = make_int4(ex + p[4], ex + p[5], ex + p[6], ex + p[7]);
    if (lane == 0) pk[3] = 0;
    __syncwarp();
    for (int x = lane; x < g.ow; x += 32)
      rw[s * g.ow + x] = (int16_t)(pk[x + tw + 3] - pk[x + 3]);
    __syncwarp();
  }
  __syncthreads();
  // thread (x, part) slides a window of th rows down part of column x
  int* box = reinterpret_cast<int*>(smem);
  const int parts = kThreads / g.ow;
  const int rows = (g.oh + parts - 1) / parts;
  const int t = threadIdx.x;
  if (t < parts * g.ow) {
    const int x = t % g.ow, y0 = t / g.ow * rows;
    const int y1 = min(g.oh, y0 + rows);
    if (y0 < y1) {
      int sum = 0;
#pragma unroll 4
      for (int r = 0; r < th; ++r) sum += rw[(y0 + r) * g.ow + x];
      box[x * g.ds + y0] = sum;
      for (int y = y0 + 1; y < y1; ++y) {
        sum += rw[(y + th - 1) * g.ow + x] - rw[(y - 1) * g.ow + x];
        box[x * g.ds + y] = sum;
      }
    }
  }
  __syncthreads();
}

// A warpgroup's accumulators into xs [x][ds] (x from the tile's first
// row), stored, or added to what the other warpgroup stored
template <int NB, bool kAdd>
__device__ __forceinline__ void put(const int (&acc)[4 * NB], int* xs,
                                    const Layout& g) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
  int* row = xs + (16 * q + (lane >> 2)) * g.ds + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows gq and gq + 8
      int2* at = reinterpret_cast<int2*>(row + 8 * h * g.ds + 8 * i);
      int2 v = make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      if constexpr (kAdd) {
        const int2 o = *at;
        v.x += o.x;
        v.y += o.y;
      }
      *at = v;
    }
  }
}

// The block's corr8 and box' after stage(): epi(y, x, corr8, box') once
// for every valid offset (y < oh, x < ow), the offsets dealt to all
// threads.
template <int NB, class Epi>
__device__ __forceinline__ void correlate(unsigned char* smem,
                                          const Layout& g, int th, int tw,
                                          Epi&& epi) {
  const int wg = threadIdx.x >> 7;
  const int half = (th + 1) / 2;
  int acc[4 * NB];
  if (g.nm == 1)
    warpgroup_sums<NB>(acc, smem, g, 0, wg ? half : 0, wg ? th : half);
  else
    warpgroup_sums<NB>(acc, smem, g, wg, 0, th);
  box_sums(smem, g, th, tw);
  // corr8 [x][ds] into region B: one x tile, warpgroup 0's half of the
  // template rows, then warpgroup 1's added; two, each its own tile
  int* xs = reinterpret_cast<int*>(smem + g.off_b);
  if (g.nm == 1) {
    if (wg == 0) put<NB, false>(acc, xs, g);
    __syncthreads();
    if (wg == 1) put<NB, true>(acc, xs, g);
  } else {
    put<NB, false>(acc, xs + 64 * wg * g.ds, g);
  }
  __syncthreads();
  const int* box = reinterpret_cast<const int*>(smem);
  for (int i = threadIdx.x; i < g.oh * g.ow; i += kThreads) {
    const int x = i / g.oh, y = i - x * g.oh;
    epi(y, x, xs[x * g.ds + y], box[x * g.ds + y]);
  }
}

}  // namespace corrwg
