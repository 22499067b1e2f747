// K12 `readout`: the dial angle statistics and the 4-dial value.
//
// The TPU graph computes these with XLA ops, not with a Pallas kernel:
// meterelf_tpu/ops/angles.py read_dial_from_okey (quad fused branch) or
// read_dial (the other branches), then assemble_value. The port's plain
// version of that graph is ops/angles.py (read_dials, read_dials_region,
// _read_dial_core, assemble_value); on the card it took ~140 small
// launches a batch, so the host's launches, not the card, set the
// decode's pace. This kernel is the whole stage in one launch, bit-equal
// to that plain graph run on the card.
//
// One CTA an image, W = max(1, 16 / D) warps a dial window (4 at D = 4:
// 512 threads), so that each window's serial chain is spread over the
// dial's 32 W threads and a batch's CTAs stay one wave at two an SM; t
// is a thread's index in its dial. Per window, each step over the
// dial's threads, a CTA barrier between steps:
//   - gather: the needle bit at the static disk and annulus slots
//     (pa.disk_idx / pa.ann_idx, masked by disk_valid / ann_valid), from
//     okey3 and the stats key (kRegion = false: big blob, keymax >= 0 and
//     area2 > 200, means owner == keymax & 4095, else the closed bit) or
//     from the bool needle region (kRegion = true). Warp w of the dial
//     takes the 32-slot chunks w, w + W, ...: lane l slot 32c + l, a
//     group of chunks loaded before their ballots pack each into one word
//     in shared memory;
//   - momentum: sum sx2, sy2 over the needle slots in tree_sum's order
//     (ops/angles.py: zero-padded evenly on both sides to a multiple of
//     32, each run of 32 summed in index order from 0.0, again until 32 or
//     fewer partials are left, which are summed in order from 0.0). Thread
//     t sums runs t, t + 32 W, ..., its run's needle bits taken from two
//     words; a later level takes the partials from shared memory. Every
//     add is one IEEE add in that order, so the bits equal the plain
//     version's. A run adds its terms on the needle only, kGroup
//     loaded at a time: the plain graph adds 0.0 for the others, and a
//     run's sum, begun at +0.0, is never -0.0 (x + -x is +0.0), so a
//     zero added leaves it as it is;
//   - tip filter: the half-plane test dot > 0 (two rounded f64 products
//     and an add), the minimum angle of the kept slots (a warp min, then
//     the dial's warp minima) and the 0.75-turn tail test in the geometry
//     dtype T, each kept and tail bit a ballot word; n, k_tail and each
//     kept word's prefix count from a scan over the dial's threads (warp
//     scans, warp totals in shared memory), the inclusive rank of a kept
//     slot its run's count before it plus a masked popcount;
//   - trimmed weighted mean: sum rebased * w and w (f64) in tree_sum's
//     order, thread t again run t, mean = num / (den == 0 ? 1 : den),
//     position = torch's remainder(10 * (mean - zero_turn), 10) as its
//     CUDA kernel computes it (fmod, then + 10 where the result is
//     negative). A run adds its slots in the trim only: the plain graph
//     adds rebased * 0.0 for the others, a zero of either sign (the
//     angles are finite), which leaves the run's sum as it is;
// then, with the image's D positions in shared memory, one thread writes
// the carry-corrected value (D == 4; 0 otherwise).
//
// T is the geometry's dtype: double by default, float for
// MeterDecoder(exact=False); the minimum angle, the tail test, the
// rebasing by one turn and the trim weights are computed in T, as the
// plain version does, and every sum in double.
//
// What bounds it on the H100: its bytes, the gathered okey3 (4 bytes a
// slot, ~5 MB for the flagship's 1024 windows) and the geometry, which
// every CTA reads again from L2; but one warp a window left its
// dependent loads and adds as one chain per warp, ~30x the byte time.
// Spread over W warps, the chain is a few groups of gathers a warp, a
// run's needle (or trimmed) terms a thread, loaded together, and a few
// barriers.
#include <cuda_runtime.h>
#include <math.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64 * 64;        // pixels of a dial window
constexpr int kRun = 32;             // tree_sum's run
constexpr int kMaxSlots = kWin;      // slots a dial may have
constexpr int kMaxDials = 8;         // K2's limit too
constexpr int kCtaWarps = 16;        // W * D: two CTAs an SM at 64 registers
constexpr int kGroup = 4;            // chunks a lane, terms a thread, loaded
                                     // before they are balloted or added
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Geometry {
  const int32_t* disk_idx;   // [D, n_disk]
  const uint8_t* disk_valid;
  const T* disk_sx2;
  const T* disk_sy2;
  const int32_t* ann_idx;    // [D, n_ann]
  const uint8_t* ann_valid;
  const T* ann_x;
  const T* ann_y;
  const T* ann_angle;
  const T* ann_sqd;
  const int32_t* neg_sign;   // [D]
  const T* zero_turn;        // [D]
  int n_disk, n_ann;
  int perm[4];               // value_perm (D == 4)
};

__host__ __device__ constexpr int words_of(int n) { return (n + 31) >> 5; }

// warps a dial
__host__ __device__ constexpr int warps_of(int D) {
  return D >= kCtaWarps ? 1 : kCtaWarps / D;
}

// Per-dial shared memory: two f64 buffers of first-level partials and the
// W warp minima (8 bytes each), then the needle words, the kept and tail
// words, the kept words' prefix counts and the W warps' two counts. The
// CTA's D positions come first. Rounded up to 16 bytes, so that every
// dial's f64 buffers stay 8-aligned whatever the word counts.
__host__ __device__ inline int dial_bytes(int n_disk, int n_ann, int W) {
  const int runs = words_of(n_disk > n_ann ? n_disk : n_ann);
  const int bytes = 16 * runs + 16 * W +
                    4 * (words_of(n_disk) + 3 * words_of(n_ann));
  return (bytes + 15) & ~15;
}

__device__ __forceinline__ bool bit_at(const uint32_t* words, int s) {
  return (words[s >> 5] >> (s & 31)) & 1u;
}

// Bit j: slot s0 + j of the nw words (0 outside them), s0 >= -31.
__device__ __forceinline__ uint32_t run_bits(const uint32_t* words, int nw,
                                             int s0) {
  const int c = s0 >> 5, sh = s0 & 31;   // c == -1 below slot 0
  const uint32_t lo = c >= 0 ? words[c] : 0u;
  if (sh == 0) return lo;
  return __funnelshift_r(lo, c + 1 < nw ? words[c + 1] : 0u, sh);
}

// words[c] bit l = bit(32c + l) for the n slots, over the dial's W warps:
// warp w takes chunks w, w + W, ..., kGroup at a time, evaluated before
// they are balloted; a lane past the end evaluates slot n - 1 again and
// its bit is masked, so bit(s) may read unconditionally and a group's
// loads issue together.
template <class Bit>
__device__ __forceinline__ void ballot_words(int n, int w, int W, Bit bit,
                                             uint32_t* words) {
  const int lane = threadIdx.x & 31;
  const int nw = words_of(n);
  for (int c0 = w; c0 < nw; c0 += kGroup * W) {
    bool v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int s = (c0 + k * W) * 32 + lane;
      v[k] = bit(min(s, n - 1)) & (s < n);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const unsigned b = __ballot_sync(kFull, v[k]);
      if (lane == 0 && c0 + k * W < nw) words[c0 + k * W] = b;
    }
  }
}

// tree_sum's first level: run r (slots 32r - lo ..) starts at s0.
__device__ __forceinline__ int first_run(int n, int r) {
  return n <= kRun ? 0 : r * kRun - ((-n & (kRun - 1)) >> 1);
}

__device__ __forceinline__ int first_runs(int n) {
  return n <= kRun ? 1 : words_of(n);
}

// A first-level run of tree_sum from 0.0: the pairs term(s0 + j) of the
// bits j of m in index order, kGroup loaded before they are added.
template <class Term>
__device__ __forceinline__ double2 run_sum(uint32_t m, int s0, Term term) {
  double u = 0.0, v = 0.0;
  while (m) {
    double2 x[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      x[q] = m ? term(s0 + __ffs(m) - 1) : make_double2(0.0, 0.0);
      m &= m - 1;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      u = __dadd_rn(u, x[q].x);
      v = __dadd_rn(v, x[q].y);
    }
  }
  return make_double2(u, v);
}

// ops/angles.py tree_sum of two rows above its first level, whose
// partials the dial's threads left in bu, bv: every thread of the CTA
// calls it (CTA barriers) and every thread of the dial gets the two sums.
// n <= kMaxSlots leaves at most 128 partials, so one more level has at
// most 4 runs, one a thread.
__device__ __forceinline__ double2 upper_levels(int n, int t, double* bu,
                                                double* bv) {
  __syncthreads();                    // the first level's partials
  if (n <= kRun) return make_double2(bu[0], bv[0]);   // one run: the sum
  int m = words_of(n);
  if (m > kRun) {
    const int lo = (-m & (kRun - 1)) >> 1, runs = words_of(m);
    double u = 0.0, v = 0.0;
    if (t < runs) {
#pragma unroll 8
      for (int j = 0; j < kRun; ++j) {
        const int s = t * kRun + j - lo;
        const bool in = s >= 0 && s < m;
        u = __dadd_rn(u, in ? bu[s] : 0.0);
        v = __dadd_rn(v, in ? bv[s] : 0.0);
      }
    }
    __syncthreads();
    if (t < runs) {
      bu[t] = u;
      bv[t] = v;
    }
    __syncthreads();
    m = runs;
  }
  double u = 0.0, v = 0.0;
#pragma unroll 8
  for (int i = 0; i < m; ++i) {
    u = __dadd_rn(u, bu[i]);
    v = __dadd_rn(v, bv[i]);
  }
  return make_double2(u, v);
}

// assemble_value's digit: floor, carry up or down by the lower dial,
// modulo 10 (Python's, non-negative).
__device__ __forceinline__ int digit(double r, bool lower_le2,
                                     bool lower_ge8) {
  const double fl = floor(r);
  const double frac = __dsub_rn(r, fl);
  const long long x = (long long)fl + (frac > 0.55 && lower_le2) -
                      (frac < 0.45 && lower_ge8);
  return (int)(((x % 10) + 10) % 10);
}

template <typename T, bool kRegion>
__global__ void __launch_bounds__(kCtaWarps * 32, 2)
    readout_kernel(const void* __restrict__ src,
                   const int32_t* __restrict__ keymax, int D,
                   const Geometry<T> g, double* __restrict__ position,
                   uint8_t* __restrict__ readable,
                   double* __restrict__ value) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = warps_of(D), T32 = W * 32;
  const int d = threadIdx.x / T32, t = threadIdx.x - d * T32;
  const int lane = threadIdx.x & 31, w = t >> 5;
  const int win = blockIdx.x * D + d;
  double* pos_s = reinterpret_cast<double*>(smem);
  const int n_disk = g.n_disk, n_ann = g.n_ann;
  const int nwd = words_of(n_disk), na = words_of(n_ann);
  const int runs = words_of(n_disk > n_ann ? n_disk : n_ann);
  double* bu = reinterpret_cast<double*>(
      smem + 8 * D + d * dial_bytes(n_disk, n_ann, W));
  double* bv = bu + runs;
  T* wmin = reinterpret_cast<T*>(bv + runs);        // 8 bytes a warp
  uint32_t* nw = reinterpret_cast<uint32_t*>(bv + runs + W);
  uint32_t* kw = nw + nwd;
  uint32_t* tw = kw + na;
  int* pc = reinterpret_cast<int*>(tw + na);
  int* wcnt = pc + na;                               // 2 a warp

  // the needle bit at window pixel i
  const int32_t* ok = static_cast<const int32_t*>(src) + (size_t)win * kWin;
  const uint8_t* rg = static_cast<const uint8_t*>(src) + (size_t)win * kWin;
  const int km = kRegion ? -1 : keymax[win];
  const bool big = km >= 0 && (km >> 12) > 200;   // contourArea > 100
  const int sel = km & 4095;
  auto needle_at = [&](int i) -> bool {
    if constexpr (kRegion) {
      return rg[i] != 0;
    } else {
      const int v = ok[i];
      return big ? (v >> 3) == sel : (v & 4) != 0;
    }
  };

  // momentum over the needle's disk slots
  const int32_t* didx = g.disk_idx + (size_t)d * n_disk;
  const uint8_t* dval = g.disk_valid + (size_t)d * n_disk;
  const T* sx2 = g.disk_sx2 + (size_t)d * n_disk;
  const T* sy2 = g.disk_sy2 + (size_t)d * n_disk;
  ballot_words(n_disk, w, W, [&](int s) {
    return (dval[s] != 0) & needle_at(didx[s]);
  }, nw);
  __syncthreads();
  for (int r = t; r < first_runs(n_disk); r += T32) {
    const int s0 = first_run(n_disk, r);
    const double2 p = run_sum(run_bits(nw, nwd, s0), s0, [&](int s) {
      return make_double2((double)sx2[s], (double)sy2[s]);
    });
    bu[r] = p.x;
    bv[r] = p.y;
  }
  const double2 mom = upper_levels(n_disk, t, bu, bv);
  const double sign = (double)g.neg_sign[d];
  const double msx = __dmul_rn(sign, mom.x), msy = __dmul_rn(sign, mom.y);

  // the tip: annulus slots of the needle on the momentum's side
  const size_t ao = (size_t)d * n_ann;
  const int32_t* aidx = g.ann_idx + ao;
  const uint8_t* aval = g.ann_valid + ao;
  const T* ax = g.ann_x + ao;
  const T* ay = g.ann_y + ao;
  const T* ang = g.ann_angle + ao;
  const T* sqd = g.ann_sqd + ao;
  T amin = (T)INFINITY;
  ballot_words(n_ann, w, W, [&](int s) {
    const double dot = __dadd_rn(__dmul_rn((double)ax[s], msx),
                                 __dmul_rn((double)ay[s], msy));
    const bool kept = (aval[s] != 0) & needle_at(aidx[s]) & (dot > 0.0);
    const T a = ang[s];
    if (kept && a < amin) amin = a;
    return kept;
  }, kw);
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const T o = __shfl_xor_sync(kFull, amin, off);
    amin = o < amin ? o : amin;
  }
  if (lane == 0) wmin[w] = amin;
  __syncthreads();
  for (int i = 0; i < W; ++i) amin = wmin[i] < amin ? wmin[i] : amin;
  // kept slots more than 0.75 turn past the first: the wrap's tail (each
  // warp reads back the kept words it wrote)
  ballot_words(n_ann, w, W, [&](int s) {
    if (!bit_at(kw, s)) return false;
    T diff = ang[s] - amin;
    diff = diff < (T)0 ? -diff : diff;
    return !(diff < (T)0.75);
  }, tw);
  __syncthreads();
  // n, k_tail and each kept word's prefix count, T32 words at a time
  int n = 0, k_tail = 0;
  for (int c0 = 0; c0 < na; c0 += T32) {
    const int c = c0 + t;
    const int cnt = c < na ? __popc(kw[c]) : 0;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    const int tails = __reduce_add_sync(kFull, c < na ? __popc(tw[c]) : 0);
    if (lane == 31) {
      wcnt[2 * w] = incl;
      wcnt[2 * w + 1] = tails;
    }
    __syncthreads();
    int before = n;
    for (int i = 0; i < W; ++i) {
      before += i < w ? wcnt[2 * i] : 0;
      n += wcnt[2 * i];
      k_tail += wcnt[2 * i + 1];
    }
    if (c < na) pc[c] = before + incl - cnt;
    __syncthreads();
  }
  const int cut = n >= 5 ? min((n - 3) >> 1, 2) : 0;

  // the trimmed, weighted mean angle: the tail rebased by one turn, the
  // kept slots ranked in the rotated order, cut slots at each end
  for (int r = t; r < first_runs(n_ann); r += T32) {
    const int s0 = first_run(n_ann, r);
    const uint32_t tb = run_bits(tw, na, s0);
    // the kept slots' ranks from the count before s0: the trim
    const int c = s0 >> 5;
    int rank = s0 > 0 ? pc[c] + __popc(kw[c] & ((1u << (s0 & 31)) - 1u)) : 0;
    uint32_t trim = 0;
    for (uint32_t k = run_bits(kw, na, s0); k; k &= k - 1, ++rank) {
      const int j = __ffs(k) - 1;
      const int p = (tb >> j) & 1u ? rank - (n - k_tail) : rank + k_tail;
      if (p >= cut && p < n - cut) trim |= 1u << j;
    }
    const double2 p = run_sum(trim, s0, [&](int s) {
      const T a = ang[s];
      const T rebased = (tb >> (s - s0)) & 1u ? a - (T)1 : a;
      const double wt = (double)sqd[s];
      return make_double2(__dmul_rn((double)rebased, wt), wt);
    });
    bu[r] = p.x;
    bv[r] = p.y;
  }
  const double2 nd = upper_levels(n_ann, t, bu, bv);
  const double mean = __ddiv_rn(nd.x, nd.y == 0.0 ? 1.0 : nd.y);
  const double tt = __dmul_rn(10.0, __dsub_rn(mean, (double)g.zero_turn[d]));
  double r = fmod(tt, 10.0);            // torch.remainder on the card
  if (r < 0.0) r = __dadd_rn(r, 10.0);
  if (t == 0) {
    position[win] = r;
    readable[win] = n > 0;
    pos_s[d] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    if (D == 4) {
      // value_perm lists the dials name-sorted: r4, r3, r2, r1
      const double r4 = pos_s[g.perm[0]], r3 = pos_s[g.perm[1]];
      const double r2 = pos_s[g.perm[2]], r1 = pos_s[g.perm[3]];
      // d3's carry compares the raw r4; the coarser dials the digits
      const int d3 = digit(r3, r4 <= 2.0, r4 >= 8.0);
      const int d2 = digit(r2, d3 <= 2, d3 >= 8);
      const int d1 = digit(r1, d2 <= 2, d2 >= 8);
      v = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn((double)d1, 100.0),
                                        __dmul_rn((double)d2, 10.0)),
                              (double)d3),
                    __ddiv_rn(r4, 10.0));
    }
    value[blockIdx.x] = v;
  }
}

template <typename T, bool kRegion>
int launch(const void* src, const int32_t* keymax, int B, int D,
           const Geometry<T>& g, double* position, uint8_t* readable,
           double* value, cudaStream_t stream) {
  // at most ~4.4 KB a dial + 64 B: under the 48 KB a block may take
  // unasked
  const int W = warps_of(D);
  const int smem = 8 * D + D * dial_bytes(g.n_disk, g.n_ann, W);
  readout_kernel<T, kRegion><<<B, D * W * 32, smem, stream>>>(
      src, keymax, D, g, position, readable, value);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, int region, const int32_t* keymax, int B,
             int D, const int32_t* disk_idx, const uint8_t* disk_valid,
             const void* disk_sx2, const void* disk_sy2, int n_disk,
             const int32_t* ann_idx, const uint8_t* ann_valid,
             const void* ann_x, const void* ann_y, const void* ann_angle,
             const void* ann_sqd, int n_ann, const int32_t* neg_sign,
             const void* zero_turn, int p0, int p1, int p2, int p3,
             double* position, uint8_t* readable, double* value,
             cudaStream_t stream) {
  const Geometry<T> g{disk_idx, disk_valid,
                      static_cast<const T*>(disk_sx2),
                      static_cast<const T*>(disk_sy2), ann_idx, ann_valid,
                      static_cast<const T*>(ann_x),
                      static_cast<const T*>(ann_y),
                      static_cast<const T*>(ann_angle),
                      static_cast<const T*>(ann_sqd), neg_sign,
                      static_cast<const T*>(zero_turn), n_disk, n_ann,
                      {p0, p1, p2, p3}};
  return region ? launch<T, true>(src, keymax, B, D, g, position, readable,
                                  value, stream)
                : launch<T, false>(src, keymax, B, D, g, position, readable,
                                   value, stream);
}

}  // namespace

extern "C" int meterelf_readout(
    const void* src, int region, const int32_t* keymax, int B, int D,
    const int32_t* disk_idx, const uint8_t* disk_valid, const void* disk_sx2,
    const void* disk_sy2, int n_disk, const int32_t* ann_idx,
    const uint8_t* ann_valid, const void* ann_x, const void* ann_y,
    const void* ann_angle, const void* ann_sqd, int n_ann,
    const int32_t* neg_sign, const void* zero_turn, int geom_f32, int p0,
    int p1, int p2, int p3, double* position, uint8_t* readable,
    double* value, void* stream) {
  if (D < 1 || D > kMaxDials || n_disk < 1 || n_disk > kMaxSlots ||
      n_ann < 1 || n_ann > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = (cudaStream_t)stream;
  return geom_f32
             ? dispatch<float>(src, region, keymax, B, D, disk_idx,
                               disk_valid, disk_sx2, disk_sy2, n_disk,
                               ann_idx, ann_valid, ann_x, ann_y, ann_angle,
                               ann_sqd, n_ann, neg_sign, zero_turn, p0, p1,
                               p2, p3, position, readable, value, s)
             : dispatch<double>(src, region, keymax, B, D, disk_idx,
                                disk_valid, disk_sx2, disk_sy2, n_disk,
                                ann_idx, ann_valid, ann_x, ann_y, ann_angle,
                                ann_sqd, n_ann, neg_sign, zero_turn, p0, p1,
                                p2, p3, position, readable, value, s);
}
