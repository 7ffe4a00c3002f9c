// Sampling helpers shared by K2 `bands` (bands.cu) and K6 `draws`
// (draws.cu): the counter-based variates, one step of a sampled trend
// path, and the selection of two order statistics of a column of S values
// by one warp.
//
// Variates: a Philox4x32-10 counter keyed on the caller's seed with
// counter (step, sample, row, stream) gives the Bernoulli uniform, the
// Laplace uniform and the two Box-Muller uniforms of one draw, so a draw
// depends on its coordinates only (K2 draws on stream 0, K6 on stream 1).
//
// Selection.  A column's values are mapped to order-preserving uint32
// keys (every NaN to the largest); one warp finds the four order
// statistics floor/ceil(q * (S - 1)) of both q.  From the keys' range
// [lo, hi] (their min and max) it returns at once if the column holds a
// NaN (both quantiles NaN, as jnp.quantile gives) or the range is one key
// (a column of ties, as the trend is before any simulated changepoint);
// otherwise it counts the keys into 256 bins of width 2^shift over
// [lo, hi] (shared-memory atomics, the lanes that fall in lane 0's bin
// added as one), turns the counts into running counts, and the bins
// holding a pair of ranks give its next range.  A range of at most 32
// keys is gathered one key a lane and ranked exactly among itself.  Each
// pass over the column is O(S) and cuts the range 128-fold or more, so a
// column takes one or two histograms and one gather.  The statistics are
// the column's own values, so the quantiles are the same bits a sort
// gives.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "prophet_model.cuh"

namespace tsspark {
namespace sampling {

// float(1 + 1e-6): predict.py's clamp of a step's changepoint position.
constexpr float kClampT = 1.00000095367431640625f;
constexpr unsigned kFull = 0xffffffffu;

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(Philox4 c, uint32_t k0,
                                                 uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = Philox4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// [0, 1) with 24 random bits.
__device__ __forceinline__ float u01(uint32_t x) {
  return static_cast<float>(x >> 8) * 5.9604644775390625e-08f;
}

// (0, 1), never 0 or 1: (k + 0.5) / 2^23.
__device__ __forceinline__ float u01_open(uint32_t x) {
  return (static_cast<float>(x >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

// Order-preserving key of a float: a < b as floats <=> key(a) < key(b);
// every NaN maps to the largest key, after +inf.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The variates of one draw: U(0, 1) for the changepoint Bernoulli, a
// standard Laplace and a standard normal.
struct Variates {
  float u, lap, z;
};

__device__ __forceinline__ Variates philox_variates(uint32_t step,
                                                    uint32_t sample,
                                                    uint32_t row,
                                                    uint32_t stream,
                                                    uint32_t k0,
                                                    uint32_t k1) {
  const Philox4 rn = philox4x32_10(Philox4{step, sample, row, stream}, k0, k1);
  Variates v;
  v.u = u01(rn.x);
  const float h = u01_open(rn.y) - 0.5f;
  v.lap = h < 0.0f ? log1pf(2.0f * h) : -log1pf(-2.0f * h);
  v.z = sqrtf(-2.0f * logf(u01_open(rn.z))) * cospif(2.0f * u01(rn.w));
  return v;
}

// One step of a sampled trend path (predict._simulate_trends): at time ti
// a changepoint is drawn with probability cp where ti > 1, its rate change
// lap * lam.  Linear growth: c and d are the running sums of the changes
// and of change * t, the path det + t c - d (det: the step's
// deterministic trend).  Logistic growth (kLogi, its own instantiation, so
// the linear and flat code keeps its registers): c and d are the offset
// recursion's running sums of deltas and gammas (starting after the
// history's changepoints), the step's changepoint at max(ti, kClampT)
// taken by logistic_step, and a step with ti >= that position reads
// cap * sigmoid((k + c) (ti - (m + d))) (*capp: the step's capacity),
// an earlier one det.  Flat growth: det.
template <bool kLogi>
__device__ __forceinline__ float path_step(int growth, float ti,
                                           const float* capp, float det,
                                           float u, float lap, float cp,
                                           float lam, float k, float m,
                                           float& c, float& d) {
  float tr = det;
  if constexpr (kLogi) {
    const float fut = ti > 1.0f ? 1.0f : 0.0f;
    const float ind = (u < cp ? 1.0f : 0.0f) * fut;
    const float nd = ind * (lap * lam);
    const float tcl = fmaxf(ti, kClampT);
    float k_prev = __fadd_rn(k, c);
    logistic_step(k, m, tcl, nd, c, k_prev, d);
    if (ti >= tcl)
      tr = *capp *
           sigmoid(__fmul_rn(k_prev, __fsub_rn(ti, __fadd_rn(m, d))));
  } else if (growth == kLinear) {
    const float fut = ti > 1.0f ? 1.0f : 0.0f;
    const float ind = (u < cp ? 1.0f : 0.0f) * fut;
    const float nd = ind * (lap * lam);
    c = c + nd;
    d = d + nd * ti;
    tr = tr + ti * c - d;
  }
  return tr;
}

// ---- selection by one warp ------------------------------------------------
// (Groups of 8 or 16 lanes a column, several columns a warp, measured
// slower on the card than a warp a column: a warp's groups part ways in
// the data-dependent passes and run one after the other.)

// Bins of one histogram pass, 8 a lane, and lanes (one key each) that
// rank a range exactly.
constexpr int kBins = 256;
constexpr int kBinBits = 8;
constexpr int kCand = 32;

// Ranks il <= ih (ih = il or il + 1) of one quantile, and the range of
// keys [lo, hi] known to hold them, with `base` keys below lo and `cnt` in
// it.  Done: the keys at both ranks are k1 and k2.
struct Pair {
  int il, ih, base, cnt;
  uint32_t lo, hi, k1, k2;
  bool done;
};

// Turn the warp's bin counts into running counts (through each bin), in
// place: 8 bins a lane, the lanes' totals scanned by shuffles.
__device__ __forceinline__ void scan_bins(int* hist, int lane) {
  int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
  int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  a.y += a.x;
  a.z += a.y;
  a.w += a.z;
  b.x += a.w;
  b.y += b.x;
  b.z += b.y;
  b.w += b.z;
  const int tot = b.w;
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  const int e = incl - tot;
  reinterpret_cast<int4*>(hist)[2 * lane] =
      make_int4(a.x + e, a.y + e, a.z + e, a.w + e);
  reinterpret_cast<int4*>(hist)[2 * lane + 1] =
      make_int4(b.x + e, b.y + e, b.z + e, b.w + e);
  __syncwarp();
}

// The bin holding rank r (0-based among the binned keys), with the keys
// in the bins before it and through it, from the running counts: the
// first lane whose 8 bins pass r, then the first of its bins that does.
struct Bin {
  int bin, below, through;
};

__device__ __forceinline__ Bin find_bin(const int* cum, int r, int lane) {
  const int lane_bin = __ffs(__ballot_sync(kFull, cum[8 * lane + 7] > r)) - 1;
  const int c = cum[8 * lane_bin + (lane & 7)];
  const int j = __ffs(__ballot_sync(kFull, lane < 8 && c > r)) - 1;
  Bin out;
  out.bin = 8 * lane_bin + j;
  out.through = __shfl_sync(kFull, c, j);
  out.below = out.bin > 0 ? cum[out.bin - 1] : 0;
  return out;
}

// Min and max key of the column within [lo, hi].
__device__ __forceinline__ void range_minmax(const uint32_t* col, int S,
                                             uint32_t lo, uint32_t hi,
                                             int lane, uint32_t& mn,
                                             uint32_t& mx) {
  const uint32_t span = hi - lo;
  uint32_t a = 0xffffffffu, b = 0u;
  for (int s = lane; s < S; s += 32) {
    const uint32_t k = col[s];
    if (k - lo <= span) {
      a = ::min(a, k);
      b = ::max(b, k);
    }
  }
  mn = __reduce_min_sync(kFull, a);
  mx = __reduce_max_sync(kFull, b);
}

// Counts of the keys in [lo, lo + span] over bins of width 2^shift, four
// keys a lane in flight.
__device__ __forceinline__ void histogram(const uint32_t* col, int S,
                                          uint32_t lo, uint32_t span,
                                          int shift, int* hist,
                                          int lane) {
  __syncwarp();  // every lane is done reading the last pass's running counts
  reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += 128) {
    uint32_t k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = s0 + 32 * u + lane;
      k[u] = s < S ? col[s] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t off = k[u] - lo;
      const bool in = s0 + 32 * u + lane < S && off <= span;
      const int bin = static_cast<int>(off >> shift);
      // Ties fall in one bin: the lanes that share lane 0's add as one.
      const int bin0 = __shfl_sync(kFull, bin, 0);
      const unsigned same = __ballot_sync(kFull, in && bin == bin0);
      if (in && bin == bin0) {
        if (lane == __ffs(same) - 1) atomicAdd(&hist[bin0], __popc(same));
      } else if (in) {
        atomicAdd(&hist[bin], 1);
      }
    }
  }
  __syncwarp();
}

// The largest key in [lo_a, hi_a] and the smallest in [lo_b, hi_b].
__device__ __forceinline__ void bin_edges(const uint32_t* col, int S,
                                          uint32_t lo_a, uint32_t hi_a,
                                          uint32_t lo_b, uint32_t hi_b,
                                          int lane, uint32_t& max_a,
                                          uint32_t& min_b) {
  uint32_t a = 0u, b = 0xffffffffu;
  for (int s = lane; s < S; s += 32) {
    const uint32_t k = col[s];
    if (k - lo_a <= hi_a - lo_a) a = ::max(a, k);
    if (k - lo_b <= hi_b - lo_b) b = ::min(b, k);
  }
  max_a = __reduce_max_sync(kFull, a);
  min_b = __reduce_min_sync(kFull, b);
}

// Last key of a bin of width 2^shift from lo, within hi.
__device__ __forceinline__ uint32_t bin_top(uint32_t lo, int bin, int shift,
                                            uint32_t hi) {
  const unsigned long long top = static_cast<unsigned long long>(lo) +
                                 (static_cast<unsigned long long>(bin + 1)
                                  << shift) - 1ull;
  return top < hi ? static_cast<uint32_t>(top) : hi;
}

// Narrow a pair's range [lo, hi] to the bins that hold its ranks, from one
// histogram over it at width 2^shift.  Bins of one key decide the pair.
// Ranks il and ih = il + 1 in two bins are the last key of the first and
// the first key of the second: one pass finds them where the bins between
// hold too many keys to gather.
__device__ __forceinline__ void narrow(Pair& p, const int* cum,
                                       const uint32_t* col, int S, int shift,
                                       int lane) {
  const Bin b1 = find_bin(cum, p.il - p.base, lane);
  const Bin b2 =
      p.ih - p.base < b1.through ? b1 : find_bin(cum, p.ih - p.base, lane);
  const uint32_t lo1 = p.lo + (static_cast<uint32_t>(b1.bin) << shift);
  const uint32_t lo2 = p.lo + (static_cast<uint32_t>(b2.bin) << shift);
  if (shift == 0) {
    p.k1 = lo1;
    p.k2 = lo2;
    p.done = true;
    return;
  }
  const int cnt = b2.through - b1.below;
  if (b1.bin != b2.bin && cnt > kCand) {
    bin_edges(col, S, lo1, bin_top(p.lo, b1.bin, shift, p.hi), lo2,
              bin_top(p.lo, b2.bin, shift, p.hi), lane, p.k1, p.k2);
    p.done = true;
    return;
  }
  p.hi = bin_top(p.lo, b2.bin, shift, p.hi);
  p.lo = lo1;
  p.base += b1.below;
  p.cnt = cnt;
}

// Tighten a pair's range to its keys' min and max; a range of one key
// decides the pair.
__device__ __forceinline__ void tighten(Pair& p, uint32_t mn, uint32_t mx) {
  p.lo = mn;
  p.hi = mx;
  if (mn == mx) {
    p.k1 = p.k2 = mn;
    p.done = true;
  }
}

// The keys of ranks il and ih among the n <= 32 keys cand[0..n), one a
// lane, ranked by counting (ties by index).
__device__ __forceinline__ void resolve(Pair& p, const uint32_t* cand, int n,
                                        int lane) {
  const uint32_t mine = lane < n ? cand[lane] : 0xffffffffu;
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    const uint32_t o = __shfl_sync(kFull, mine, j);
    rank += (o < mine || (o == mine && j < lane)) ? 1 : 0;
  }
  const bool live = lane < n;
  const int at1 = __ffs(__ballot_sync(kFull, live && rank == p.il - p.base));
  const int at2 = __ffs(__ballot_sync(kFull, live && rank == p.ih - p.base));
  p.k1 = __shfl_sync(kFull, mine, at1 - 1);
  p.k2 = __shfl_sync(kFull, mine, at2 - 1);
  p.done = true;
}

// jnp.quantile's "linear" rule for q over S values: position q * (S - 1)
// in float32, its floor and ceil ranks and their weights.
struct Rule {
  int il, ih;
  float lw, hw;
};

__device__ __forceinline__ Rule quantile_rule(float q, int S) {
  const float pos = q * static_cast<float>(S - 1);
  const float lo = floorf(pos);
  Rule r;
  r.il = min(max(static_cast<int>(lo), 0), S - 1);
  r.ih = min(max(static_cast<int>(ceilf(pos)), 0), S - 1);
  r.hw = pos - lo;
  r.lw = 1.0f - r.hw;
  return r;
}

__device__ __forceinline__ Pair make_pair(const Rule& r, int S) {
  Pair p;
  p.il = r.il;
  p.ih = r.ih;
  p.base = 0;
  p.cnt = S;
  p.lo = 0u;
  p.hi = 0xffffffffu;
  p.done = false;
  return p;
}

__device__ __forceinline__ float interpolate(const Pair& p, const Rule& r) {
  return __fadd_rn(__fmul_rn(key_value(p.k1), r.lw),
                   __fmul_rn(key_value(p.k2), r.hw));
}

// The lower and upper quantiles of the S keys at col (shared or device
// memory), whose least and largest are mn and mx, found by one warp.
// hist: the warp's 256 bins; cand: its 2 x 32 candidate slots.  Uniform
// over the warp throughout.
__device__ __forceinline__ void select_column(
    const uint32_t* col, int S, uint32_t mn, uint32_t mx, const Rule& r_lo,
    const Rule& r_hi, int* hist, uint32_t* cand, int lane,
    float& out_lo, float& out_hi) {
  Pair p[2] = {make_pair(r_lo, S), make_pair(r_hi, S)};
  if (mx == 0xffffffffu) {  // a NaN: jnp.quantile's answer is NaN
    out_lo = out_hi = __uint_as_float(0x7fffffffu);
    return;
  }
  tighten(p[0], mn, mx);
  tighten(p[1], mn, mx);
  while (true) {
    const bool open0 = !p[0].done && p[0].cnt > kCand;
    const bool open1 = !p[1].done && p[1].cnt > kCand;
    if (!open0 && !open1) break;
    const uint32_t lo = open0 ? p[0].lo : p[1].lo;
    const uint32_t hi = open0 ? p[0].hi : p[1].hi;
    const uint32_t span = hi - lo;
    const int bits = 32 - __clz(span);
    const int shift = bits > kBinBits ? bits - kBinBits : 0;
    histogram(col, S, lo, span, shift, hist, lane);
    scan_bins(hist, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool open = j == 0 ? open0 : open1;
      if (!open || p[j].lo != lo || p[j].hi != hi) continue;
      narrow(p[j], hist, col, S, shift, lane);
      if (!p[j].done && p[j].cnt > kCand) {
        uint32_t a, b;
        range_minmax(col, S, p[j].lo, p[j].hi, lane, a, b);
        tighten(p[j], a, b);
      }
    }
  }
  // Gather each open pair's <= 32 keys (the two ranges may overlap), then
  // rank them.
  if (!p[0].done || !p[1].done) {
    int n0 = 0, n1 = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int s0 = 0; s0 < S; s0 += 128) {
      uint32_t k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + 32 * u + lane;
        k[u] = s < S ? col[s] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool valid = s0 + 32 * u + lane < S;
        const bool in0 =
            valid && !p[0].done && k[u] - p[0].lo <= p[0].hi - p[0].lo;
        const bool in1 =
            valid && !p[1].done && k[u] - p[1].lo <= p[1].hi - p[1].lo;
        const unsigned b0 = __ballot_sync(kFull, in0);
        const unsigned b1 = __ballot_sync(kFull, in1);
        if (in0) cand[n0 + __popc(b0 & below)] = k[u];
        if (in1) cand[kCand + n1 + __popc(b1 & below)] = k[u];
        n0 += __popc(b0);
        n1 += __popc(b1);
      }
    }
    __syncwarp();
    if (!p[0].done) resolve(p[0], cand, n0, lane);
    if (!p[1].done) resolve(p[1], cand + kCand, n1, lane);
    __syncwarp();
  }
  out_lo = interpolate(p[0], r_lo);
  out_hi = interpolate(p[1], r_hi);
}

}  // namespace sampling
}  // namespace tsspark
