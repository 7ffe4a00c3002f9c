// K2 `bands`: predictive intervals of the MAP forecast, samples never
// stored in full.
//
// Replaces the XLA-fused sampling path of the JAX package (no Pallas
// kernel there either):
//   tsspark_tpu/models/prophet/predict.py  _simulate_trends (linear and
//     flat growth) and the noise draw + jnp.quantile of forecast
// which materializes (S, B, T) trend paths and samples in device memory
// and sorts them along S.
//
// Per series row b and sample s it walks t in order:
//   new_delta = 1[u < cp_prob] * 1[t > 1] * laplace * lam
//   c += new_delta;  d += new_delta * t
//   trend_s = det + t*c - d                 (linear; flat: trend_s = det)
//   sample  = trend_s * (1 + mult) + add + normal * exp(log_sigma)
// with cp_prob and lam computed once per row exactly as predict.py
// does (mean future spacing times n_cp, clipped to [0, 1]; mean |delta|
// floored at 1e-8), and no noise floor on sigma.  At each t it takes the
// lower and upper quantiles of the S samples and of the S trend values
// with jnp.quantile's "linear" rule (position q * (S - 1), the floor and
// ceil order statistics weighted by its fractional part), mapped to data
// units.
//
// Variates: a Philox4x32-10 counter keyed on (seed) with counter
// (t, sample, row) gives the Bernoulli uniform, the Laplace uniform and
// the two Box-Muller uniforms of each draw, so a draw depends on its
// coordinates only.  The row coordinate is the row's index in the launch,
// or the caller's id for it (`rows`).  With given draws (three (S, B, T)
// tensors: U(0,1), standard Laplace, standard normal) the kernel reads
// them instead, which holds it against the plain version on the same
// variates.
//
// What bounds it: operations.  The simulation is ~20 float operations a
// sample and step, the variates one Philox4x32-10 draw (40 integer
// multiplies) and four transcendentals; the bytes moved (four (B, T)
// inputs, four (B, T) outputs) are small beside that.  The quantiles need
// two order statistics per column, which a selection finds in O(S) work:
// no sort.
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

// Two designs by sample count:
// * S <= kFusedMaxSamples: one block a row, a thread a sample (or up to
//   four).  Each thread keeps its samples' c and d in registers and
//   simulates a tile of steps, writing the tile's sample and trend keys
//   to shared memory and each warp its share of every column's min and
//   max; after one block barrier the warps select the tile's columns, a
//   warp a column, with no block barrier between columns.  Tiles
//   alternate between two buffers, so the next tile's simulation needs no
//   second barrier: one block barrier a tile.
// * larger S: the rows are taken in chunks whose keys fit the caller's
//   device-memory scratch.  One kernel simulates, a thread a sample, and
//   writes the chunk's keys column by column (coalesced); a second runs
//   the same selection over each column in device memory, a warp a
//   column.  A row whose steps do not fit at once is taken in chunks of
//   steps, its c and d carried in the scratch between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLinear = 0;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFusedThreads = 256;
constexpr int kFusedMaxSamples = 1024;   // four samples a thread at most
constexpr int kTileKeyBytes = 16 * 1024; // keys of one fused tile buffer
// Blocks a multiprocessor the fused kernel's registers are cut for: four
// (64 registers, a small spill) ran faster on the card than three (80)
// or one (~100), the selection being latency-bound.
constexpr int kFusedMinBlocks = 4;
constexpr int kSimThreads = 256;         // scratch path: simulate kernel
constexpr int kSelectWarps = 8;          // scratch path: select kernel

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

// What a row needs besides its cells: the changepoint probability of a
// future step, the Laplace scale and sigma.  One thread, serial sums.
struct RowConsts {
  float cp, lam, sigma;
};

__device__ __forceinline__ RowConsts row_consts(const float* t_row, int T,
                                                const float* th, int ncp) {
  float num = 0.0f, cnt = 0.0f, prev = t_row[0];
  for (int i = 0; i < T; ++i) {
    const float ti = t_row[i];
    const float fut = ti > 1.0f ? 1.0f : 0.0f;
    num = num + (ti - prev) * fut;
    cnt = cnt + fut;
    prev = ti;
  }
  const float mean_dt = num / fmaxf(cnt, 1.0f);
  RowConsts rc;
  rc.cp = fminf(fmaxf(static_cast<float>(ncp) * mean_dt, 0.0f), 1.0f);
  float lam = 0.0f;
  if (ncp > 0) {
    for (int j = 0; j < ncp; ++j) lam = lam + fabsf(th[3 + j]);
    lam = lam / static_cast<float>(ncp);
  }
  rc.lam = fmaxf(lam, 1e-8f);
  rc.sigma = expf(th[2]);
  return rc;
}

// Everything one step of one sample path reads.
struct SimArgs {
  const float *t, *det, *add, *mult;
  const float *du, *dlap, *dz;  // given draws, or null
  uint32_t k0, k1;
  int B, T, growth;
};

// Step i of sample s of data row `row` (Philox row coordinate `crow`):
// advances c and d and gives the sample and the trend, scaled units.
__device__ __forceinline__ void simulate_step(const SimArgs& a,
                                              const RowConsts& rc, int row,
                                              uint32_t crow, int s, int i,
                                              float& c, float& d, float& smp,
                                              float& trs) {
  const long long cell = static_cast<long long>(row) * a.T + i;
  const float ti = a.t[cell];
  float u, lap, z;
  if (a.du != nullptr) {
    const long long di = (static_cast<long long>(s) * a.B + row) * a.T + i;
    u = a.du[di];
    lap = a.dlap[di];
    z = a.dz[di];
  } else {
    const Philox4 rn = philox4x32_10(
        Philox4{static_cast<uint32_t>(i), static_cast<uint32_t>(s), crow, 0u},
        a.k0, a.k1);
    u = u01(rn.x);
    const float v = u01_open(rn.y) - 0.5f;
    lap = v < 0.0f ? log1pf(2.0f * v) : -log1pf(-2.0f * v);
    z = sqrtf(-2.0f * logf(u01_open(rn.z))) * cospif(2.0f * u01(rn.w));
  }
  float tr = a.det[cell];
  if (a.growth == kLinear) {
    const float fut = ti > 1.0f ? 1.0f : 0.0f;
    const float ind = (u < rc.cp ? 1.0f : 0.0f) * fut;
    const float nd = ind * (lap * rc.lam);
    c = c + nd;
    d = d + nd * ti;
    tr = tr + ti * c - d;
  }
  smp = tr * (1.0f + a.mult[cell]) + a.add[cell] + z * rc.sigma;
  trs = tr;
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

// ---- fused design: one block a row -----------------------------------------

template <int SPT>
__global__ void __launch_bounds__(kFusedThreads, kFusedMinBlocks) bands_fused(
    SimArgs a,
    const float* __restrict__ theta,  // (B, P)
    const float* __restrict__ y_scale, const float* __restrict__ floor_,
    const int* __restrict__ rows,     // (B,) Philox row ids, or null
    float q_lo, float q_hi,
    float* __restrict__ y_lo, float* __restrict__ y_hi,
    float* __restrict__ tr_lo, float* __restrict__ tr_hi,
    float* __restrict__ samples,      // (S, B, T) or null
    int P, int ncp, int S, int TT) {
  extern __shared__ __align__(16) uint32_t sh[];
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  uint32_t* keys = sh;                       // [2][TT][2][S]
  uint32_t* parts = keys + 4 * TT * S;       // [2][TT][2][nwarps][2]
  int* hist = reinterpret_cast<int*>(parts + 8 * TT * nwarps) +
              (threadIdx.x >> 5) * kBins;  // [nwarps][256]
  uint32_t* cand = reinterpret_cast<uint32_t*>(
                       reinterpret_cast<int*>(parts + 8 * TT * nwarps) +
                       nwarps * kBins) +
                   (threadIdx.x >> 5) * 2 * kCand;  // [nwarps][2][32]
  __shared__ RowConsts sh_rc;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int T = a.T;
  if (tid == 0)
    sh_rc = row_consts(a.t + static_cast<long long>(row) * T, T,
                       theta + static_cast<long long>(row) * P, ncp);
  const uint32_t crow =
      rows != nullptr ? static_cast<uint32_t>(rows[row]) : row;
  const float sc = y_scale[row], fl = floor_[row];
  __syncthreads();
  const RowConsts rc = sh_rc;
  const Rule r_lo = quantile_rule(q_lo, S), r_hi = quantile_rule(q_hi, S);
  float c[SPT], d[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r) c[r] = d[r] = 0.0f;

  const int ntiles = (T + TT - 1) / TT;
  for (int tile = 0; tile < ntiles; ++tile) {
    uint32_t* buf = keys + (tile & 1) * 2 * TT * S;
    uint32_t* part = parts + (tile & 1) * 4 * TT * nwarps;
    const int t0 = tile * TT;
    const int n = min(TT, T - t0);
    for (int j = 0; j < n; ++j) {
      const int i = t0 + j;
      // Each warp's least and largest key of the step's two columns.
      uint32_t ymin = 0xffffffffu, ymax = 0u, tmin = 0xffffffffu, tmax = 0u;
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int s = tid + r * nt;
        if (s < S) {
          float smp, trs;
          simulate_step(a, rc, row, crow, s, i, c[r], d[r], smp, trs);
          if (samples != nullptr)
            samples[(static_cast<long long>(s) * a.B + row) * T + i] =
                __fadd_rn(__fmul_rn(smp, sc), fl);
          const uint32_t ky = order_key(smp), kt = order_key(trs);
          buf[(2 * j) * S + s] = ky;
          buf[(2 * j + 1) * S + s] = kt;
          ymin = min(ymin, ky);
          ymax = max(ymax, ky);
          tmin = min(tmin, kt);
          tmax = max(tmax, kt);
        }
      }
      ymin = __reduce_min_sync(kFull, ymin);
      ymax = __reduce_max_sync(kFull, ymax);
      tmin = __reduce_min_sync(kFull, tmin);
      tmax = __reduce_max_sync(kFull, tmax);
      if (lane == 0) {
        uint32_t* pj = part + (2 * j) * 2 * nwarps;
        pj[2 * warp] = ymin;
        pj[2 * warp + 1] = ymax;
        pj[2 * (nwarps + warp)] = tmin;
        pj[2 * (nwarps + warp) + 1] = tmax;
      }
    }
    // The tile's keys are complete, and every warp is done with the
    // buffer this tile's successor will write (the tile before this one).
    __syncthreads();
    for (int col = warp; col < 2 * n; col += nwarps) {
      const uint32_t* pc = part + col * 2 * nwarps;
      const bool has = lane < nwarps;
      const uint32_t mn =
          __reduce_min_sync(kFull, has ? pc[2 * lane] : 0xffffffffu);
      const uint32_t mx =
          __reduce_max_sync(kFull, has ? pc[2 * lane + 1] : 0u);
      float lo, hi;
      select_column(buf + col * S, S, mn, mx, r_lo, r_hi, hist, cand, lane,
                    lo, hi);
      if (lane == 0) {
        const long long cell =
            static_cast<long long>(row) * T + t0 + (col >> 1);
        float* dlo = (col & 1) ? tr_lo : y_lo;
        float* dhi = (col & 1) ? tr_hi : y_hi;
        dlo[cell] = __fadd_rn(__fmul_rn(lo, sc), fl);
        dhi[cell] = __fadd_rn(__fmul_rn(hi, sc), fl);
      }
    }
  }
}

// ---- scratch design: simulate, then select in device memory ----------------

// Rows [r0, r0 + nr), steps [t0, t0 + nst): thread = sample, y = row.
// keys: [nr][nst][2][S]; carry: [nr][2][S] c and d between step chunks.
__global__ void __launch_bounds__(kSimThreads) bands_simulate(
    SimArgs a, const float* __restrict__ theta,
    const float* __restrict__ y_scale, const float* __restrict__ floor_,
    const int* __restrict__ rows, float* __restrict__ samples,
    uint32_t* __restrict__ keys, float* __restrict__ carry, int P, int ncp,
    int S, int r0, int t0, int nst) {
  __shared__ RowConsts sh_rc;
  const int rl = blockIdx.y;
  const int row = r0 + rl;
  const int T = a.T;
  if (threadIdx.x == 0)
    sh_rc = row_consts(a.t + static_cast<long long>(row) * T, T,
                       theta + static_cast<long long>(row) * P, ncp);
  __syncthreads();
  const int s = blockIdx.x * kSimThreads + threadIdx.x;
  if (s >= S) return;
  const RowConsts rc = sh_rc;
  const uint32_t crow =
      rows != nullptr ? static_cast<uint32_t>(rows[row]) : row;
  const float sc = y_scale[row], fl = floor_[row];
  float* cc = carry + static_cast<long long>(rl) * 2 * S;
  float c = 0.0f, d = 0.0f;
  if (t0 > 0) {
    c = cc[s];
    d = cc[S + s];
  }
  uint32_t* k = keys + static_cast<long long>(rl) * nst * 2 * S;
  for (int j = 0; j < nst; ++j) {
    const int i = t0 + j;
    float smp, trs;
    simulate_step(a, rc, row, crow, s, i, c, d, smp, trs);
    if (samples != nullptr)
      samples[(static_cast<long long>(s) * a.B + row) * T + i] =
          __fadd_rn(__fmul_rn(smp, sc), fl);
    k[(2 * j) * S + s] = order_key(smp);
    k[(2 * j + 1) * S + s] = order_key(trs);
  }
  if (t0 + nst < T) {
    cc[s] = c;
    cc[S + s] = d;
  }
}

// One warp a column of the chunk's keys.
__global__ void __launch_bounds__(32 * kSelectWarps) bands_select(
    const uint32_t* __restrict__ keys, const float* __restrict__ y_scale,
    const float* __restrict__ floor_, float q_lo, float q_hi,
    float* __restrict__ y_lo, float* __restrict__ y_hi,
    float* __restrict__ tr_lo, float* __restrict__ tr_hi, int T, int S,
    int r0, int nr, int t0, int nst) {
  __shared__ __align__(16) int hist[kSelectWarps][kBins];
  __shared__ uint32_t cand[kSelectWarps][2 * kCand];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long col =
      static_cast<long long>(blockIdx.x) * kSelectWarps + warp;
  if (col >= static_cast<long long>(nr) * nst * 2) return;
  const uint32_t* ck = keys + col * S;
  uint32_t mn, mx;
  range_minmax(ck, S, 0u, 0xffffffffu, lane, mn, mx);
  float lo, hi;
  select_column(ck, S, mn, mx, quantile_rule(q_lo, S),
                quantile_rule(q_hi, S), hist[warp], cand[warp], lane, lo, hi);
  if (lane == 0) {
    const int rl = static_cast<int>(col / (2 * nst));
    const int j = static_cast<int>((col >> 1) % nst);
    const int row = r0 + rl;
    const long long cell = static_cast<long long>(row) * T + t0 + j;
    const float sc = y_scale[row], fl = floor_[row];
    float* dlo = (col & 1) ? tr_lo : y_lo;
    float* dhi = (col & 1) ? tr_hi : y_hi;
    dlo[cell] = __fadd_rn(__fmul_rn(lo, sc), fl);
    dhi[cell] = __fadd_rn(__fmul_rn(hi, sc), fl);
  }
}

// Steps of one fused tile: a buffer's keys within kTileKeyBytes, but at
// least a column a warp (at most 32 steps).
int fused_tile(int S, int nt, int T) {
  int tt = kTileKeyBytes / (2 * S * 4);
  const int want = (nt / 32 + 1) / 2;
  if (tt < want) tt = want;
  if (tt < 1) tt = 1;
  if (tt > 32) tt = 32;
  return tt < T ? tt : T;
}

template <int SPT>
cudaError_t launch_fused(int B, int nt, int TT, cudaStream_t st,
                         const SimArgs& a, const float* theta,
                         const float* y_scale, const float* floor_,
                         const int* rows, float q_lo, float q_hi,
                         float* y_lo, float* y_hi, float* tr_lo,
                         float* tr_hi, float* samples, int P, int ncp,
                         int S) {
  const size_t shmem = sizeof(uint32_t) * (4 * TT * S + 8 * TT * (nt / 32)) +
                       sizeof(int) * (nt / 32) * (kBins + 2 * kCand);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bands_fused<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  bands_fused<SPT><<<B, nt, shmem, st>>>(a, theta, y_scale, floor_, rows,
                                         q_lo, q_hi, y_lo, y_hi, tr_lo, tr_hi,
                                         samples, P, ncp, S, TT);
  return cudaGetLastError();
}

// Rows and steps of one scratch chunk for S samples over T steps within
// `scratch_floats` floats: whole rows where one fits, else one row's
// steps in chunks (its c and d carried, 2 S floats).
bool scratch_plan(long long scratch_floats, int B, int T, int S,
                  int* rows_out, int* steps_out) {
  const long long per_step = 2ll * S;
  const long long per_row = per_step * T + 2ll * S;
  if (scratch_floats >= per_row) {
    long long nr = scratch_floats / per_row;
    if (nr > B) nr = B;
    *rows_out = static_cast<int>(nr);
    *steps_out = T;
    return true;
  }
  const long long nst = (scratch_floats - 2ll * S) / per_step;
  if (nst < 1) return false;
  *rows_out = 1;
  *steps_out = static_cast<int>(nst);
  return true;
}

}  // namespace

extern "C" int tsspark_bands(
    const float* t, const float* det, const float* add, const float* mult,
    const float* theta, const float* y_scale, const float* floor_,
    const float* du, const float* dlap, const float* dz, const int* rows,
    unsigned long long seed, float q_lo, float q_hi,
    float* y_lo, float* y_hi, float* tr_lo, float* tr_hi, float* samples,
    float* scratch, long long scratch_floats,
    int B, int T, int P, int ncp, int S, int growth, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SimArgs a;
  a.t = t;
  a.det = det;
  a.add = add;
  a.mult = mult;
  a.du = du;
  a.dlap = dlap;
  a.dz = dz;
  a.k0 = static_cast<uint32_t>(seed);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.B = B;
  a.T = T;
  a.growth = growth;
  if (S <= kFusedMaxSamples) {
    const int s32 = (S + 31) & ~31;
    const int nt = s32 < kFusedThreads ? s32 : kFusedThreads;
    const int spt = (S + nt - 1) / nt;
    const int TT = fused_tile(S, nt, T);
#define TSSPARK_FUSED(SPT)                                                  \
  launch_fused<SPT>(B, nt, TT, st, a, theta, y_scale, floor_, rows, q_lo,   \
                    q_hi, y_lo, y_hi, tr_lo, tr_hi, samples, P, ncp, S)
    cudaError_t err;
    if (spt == 1) err = TSSPARK_FUSED(1);
    else if (spt == 2) err = TSSPARK_FUSED(2);
    else err = TSSPARK_FUSED(4);
#undef TSSPARK_FUSED
    return static_cast<int>(err);
  }
  int nr = 0, nst = 0;
  if (scratch == nullptr ||
      !scratch_plan(scratch_floats, B, T, S, &nr, &nst))
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* keys = reinterpret_cast<uint32_t*>(scratch);
  float* carry = scratch + 2ll * S * nst * nr;
  const int sblocks = (S + kSimThreads - 1) / kSimThreads;
  for (int r0 = 0; r0 < B; r0 += nr) {
    const int rn = B - r0 < nr ? B - r0 : nr;
    for (int t0 = 0; t0 < T; t0 += nst) {
      const int sn = T - t0 < nst ? T - t0 : nst;
      bands_simulate<<<dim3(sblocks, rn), kSimThreads, 0, st>>>(
          a, theta, y_scale, floor_, rows, samples, keys, carry, P, ncp, S,
          r0, t0, sn);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long cols = 2ll * rn * sn;
      const int blocks =
          static_cast<int>((cols + kSelectWarps - 1) / kSelectWarps);
      bands_select<<<blocks, 32 * kSelectWarps, 0, st>>>(
          keys, y_scale, floor_, q_lo, q_hi, y_lo, y_hi, tr_lo, tr_hi, T, S,
          r0, rn, t0, sn);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
