// K2 `bands`: predictive intervals of the MAP forecast, samples never
// stored in full.
//
// Replaces the XLA-fused sampling path of the JAX package (no Pallas
// kernel there either):
//   tsspark_tpu/models/prophet/predict.py  _simulate_trends (linear,
//     logistic and flat growth) and the noise draw + jnp.quantile of
//     forecast
// which materializes (S, B, T) trend paths and samples in device memory
// and sorts them along S (and, for logistic growth, recomputes the trend
// of every sample over n_cp + T changepoints).
//
// Per series row b and sample s it walks t in order:
//   new_delta = 1[u < cp_prob] * 1[t > 1] * laplace * lam
//   c += new_delta;  d += new_delta * t
//   trend_s = det + t*c - d                 (linear; flat: trend_s = det)
//   sample  = trend_s * (1 + mult) + add + normal * exp(log_sigma)
// with cp_prob and lam computed once per row as predict.py does (mean
// future spacing times n_cp, clipped to [0, 1]; mean |delta| floored at
// 1e-8), and no noise floor on sigma.
// Logistic growth carries the offset recursion of the JAX package's
// per-sample recompute along the steps instead (predict._logistic_paths,
// the plain version): c is the running sum of deltas (the history
// changepoints', then each step's draw) and d the running sum of gammas,
// each step adding one changepoint at t_clamped = max(t, 1 + 1e-6) by
// logistic_step (prophet_model.cuh: no fused multiply-adds, so c, k + c
// and d are the plain version's bits); a step with t >= t_clamped reads
//   trend_s = cap * sigmoid((k + c) (t - (m + d)))
// and an earlier one the deterministic trend det.  Its cp_prob and lam
// come from the wrapper (predict.sample_rates), so the sampled deltas are
// the plain version's bits too.  At each t it takes the
// lower and upper quantiles of the S samples and of the S trend values
// with jnp.quantile's "linear" rule (position q * (S - 1), the floor and
// ceil order statistics weighted by its fractional part), mapped to data
// units.
//
// Variates: one Philox4x32-10 draw a sample and step, counter (t, sample,
// row, 0) keyed on the seed (sampling.cuh), gives the Bernoulli uniform,
// the Laplace uniform and the two Box-Muller uniforms, so a draw depends on
// its coordinates only.  The row coordinate is the row's index in the
// launch, or the caller's id for it (`rows`).  With given draws (three
// (S, B, T) tensors: U(0,1), standard Laplace, standard normal) the kernel
// reads them instead, which holds it against the plain version on the same
// variates.
//
// What bounds it: operations.  The simulation is ~20 float operations a
// sample and step (logistic growth: ~30 and a division and an
// exponential), the variates one Philox4x32-10 draw (40 integer
// multiplies) and four transcendentals; the bytes moved (four (B, T)
// inputs, five with the capacity, four (B, T) outputs) are small beside
// that.  The quantiles need
// two order statistics per column, which a selection finds in O(S) work:
// no sort.
//
// Selection: sampling.cuh's warp selection of the two order statistics
// a quantile needs (shared with K6 `draws`).

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

#include "prophet_model.cuh"
#include "sampling.cuh"

namespace {

using namespace tsspark::sampling;

constexpr int kLinear = tsspark::kLinear;
constexpr int kLogistic = tsspark::kLogistic;
constexpr int kFusedThreads = 256;
constexpr int kFusedMaxSamples = 1024;   // four samples a thread at most
constexpr int kTileKeyBytes = 16 * 1024; // keys of one fused tile buffer
// Blocks a multiprocessor the fused kernel's registers are cut for: four
// (64 registers, a small spill) ran faster on the card than three (80)
// or one (~100), the selection being latency-bound.
constexpr int kFusedMinBlocks = 4;
constexpr int kSimThreads = 256;         // scratch path: simulate kernel
constexpr int kSelectWarps = 8;          // scratch path: select kernel


// What a row needs besides its cells: the changepoint probability of a
// future step, the Laplace scale and sigma; for logistic growth k, m and
// the offset recursion's running sums after the history changepoints
// (c0, d0: the paths' start).  One thread, serial sums.  Logistic growth
// takes cp and lam from the wrapper (`rate_row`, the plain version's
// reductions), so both versions draw the same deltas.
struct RowConsts {
  float cp, lam, sigma, k, m, c0, d0;
};

template <bool kLogi>
__device__ __forceinline__ RowConsts row_consts(const float* t_row, int T,
                                                const float* th, int ncp,
                                                const float* s_row,
                                                const float* rate_row) {
  RowConsts rc;
  rc.sigma = expf(th[2]);
  rc.k = th[0];
  rc.m = th[1];
  rc.c0 = rc.d0 = 0.0f;
  if constexpr (kLogi) {
    rc.cp = rate_row[0];
    rc.lam = rate_row[1];
    float k_prev = rc.k;
    for (int j = 0; j < ncp; ++j)
      tsspark::logistic_step(rc.k, rc.m, s_row[j], th[3 + j], rc.c0, k_prev,
                             rc.d0);
  } else {
    float num = 0.0f, cnt = 0.0f, prev = t_row[0];
    for (int i = 0; i < T; ++i) {
      const float ti = t_row[i];
      const float fut = ti > 1.0f ? 1.0f : 0.0f;
      num = num + (ti - prev) * fut;
      cnt = cnt + fut;
      prev = ti;
    }
    const float mean_dt = num / fmaxf(cnt, 1.0f);
    rc.cp = fminf(fmaxf(static_cast<float>(ncp) * mean_dt, 0.0f), 1.0f);
    float lam = 0.0f;
    if (ncp > 0) {
      for (int j = 0; j < ncp; ++j) lam = lam + fabsf(th[3 + j]);
      lam = lam / static_cast<float>(ncp);
    }
    rc.lam = fmaxf(lam, 1e-8f);
  }
  return rc;
}

// Everything one step of one sample path reads.
struct SimArgs {
  const float *t, *det, *add, *mult;
  const float *cap, *s, *rates;  // logistic growth: (B, T), (B, ncp), (B, 2)
  const float *du, *dlap, *dz;  // given draws, or null
  uint32_t k0, k1;
  int B, T, growth;
};

// Step i of sample s of data row `row` (Philox row coordinate `crow`):
// advances c and d and gives the sample and the trend, scaled units.
// Linear growth: c, d = the sums of new_delta and new_delta * t; logistic
// (kLogi, its own instantiation, so the linear and flat code keeps its
// registers): of the deltas and the gammas (starting at the row's c0, d0).
template <bool kLogi>
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
    const Variates v = philox_variates(static_cast<uint32_t>(i),
                                       static_cast<uint32_t>(s), crow, 0u,
                                       a.k0, a.k1);
    u = v.u;
    lap = v.lap;
    z = v.z;
  }
  const float tr = path_step<kLogi>(a.growth, ti, a.cap + cell, a.det[cell],
                                    u, lap, rc.cp, rc.lam, rc.k, rc.m, c, d);
  smp = tr * (1.0f + a.mult[cell]) + a.add[cell] + z * rc.sigma;
  trs = tr;
}


// ---- fused design: one block a row -----------------------------------------

template <int SPT, bool kLogi>
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
    sh_rc = row_consts<kLogi>(a.t + static_cast<long long>(row) * T, T,
                              theta + static_cast<long long>(row) * P, ncp,
                              a.s + static_cast<long long>(row) * ncp,
                              a.rates + 2ll * row);
  const uint32_t crow =
      rows != nullptr ? static_cast<uint32_t>(rows[row]) : row;
  const float sc = y_scale[row], fl = floor_[row];
  __syncthreads();
  const RowConsts rc = sh_rc;
  const Rule r_lo = quantile_rule(q_lo, S), r_hi = quantile_rule(q_hi, S);
  float c[SPT], d[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    c[r] = rc.c0;
    d[r] = rc.d0;
  }

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
          simulate_step<kLogi>(a, rc, row, crow, s, i, c[r], d[r], smp,
                               trs);
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
template <bool kLogi>
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
    sh_rc = row_consts<kLogi>(a.t + static_cast<long long>(row) * T, T,
                              theta + static_cast<long long>(row) * P, ncp,
                              a.s + static_cast<long long>(row) * ncp,
                              a.rates + 2ll * row);
  __syncthreads();
  const int s = blockIdx.x * kSimThreads + threadIdx.x;
  if (s >= S) return;
  const RowConsts rc = sh_rc;
  const uint32_t crow =
      rows != nullptr ? static_cast<uint32_t>(rows[row]) : row;
  const float sc = y_scale[row], fl = floor_[row];
  float* cc = carry + static_cast<long long>(rl) * 2 * S;
  float c = rc.c0, d = rc.d0;
  if (t0 > 0) {
    c = cc[s];
    d = cc[S + s];
  }
  uint32_t* k = keys + static_cast<long long>(rl) * nst * 2 * S;
  for (int j = 0; j < nst; ++j) {
    const int i = t0 + j;
    float smp, trs;
    simulate_step<kLogi>(a, rc, row, crow, s, i, c, d, smp, trs);
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

template <int SPT, bool kLogi>
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
        bands_fused<SPT, kLogi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  bands_fused<SPT, kLogi><<<B, nt, shmem, st>>>(
      a, theta, y_scale, floor_, rows, q_lo, q_hi, y_lo, y_hi, tr_lo, tr_hi,
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

// cap (B, T), s (B, ncp) and rates (B, 2): logistic growth's capacity,
// history changepoints and each row's (changepoint probability, Laplace
// scale); null for linear and flat.
extern "C" int tsspark_bands(
    const float* t, const float* det, const float* add, const float* mult,
    const float* theta, const float* y_scale, const float* floor_,
    const float* cap, const float* s, const float* rates,
    const float* du, const float* dlap, const float* dz, const int* rows,
    unsigned long long seed, float q_lo, float q_hi,
    float* y_lo, float* y_hi, float* tr_lo, float* tr_hi, float* samples,
    float* scratch, long long scratch_floats,
    int B, int T, int P, int ncp, int S, int growth, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (S < 1 || (growth == kLogistic &&
                 (cap == nullptr || rates == nullptr ||
                  (ncp > 0 && s == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SimArgs a;
  a.t = t;
  a.det = det;
  a.add = add;
  a.mult = mult;
  a.cap = cap;
  a.s = s;
  a.rates = rates;
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
#define TSSPARK_FUSED(SPT, LOGI)                                            \
  launch_fused<SPT, LOGI>(B, nt, TT, st, a, theta, y_scale, floor_, rows,   \
                          q_lo, q_hi, y_lo, y_hi, tr_lo, tr_hi, samples, P, \
                          ncp, S)
    const bool logi = growth == kLogistic;
    cudaError_t err;
    if (spt == 1)
      err = logi ? TSSPARK_FUSED(1, true) : TSSPARK_FUSED(1, false);
    else if (spt == 2)
      err = logi ? TSSPARK_FUSED(2, true) : TSSPARK_FUSED(2, false);
    else
      err = logi ? TSSPARK_FUSED(4, true) : TSSPARK_FUSED(4, false);
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
      if (growth == kLogistic)
        bands_simulate<true><<<dim3(sblocks, rn), kSimThreads, 0, st>>>(
            a, theta, y_scale, floor_, rows, samples, keys, carry, P, ncp, S,
            r0, t0, sn);
      else
        bands_simulate<false><<<dim3(sblocks, rn), kSimThreads, 0, st>>>(
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
