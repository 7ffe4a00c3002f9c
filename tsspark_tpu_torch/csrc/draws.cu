// K6 `draws`: the posterior-predictive forecast from S posterior draws per
// series, the (S, B, T) intermediates never stored.
//
// Replaces the XLA-fused posterior-predictive path of the JAX package (it
// has no Pallas kernel; XLA fused a vmap over the draws):
//   tsspark_tpu/models/prophet/predict.py  forecast_from_draws (with
//     _simulate_trends, trend_fn, seasonal_split and jnp.quantile)
// which builds (S, B, T) trajectories in device memory (at 300 draws of
// 30,490 series over 1,941 days, 71 GB each) and sorts them along S.
//
// For each row b and each of its S draws theta_s it walks t in order:
//   det_s  = trend(theta_s, t)            K1's trend: the linear prefix form
//                                         (D_n, E_n carried along the walk),
//                                         logistic_step's offset recursion
//                                         (logistic), or m (flat)
//   add_s, mult_s = feature totals        feature_totals_cell's order
//   dety_s = det_s (1 + mult_s) + add_s
//   tr_s   = one simulated trend path     sampling.cuh path_step: K2's
//            with theta_s's own Laplace   simulation, its rate (lam_s) and
//            scale lam_s                  the row's changepoint probability
//   y_s    = tr_s (1 + mult_s) + add_s + z exp(theta_s[2])
// and per (b, t) writes the means over s of dety, det, add and mult (summed
// in ascending s, so a row's output is the same bits in any batch), and the
// two interval quantiles of y_s and of tr_s across the S draws
// (jnp.quantile's "linear" rule, by sampling.cuh's warp selection, K2's),
// all mapped to data units.  Every formula comes from prophet_model.cuh and
// sampling.cuh, the headers K1, K2 and K3 take theirs from.
//
// Variates: one Philox4x32-10 draw a sample and step, counter (t, sample,
// row, 1) keyed on the seed (sampling.cuh; stream 1, where K2 draws on 0):
// a draw depends on its coordinates only, the row coordinate the row's
// index in the whole batch (row0 + the launch's row) or the caller's id
// (`rows`).  Given draws (three (S, B, T) tensors: U(0,1), standard
// Laplace, standard normal) are read instead, to hold the kernel against
// the plain version and the JAX package on the same variates.  Each row's
// changepoint probability cp (B,) and each draw's Laplace scale lam (B, S)
// come from the wrapper (the plain version's own reductions), so both
// versions draw the same deltas.
//
// What bounds it: operations.  A sample-cell takes one Philox4x32-10 draw
// (40 integer multiplies) and four transcendentals, ~4F + 30 float
// operations (F feature columns, two coefficients each), against reading
// the draws once and writing eight (B, T) outputs.
//
// Design (simple first): one block a row, a thread a draw (S <= 1,024).
// A draw's parameters stay in device memory in the wrapper's (B, P, S)
// layout, so a warp's loads of one parameter are coalesced; its changepoint
// walk state and path sums live in registers.  Steps go in tiles of TT: each
// thread writes its four deterministic values and its sample's and trend's
// order keys for the tile's steps to shared memory, each warp its share of
// every key column's min and max; after a block barrier a thread sums each
// mean column in order and a warp selects each key column, and a second
// barrier frees the buffers for the next tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prophet_model.cuh"
#include "sampling.cuh"

namespace {

using namespace tsspark;
using namespace tsspark::sampling;

constexpr int kMaxSamples = 1024;         // a thread a draw
constexpr int kTileBytes = 64 * 1024;     // a tile's values and keys
constexpr uint32_t kStream = 1u;          // Philox stream of K6

struct DrawArgs {
  const float *theta_t;              // (B, P, S)
  const float *t, *s, *cap;          // (B, T), (B, ncp), (B, T) or null
  const float *xs;                   // (T, Fs) or (B, T, Fs)
  long long xs_bstride;              // 0 (shared) or T * Fs
  const float *xr, *mm;              // (B, T, R), (F,)
  const float *cp, *lam;             // (B,), (B, S)
  const float *y_scale, *floor_;     // (B,)
  const float *du, *dlap, *dz;       // given draws (S, B, T), or null
  const int* rows;                   // (B,) Philox row ids, or null
  long long row0;                    // row coordinate of row 0 otherwise
  uint32_t k0, k1;
  float q_lo, q_hi;
  float *yhat, *trend, *add, *mult;  // (B, T) outputs
  float *y_lo, *y_hi, *tr_lo, *tr_hi;
  float* samples;                    // (S, B, T) or null
  int B, T, P, ncp, Fs, R, S, TT;
};

// Steps of a tile: four value columns and two key columns of S floats a
// step within kTileBytes, 1 to 32 steps.
int tile_steps(int S, int T) {
  int tt = kTileBytes / (24 * S);
  if (tt < 1) tt = 1;
  if (tt > 32) tt = 32;
  return tt < T ? tt : T;
}

// Floats before the selection's histograms: the tile's values and keys
// and the key columns' per-warp min and max, rounded up to 16 bytes (the
// histograms are read four bins at a time).
__host__ __device__ inline int hist_offset(int S, int nwarps, int TT) {
  return round4(6 * TT * S + 4 * TT * nwarps);
}

size_t smem_bytes(int S, int nt, int TT, int ncp, int F) {
  const int nwarps = nt / 32;
  return sizeof(float) * (static_cast<size_t>(hist_offset(S, nwarps, TT)) +
                          nwarps * (kBins + 2 * kCand) + ncp + F);
}

template <int kGrowth>
__global__ void __launch_bounds__(kMaxSamples) draws_kernel(DrawArgs a) {
  extern __shared__ __align__(16) uint32_t sh[];
  constexpr bool kLogi = kGrowth == kLogistic;
  const int S = a.S, T = a.T, TT = a.TT, ncp = a.ncp, P = a.P;
  const int F = a.Fs + a.R;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* vals = reinterpret_cast<float*>(sh);  // [4][TT][S]
  uint32_t* keys = sh + 4 * TT * S;            // [TT][2][S]
  uint32_t* parts = keys + 2 * TT * S;         // [TT][2][nwarps][2]
  int* hist_all = reinterpret_cast<int*>(sh + hist_offset(S, nwarps, TT));
  int* hist = hist_all + warp * kBins;
  uint32_t* cand_all =
      reinterpret_cast<uint32_t*>(hist_all + nwarps * kBins);
  uint32_t* cand = cand_all + warp * 2 * kCand;
  float* s_row = reinterpret_cast<float*>(cand_all + nwarps * 2 * kCand);
  float* mm = s_row + ncp;

  const int row = blockIdx.x;
  for (int j = tid; j < ncp; j += nt)
    s_row[j] = a.s[static_cast<long long>(row) * ncp + j];
  for (int f = tid; f < F; f += nt) mm[f] = a.mm[f];
  __syncthreads();

  const bool live = tid < S;
  const int s = live ? tid : 0;
  const float* th = a.theta_t + static_cast<long long>(row) * P * S + s;
  const float k = th[0], m = th[S];
  const float sigma = expf(th[2 * S]);
  const float lam = a.lam[static_cast<long long>(row) * S + s];
  const float cp = a.cp[row];
  // The path's sums: 0 (linear), or the offset recursion's after the
  // history's changepoints (logistic).
  float c = 0.0f, d = 0.0f;
  if constexpr (kLogi) {
    float kp = k;
    for (int j = 0; j < ncp; ++j)
      logistic_step(k, m, s_row[j], th[(3 + j) * S], c, kp, d);
  }
  // The deterministic trend's walk: n active changepoints and their prefix
  // sums, D_n and E_n (linear), or D_n and G_n, the recursion's running
  // sums of deltas and gammas, with its k_prev (logistic, in D, E, kp_det).
  int n = 0;
  float D = 0.0f, E = 0.0f, kp_det = k;
  const float sc = a.y_scale[row], fl = a.floor_[row];
  const uint32_t crow = a.rows != nullptr
                            ? static_cast<uint32_t>(a.rows[row])
                            : static_cast<uint32_t>(a.row0 + row);
  const Rule r_lo = quantile_rule(a.q_lo, S), r_hi = quantile_rule(a.q_hi, S);
  const float* xs_row = a.xs + static_cast<long long>(row) * a.xs_bstride;
  const float n_draws = static_cast<float>(S);

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nst = min(TT, T - t0);
    for (int j = 0; j < nst; ++j) {
      const int i = t0 + j;
      const long long cell = static_cast<long long>(row) * T + i;
      uint32_t ky = 0xffffffffu, kt = 0xffffffffu;  // min's neutral
      uint32_t ky_hi = 0u, kt_hi = 0u;              // max's neutral
      if (live) {
        const float tv = a.t[cell];
        float g;
        if constexpr (kGrowth == kLinear) {
          const int nn = active_changepoints(tv, s_row, ncp, n);
          if (nn < n) {
            n = 0;
            D = E = 0.0f;
          }
          for (; n < nn; ++n)
            linear_prefix_step(D, E, th[(3 + n) * S], s_row[n]);
          g = linear_trend(tv, segment_line(k, m, D, E));
        } else if constexpr (kLogi) {
          const int nn = active_changepoints_at(tv, s_row, ncp, n);
          if (nn < n) {
            n = 0;
            D = E = 0.0f;
            kp_det = k;
          }
          for (; n < nn; ++n)
            logistic_step(k, m, s_row[n], th[(3 + n) * S], D, kp_det, E);
          g = logistic_at(tv, a.cap[cell], k, m, D, E);
        } else {
          g = m;
        }
        float add, mult;
        feature_totals_cell(
            xs_row + static_cast<long long>(i) * a.Fs, a.Fs,
            a.xr + cell * a.R, a.R,
            [&](int f, float& ca, float& cm) {
              split_coefficient(th[(3 + ncp + f) * S], mm[f], ca, cm);
            },
            add, mult);
        const float dety = g * (1.0f + mult) + add;
        float u, lap, z;
        if (a.du != nullptr) {
          const long long di =
              (static_cast<long long>(s) * a.B + row) * T + i;
          u = a.du[di];
          lap = a.dlap[di];
          z = a.dz[di];
        } else {
          const Variates v =
              philox_variates(static_cast<uint32_t>(i),
                              static_cast<uint32_t>(s), crow, kStream, a.k0,
                              a.k1);
          u = v.u;
          lap = v.lap;
          z = v.z;
        }
        const float tr = path_step<kLogi>(kGrowth, tv, a.cap + cell, g, u, lap,
                                          cp, lam, k, m, c, d);
        const float smp = tr * (1.0f + mult) + add + z * sigma;
        if (a.samples != nullptr)
          a.samples[(static_cast<long long>(s) * a.B + row) * T + i] =
              __fadd_rn(__fmul_rn(smp, sc), fl);
        vals[(0 * TT + j) * S + s] = dety;
        vals[(1 * TT + j) * S + s] = g;
        vals[(2 * TT + j) * S + s] = add;
        vals[(3 * TT + j) * S + s] = mult;
        ky = ky_hi = order_key(smp);
        kt = kt_hi = order_key(tr);
        keys[(2 * j) * S + s] = ky;
        keys[(2 * j + 1) * S + s] = kt;
      }
      ky = __reduce_min_sync(kFull, ky);
      ky_hi = __reduce_max_sync(kFull, ky_hi);
      kt = __reduce_min_sync(kFull, kt);
      kt_hi = __reduce_max_sync(kFull, kt_hi);
      if (lane == 0) {
        uint32_t* pj = parts + (2 * j) * 2 * nwarps;
        pj[2 * warp] = ky;
        pj[2 * warp + 1] = ky_hi;
        pj[2 * (nwarps + warp)] = kt;
        pj[2 * (nwarps + warp) + 1] = kt_hi;
      }
    }
    __syncthreads();
    // The means: a thread a column, its S values summed in ascending s.
    for (int col = tid; col < 4 * nst; col += nt) {
      const int q = col / nst, j = col - q * nst;
      const float* v = vals + (q * TT + j) * S;
      float acc = 0.0f;
      for (int r = 0; r < S; ++r) acc = acc + v[r];
      const float mean = acc / n_draws;
      const long long cell = static_cast<long long>(row) * T + t0 + j;
      if (q == 0)
        a.yhat[cell] = __fadd_rn(__fmul_rn(mean, sc), fl);
      else if (q == 1)
        a.trend[cell] = __fadd_rn(__fmul_rn(mean, sc), fl);
      else if (q == 2)
        a.add[cell] = __fmul_rn(mean, sc);
      else
        a.mult[cell] = mean;
    }
    // The quantiles: a warp a key column.
    for (int col = warp; col < 2 * nst; col += nwarps) {
      const uint32_t* pc = parts + col * 2 * nwarps;
      const bool has = lane < nwarps;
      const uint32_t mn =
          __reduce_min_sync(kFull, has ? pc[2 * lane] : 0xffffffffu);
      const uint32_t mx = __reduce_max_sync(kFull, has ? pc[2 * lane + 1] : 0u);
      float lo, hi;
      select_column(keys + col * S, S, mn, mx, r_lo, r_hi, hist, cand, lane,
                    lo, hi);
      if (lane == 0) {
        const long long cell =
            static_cast<long long>(row) * T + t0 + (col >> 1);
        float* dlo = (col & 1) ? a.tr_lo : a.y_lo;
        float* dhi = (col & 1) ? a.tr_hi : a.y_hi;
        dlo[cell] = __fadd_rn(__fmul_rn(lo, sc), fl);
        dhi[cell] = __fadd_rn(__fmul_rn(hi, sc), fl);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// theta_t: each row's S draws parameter-major, (B, P, S).  cap: (B, T)
// for logistic growth, else null.  rows: (B,) Philox row ids, or null for
// row0 + the row's index.  samples: (S, B, T) or null.
extern "C" int tsspark_draws(
    const float* theta_t, const float* t, const float* s, const float* cap,
    const float* xs, long long xs_bstride, const float* xr, const float* mm,
    const float* cp, const float* lam, const float* y_scale,
    const float* floor_, const float* du, const float* dlap, const float* dz,
    const int* rows, long long row0, unsigned long long seed, float q_lo,
    float q_hi, float* yhat, float* trend, float* add, float* mult,
    float* y_lo, float* y_hi, float* tr_lo, float* tr_hi, float* samples,
    int B, int T, int P, int ncp, int Fs, int R, int S, int growth,
    void* stream) {
  if (B == 0 || T == 0) return 0;
  if (S < 1 || S > kMaxSamples || (growth == kLogistic && cap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DrawArgs a;
  a.theta_t = theta_t;
  a.t = t;
  a.s = s;
  a.cap = cap;
  a.xs = xs;
  a.xs_bstride = xs_bstride;
  a.xr = xr;
  a.mm = mm;
  a.cp = cp;
  a.lam = lam;
  a.y_scale = y_scale;
  a.floor_ = floor_;
  a.du = du;
  a.dlap = dlap;
  a.dz = dz;
  a.rows = rows;
  a.row0 = row0;
  a.k0 = static_cast<uint32_t>(seed);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.yhat = yhat;
  a.trend = trend;
  a.add = add;
  a.mult = mult;
  a.y_lo = y_lo;
  a.y_hi = y_hi;
  a.tr_lo = tr_lo;
  a.tr_hi = tr_hi;
  a.samples = samples;
  a.B = B;
  a.T = T;
  a.P = P;
  a.ncp = ncp;
  a.Fs = Fs;
  a.R = R;
  a.S = S;
  a.TT = tile_steps(S, T);
  const int nt = S < 32 ? 32 : (S + 31) & ~31;
  const size_t shmem = smem_bytes(S, nt, a.TT, ncp, Fs + R);
  if (shmem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<B, nt, shmem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  };
  if (growth == kLinear) return launch(draws_kernel<kLinear>);
  if (growth == kLogistic) return launch(draws_kernel<kLogistic>);
  return launch(draws_kernel<kFlat>);
}
