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
//   add_s, mult_s = feature totals        feature_totals_steps' order
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
// the draws once and writing eight (B, T) outputs.  So the design keeps
// loads out of the cell loop.
//
// Design: one block a row, a thread a draw (S <= 1,024), the block's
// thread cap a template argument (384 for S <= 384, else 1,024) so the
// register budget follows the threads launched.  A draw's parameters stay
// in device memory in the wrapper's (B, P, S) layout (a warp's loads of one
// parameter coalesced); its changepoint walk state and path sums live in
// registers.  Its F split coefficients (additive and multiplicative, a
// float2 a feature) are computed once for the row into a shared-memory
// table laid out (F, S), conflict-free; where S and F are too large for the
// table beside the tiles, the features past those it holds are split from
// device memory for every four cells.  Steps go in tiles of TT: the
// tile's t, capacity, seasonal (TT x Fs) and regressor (TT x R) cells are
// staged into shared memory by cp.async once for the block (the next
// tile's while the last one is summed and selected), the feature cells
// transposed, and read by every draw as broadcasts.  A draw first takes
// its feature totals of the tile's steps four at a time (each
// coefficient read once for four cells, the four cells of a feature one
// 16-byte broadcast; the last steps one at a time) into its columns of
// the tile's add and mult values, then walks the steps, writing its
// deterministic yhat and trend and its sample's and trend's order keys to
// shared memory, each warp its share of every key column's min and max;
// after a block barrier a thread sums each mean column in order and a
// warp selects each key column, and a second barrier frees the buffers
// for the next tile.
// TT is the largest tile (at most 32 steps) that leaves room for two
// blocks a multiprocessor, or else one.
//   Where the time goes (H100, config 3's 512 x 1941 chunk at S = 300,
// PERF.md): the simulation about 60%, the selection most of the rest.
// The issue rate bounds the simulation (Philox, the transcendentals and
// the feature loop are some 300 instructions a sample-cell); the table
// cut its feature loop to two shared-memory loads and two multiply-adds a
// feature.  The selection is K2's, latency-bound at one warp a column
// with the other block's simulation beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "prophet_model.cuh"
#include "sampling.cuh"

namespace {

using namespace tsspark;
using namespace tsspark::sampling;

constexpr int kMaxSamples = 1024;         // a thread a draw
constexpr int kSmallCap = 384;            // thread cap for S <= 384
constexpr int kMaxTile = 32;              // steps a tile
// A block's shared memory where two fit on a multiprocessor (its 228 KB,
// 1 KB of each block reserved).
constexpr int kTwoBlockBytes = 113 * 1024;
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
  int B, T, P, ncp, Fs, R, S, TT, Fc;
};

// A block's shared memory, in 4-byte words: the tile's values [4][TT][S]
// and keys [TT][2][S], the key columns' per-warp min and max
// [TT][2][nwarps][2], each warp's histogram and candidates (16-byte
// aligned: read four bins at a time), the coefficient table [Fc][S] of
// float2, the tile's staged cells (t and capacity, seasonal [Fs][tt4] and
// regressor [R][tt4] transposed; tt4 = TT rounded up to 4, so a
// feature's four steps are one aligned 16-byte load), the row's
// changepoints and the multiplicative mask.
struct DrawPlan {
  int tt4, keys, parts, hist, cand, coef, t, cap, xs, xr, s_row, mm, total;
  __host__ __device__ DrawPlan(int S, int nwarps, int TT, int Fc, int ncp,
                               int Fs, int R) {
    tt4 = round4(TT);
    keys = 4 * TT * S;
    parts = keys + 2 * TT * S;
    hist = round4(parts + 4 * TT * nwarps);
    cand = hist + nwarps * kBins;
    coef = round4(cand + nwarps * 2 * kCand);
    t = coef + 2 * Fc * S;
    cap = t + tt4;
    xs = cap + tt4;
    xr = xs + tt4 * Fs;
    s_row = xr + tt4 * R;
    mm = s_row + ncp;
    total = mm + Fs + R;
  }
};

size_t plan_bytes(int S, int nwarps, int TT, int Fc, int ncp, int Fs, int R) {
  return 4 * static_cast<size_t>(
                 DrawPlan(S, nwarps, TT, Fc, ncp, Fs, R).total);
}

// The tile TT and the coefficients held in shared memory Fc: every
// coefficient and the largest tile within two blocks a multiprocessor, or
// else within one; else a one-step tile and as many coefficients as fit.
// False if not even that fits.
bool choose_plan(int S, int nwarps, int T, int ncp, int Fs, int R, int& TT,
                 int& Fc) {
  const int F = Fs + R;
  const int tmax = T < kMaxTile ? T : kMaxTile;
  const int budgets[2] = {kTwoBlockBytes, kMaxSmemBytes};
  for (const int budget : budgets) {
    for (int tt = tmax; tt >= 1; --tt) {
      if (plan_bytes(S, nwarps, tt, F, ncp, Fs, R) <= budget) {
        TT = tt;
        Fc = F;
        return true;
      }
    }
  }
  TT = 1;
  for (Fc = F - 1; Fc >= 0; --Fc)
    if (plan_bytes(S, nwarps, 1, Fc, ncp, Fs, R) <= kMaxSmemBytes)
      return true;
  return false;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage the cells of steps t0 .. t0 + nst - 1 of one row into shared
// memory (each thread its share, 4 bytes a copy): t, the capacity
// (logistic growth), and the seasonal and regressor values transposed,
// step j of column f at f tt4 + j.
template <bool kLogi>
__device__ __forceinline__ void stage_cells(const DrawArgs& a, int row,
                                            int t0, int nst, int tt4,
                                            float* t_st, float* cap_st,
                                            float* xs_st, float* xr_st) {
  const long long cell0 = static_cast<long long>(row) * a.T + t0;
  const float* xs0 = a.xs + static_cast<long long>(row) * a.xs_bstride +
                     static_cast<long long>(t0) * a.Fs;
  const float* xr0 = a.xr + cell0 * a.R;
  const int n_cap = kLogi ? nst : 0;
  const int n_xs = nst * a.Fs;
  const int total = nst + n_cap + n_xs + nst * a.R;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    if (q < nst) {
      cp_async4(t_st + q, a.t + cell0 + q);
    } else if (q < nst + n_cap) {
      cp_async4(cap_st + (q - nst), a.cap + cell0 + (q - nst));
    } else if (q < nst + n_cap + n_xs) {
      const int k = q - nst - n_cap, j = k / a.Fs;
      cp_async4(xs_st + (k - j * a.Fs) * tt4 + j, xs0 + k);
    } else {
      const int k = q - nst - n_cap - n_xs, j = k / a.R;
      cp_async4(xr_st + (k - j * a.R) * tt4 + j, xr0 + k);
    }
  }
}

// Two blocks a multiprocessor under the small cap (at most 80 registers a
// thread), so one block's selection runs beside the other's simulation.
template <int kGrowth, int kCap>
__global__ void __launch_bounds__(kCap, kCap == kSmallCap ? 2 : 1)
    draws_kernel(DrawArgs a) {
  extern __shared__ __align__(16) uint32_t sh[];
  constexpr bool kLogi = kGrowth == kLogistic;
  const int S = a.S, T = a.T, TT = a.TT, ncp = a.ncp, P = a.P;
  const int Fs = a.Fs, R = a.R, F = Fs + R, Fc = a.Fc;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DrawPlan pl(S, nwarps, TT, Fc, ncp, Fs, R);
  const int tt4 = pl.tt4;
  float* vals = reinterpret_cast<float*>(sh);  // [4][TT][S]
  uint32_t* keys = sh + pl.keys;               // [TT][2][S]
  uint32_t* parts = sh + pl.parts;             // [TT][2][nwarps][2]
  int* hist = reinterpret_cast<int*>(sh + pl.hist) + warp * kBins;
  uint32_t* cand = sh + pl.cand + warp * 2 * kCand;
  float2* coef = reinterpret_cast<float2*>(sh + pl.coef);  // [Fc][S]
  float* t_st = reinterpret_cast<float*>(sh + pl.t);
  float* cap_st = reinterpret_cast<float*>(sh + pl.cap);
  float* xs_st = reinterpret_cast<float*>(sh + pl.xs);
  float* xr_st = reinterpret_cast<float*>(sh + pl.xr);
  float* s_row = reinterpret_cast<float*>(sh + pl.s_row);
  float* mm = reinterpret_cast<float*>(sh + pl.mm);

  const int row = blockIdx.x;
  stage_cells<kLogi>(a, row, 0, min(TT, T), tt4, t_st, cap_st, xs_st, xr_st);
  for (int j = tid; j < ncp; j += nt)
    s_row[j] = a.s[static_cast<long long>(row) * ncp + j];
  for (int f = tid; f < F; f += nt) mm[f] = a.mm[f];
  __syncthreads();

  const bool live = tid < S;
  const int s = live ? tid : 0;
  const float* th = a.theta_t + static_cast<long long>(row) * P * S + s;
  // The draw's split coefficients, once for the row: its own column of
  // the table.
  if (live) {
    for (int f = 0; f < Fc; ++f) {
      float2 cf;
      split_coefficient(th[(3 + ncp + f) * S], mm[f], cf.x, cf.y);
      coef[f * S + s] = cf;
    }
  }
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
  const float n_draws = static_cast<float>(S);
  cp_async_wait_all();
  __syncthreads();

  // The feature totals of one draw's C steps j0 .. j0 + C - 1 of a tile
  // into its columns of the tile's add and mult values.  Every
  // coefficient from the table where it holds them all (a test of f < Fc
  // inside the feature loop cost the simulation a quarter of its time on
  // the H100).
  const auto table = [&](int f, float& ca, float& cm) {
    const float2 cf = coef[f * S + s];
    ca = cf.x;
    cm = cf.y;
  };
  float* add_col = vals + 2 * TT * S + s;
  float* mult_col = vals + 3 * TT * S + s;
  const auto totals = [&](auto steps, int j0) {
    constexpr int C = decltype(steps)::value;
    float add[C], mult[C];
    if (Fc == F) {
      feature_totals_steps<C>(xs_st + j0, Fs, xr_st + j0, R, tt4, table, add,
                              mult);
    } else {
      feature_totals_steps<C>(
          xs_st + j0, Fs, xr_st + j0, R, tt4,
          [&](int f, float& ca, float& cm) {
            if (f < Fc)
              table(f, ca, cm);
            else
              split_coefficient(th[(3 + ncp + f) * S], mm[f], ca, cm);
          },
          add, mult);
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      add_col[(j0 + q) * S] = add[q];
      mult_col[(j0 + q) * S] = mult[q];
    }
  };

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nst = min(TT, T - t0);
    if (live) {
      int j0 = 0;
      for (; j0 + 4 <= nst; j0 += 4)
        totals(std::integral_constant<int, 4>(), j0);
      for (; j0 < nst; ++j0) totals(std::integral_constant<int, 1>(), j0);
    }
    for (int j = 0; j < nst; ++j) {
      const int i = t0 + j;
      uint32_t ky = 0xffffffffu, kt = 0xffffffffu;  // min's neutral
      uint32_t ky_hi = 0u, kt_hi = 0u;              // max's neutral
      if (live) {
        const float tv = t_st[j];
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
          g = logistic_at(tv, cap_st[j], k, m, D, E);
        } else {
          g = m;
        }
        const float add = add_col[j * S];
        const float mult = mult_col[j * S];
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
        const float tr = path_step<kLogi>(kGrowth, tv, cap_st + j, g, u, lap,
                                          cp, lam, k, m, c, d);
        const float smp = tr * (1.0f + mult) + add + z * sigma;
        if (a.samples != nullptr)
          a.samples[(static_cast<long long>(s) * a.B + row) * T + i] =
              __fadd_rn(__fmul_rn(smp, sc), fl);
        vals[(0 * TT + j) * S + s] = dety;
        vals[(1 * TT + j) * S + s] = g;
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
    // Every draw is past the tile's cells: stage the next tile's.
    if (t0 + TT < T)
      stage_cells<kLogi>(a, row, t0 + TT, min(TT, T - t0 - TT), tt4, t_st,
                         cap_st, xs_st, xr_st);
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
    cp_async_wait_all();
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
  const int nt = S < 32 ? 32 : (S + 31) & ~31;
  if (!choose_plan(S, nt / 32, T, ncp, Fs, R, a.TT, a.Fc))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t shmem = plan_bytes(S, nt / 32, a.TT, a.Fc, ncp, Fs, R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // Room for two blocks a multiprocessor where they fit.
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    kernel<<<B, nt, shmem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  };
  if (nt <= kSmallCap) {
    if (growth == kLinear) return launch(draws_kernel<kLinear, kSmallCap>);
    if (growth == kLogistic) return launch(draws_kernel<kLogistic, kSmallCap>);
    return launch(draws_kernel<kFlat, kSmallCap>);
  }
  if (growth == kLinear) return launch(draws_kernel<kLinear, kMaxSamples>);
  if (growth == kLogistic) return launch(draws_kernel<kLogistic, kMaxSamples>);
  return launch(draws_kernel<kFlat, kMaxSamples>);
}
