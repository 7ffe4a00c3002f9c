// K1 `forward`: the batched Prophet forward model, one pass over (B, T).
//
// Replaces the XLA-fused forward pass of the JAX package (it has no
// Pallas kernel; every model op was left to XLA's loop fusion):
//   tsspark_tpu/models/prophet/design.py  model_yhat, seasonal_split,
//                                         _component, trend_fn
//   tsspark_tpu/models/prophet/trend.py   piecewise_linear, logistic,
//                                         _logistic_gamma, flat
//
// Per cell (b, t) it computes
//   trend = k*t + m + sum_j delta_j * relu(t - s_j)               (linear)
//           (taken as (k + D_n) t + (m - E_n), prophet_model.cuh)
//         = cap * sigmoid((k + A delta) * (t - (m + A gamma)))   (logistic)
//         = m                                                    (flat)
//   add   = sum_f beta_f (1 - mm_f) x_f,  mult = sum_f beta_f mm_f x_f
//   yhat  = trend * (1 + mult) + add
// in scaled units, or mapped back to data units (yhat*scale + floor,
// trend*scale + floor, add*scale) when y_scale and floor are given.
//
// What bounds it: memory.  A cell reads t (and cap for logistic growth)
// and, for a per-series feature matrix, its F feature values, and
// writes four floats; the arithmetic is ~3 operations per changepoint
// and 2 per feature, far below the card's 67 TFLOP/s float32 rate at
// 3.35 TB/s.
//
// Design.  A block takes kRows series rows, one warp each, over a span of
// kTileSpan tiles of T (32 to 256 steps a tile by T; fewer where wide
// per-series features would leave one block a multiprocessor).  Set-up,
// once a block: each warp stages its row's changepoints and rate changes
// and the per-feature additive and multiplicative coefficients in shared
// memory, and its lane 0 runs the row's recursion over changepoints (the
// linear trend's prefix sums D and E, or the logistic offsets gamma).
// Hopper's bulk copy engine (TMA, the staging helpers K3 uses) copies
// each tile into one of two stages, the next tile while the block
// computes this one: the tile's (tile x Fs) slice of the seasonal matrix
// once for all the block's rows when it is shared (each row's own
// contiguous slice when it is per series), and each row's regressor, t
// (and cap) cells; a stage's mbarrier counts the bytes, and one block
// barrier a tile frees the stage for the tile after next.  A lane takes
// the cells l, l + 32, ... of its row, everything it reads in shared
// memory and the four stores coalesced over the warp, all of its cells of
// the tile at once (each coefficient read once for them): the features two
// at a time where Fs is even (a warp's 8-byte loads at a row stride of Fs = 2
// mod 4 floats touch every bank once), the coefficients as broadcasts,
// and the active changepoint count carried along its ascending cells.
// The sums run in changepoint and feature order, the order of the plain
// PyTorch version, so the outputs are the same bits as a cell-a-thread
// pass taking the same sums.

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

constexpr int kRows = 8;
constexpr int kThreads = 32 * kRows;
constexpr int kTileSpan = 4;  // tiles a block walks
// Blocks a multiprocessor the registers are cut for: three (80
// registers) ran faster on the card than two or four at the 256-step
// tile; at the 32-step tile (one cell a lane, the engine's chunk, whose
// blocks mostly wait for their copies) four ran faster than three.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksOneCell = 4;

// Shared-memory plan of one block, in floats: two mbarriers (4 floats),
// per row its changepoints, rate changes, logistic offsets, additive and
// multiplicative coefficients and prefix sums D and E (each 16-byte
// aligned), then two stages, each the tile's seasonal slice(s), the rows'
// regressor slices and the rows' t (and cap) slices, each slice with 8
// floats of room for the 16-byte pieces around it (one stage where T is
// one tile).
struct Plan {
  int s, delta, gamma, ba, bm, D, E, row, xslot, rslot, tslot, rows, x, r,
      t, stage, total;
  __host__ __device__ Plan(int ncp, int Fs, int R, int T, int TT,
                           bool per_series, bool logistic) {
    s = 0;
    delta = s + round4(ncp);
    gamma = delta + round4(ncp);
    ba = gamma + round4(ncp);
    bm = ba + round4(Fs + R);
    D = bm + round4(Fs + R);
    E = D + round4(ncp + 1);
    row = E + round4(ncp + 1);
    xslot = round4(TT * Fs) + 8;
    rslot = R > 0 ? round4(TT * R) + 8 : 0;
    tslot = (logistic ? 2 : 1) * (round4(TT) + 8);
    rows = 4;
    x = 0;  // within a stage
    r = x + (per_series ? kRows : 1) * xslot;
    t = r + kRows * rslot;
    stage = t + kRows * tslot;
    total = rows + kRows * row + (T > TT ? 2 : 1) * stage;
  }
};

// Steps of a tile: 32, 64, 128 or 256 by T, halved (to 32 at least) while
// a block's plan passes 96 KB, so that two blocks share a multiprocessor.
int tile_for(int T, int ncp, int Fs, int R, bool per_series,
             bool logistic) {
  int tt = T <= 32 ? 32 : (T <= 64 ? 64 : (T <= 128 ? 128 : 256));
  while (tt > 32 &&
         4 * Plan(ncp, Fs, R, T, tt, per_series, logistic).total > 96 * 1024)
    tt >>= 1;
  return tt;
}

// Warp 0, lane w < nrows: row w's copies of tile t0..t0+n into a stage
// (lane 0 also the shared seasonal slice), one arrival on `full`.
__device__ __forceinline__ void stage_tile(
    float* stage, const Plan& pl, unsigned long long* full, long long row0,
    int lane, int B, int T, int Fs, int R, int t0, int n, bool per_series,
    bool logistic, const float* t, const float* cap, const float* xs,
    long long xs_bstride, const float* xr) {
  const long long rb = row0 + lane;
  const long long cells = static_cast<long long>(B) * T;
  const int TT4 = pl.tslot / (logistic ? 2 : 1);
  const bool x_mine = Fs > 0 && (per_series || lane == 0);
  float* xdst = stage + pl.x + (per_series ? lane * pl.xslot : 0);
  float* rdst = stage + pl.r + lane * pl.rslot;
  float* tdst = stage + pl.t + lane * pl.tslot;
  const long long xs_total =
      per_series ? cells * Fs : static_cast<long long>(T) * Fs;
  const Staged px = stage_plan(
      rb * xs_bstride + static_cast<long long>(t0) * Fs, n * Fs, xs_total);
  const Staged pr = stage_plan((rb * T + t0) * R, n * R, cells * R);
  const Staged pt = stage_plan(rb * T + t0, n, cells);
  unsigned bytes = 4u * (logistic ? 2 : 1) * pt.nbulk;
  stage_tail(tdst, t, pt);
  if (logistic) stage_tail(tdst + TT4, cap, pt);
  if (x_mine) {
    stage_tail(xdst, xs, px);
    bytes += 4u * px.nbulk;
  }
  if (R > 0) {
    stage_tail(rdst, xr, pr);
    bytes += 4u * pr.nbulk;
  }
  mbar_arrive_expect(full, bytes);
  fence_proxy_async();
  stage_bulk(tdst, t, pt, full);
  if (logistic) stage_bulk(tdst + TT4, cap, pt, full);
  if (x_mine) stage_bulk(xdst, xs, px, full);
  if (R > 0) stage_bulk(rdst, xr, pr, full);
}

template <int C>  // cells a lane a tile: TT = 32 C
__global__ void __launch_bounds__(kThreads, C == 1 ? kMinBlocksOneCell
                                                   : kMinBlocks)
    forward_kernel(
    const float* __restrict__ theta,    // (B, P)
    const float* __restrict__ t,        // (B, T)
    const float* __restrict__ s,        // (B, ncp), ascending
    const float* __restrict__ cap,      // (B, T), logistic growth only
    const float* __restrict__ xs,       // (T, Fs) or (B, T, Fs)
    long long xs_bstride,               // 0 (shared) or T * Fs
    const float* __restrict__ xr,       // (B, T, R)
    const float* __restrict__ mm,       // (Fs + R,) multiplicative mask
    const float* __restrict__ y_scale,  // (B,) or null
    const float* __restrict__ floor_,   // (B,) or null
    float* __restrict__ yhat, float* __restrict__ trend,
    float* __restrict__ add_out, float* __restrict__ mult_out,
    int B, int T, int P, int ncp, int Fs, int R, int growth) {
  extern __shared__ __align__(16) float sh[];
  constexpr int TT = 32 * C;
  const int F = Fs + R;
  const bool per_series = xs_bstride != 0;
  const bool logistic = growth == kLogistic;
  const Plan pl(ncp, Fs, R, T, TT, per_series, logistic);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(min(static_cast<long long>(kRows),
                                         static_cast<long long>(B) - row0));
  const bool live = warp < nrows;
  const long long b = row0 + warp;
  const int tile0 = blockIdx.y * kTileSpan;
  const int ntiles = min(kTileSpan, (T + TT - 1) / TT - tile0);
  float* rp = sh + pl.rows + warp * pl.row;
  float* r_s = rp + pl.s;
  float* r_delta = rp + pl.delta;
  float* r_gamma = rp + pl.gamma;
  float* r_ba = rp + pl.ba;
  float* r_bm = rp + pl.bm;
  float* r_D = rp + pl.D;
  float* r_E = rp + pl.E;
  float* stages = sh + pl.rows + kRows * pl.row;

  if (threadIdx.x == 0) {
    mbar_init(full, nrows);
    mbar_init(full + 1, nrows);
    fence_async_shared();
  }
  if (live) {
    const float* th = theta + b * P;
    for (int j = lane; j < ncp; j += 32) {
      r_s[j] = s[b * ncp + j];
      r_delta[j] = th[3 + j];
    }
    for (int f = lane; f < F; f += 32) {
      const float be = th[3 + ncp + f];
      const float mf = mm[f];
      r_ba[f] = be * (1.0f - mf);
      r_bm[f] = be * mf;
    }
  }
  __syncthreads();
  if (warp == 0 && lane < nrows)
    stage_tile(stages, pl, full, row0, lane, B, T, Fs, R, tile0 * TT,
               min(TT, T - tile0 * TT), per_series, logistic, t, cap, xs,
               xs_bstride, xr);
  const float k = live ? theta[b * P] : 0.0f;
  const float m = live ? theta[b * P + 1] : 0.0f;
  if (live && lane == 0) {
    if (logistic) logistic_gamma(k, m, r_s, r_delta, r_gamma, ncp);
    if (growth == kLinear) linear_prefix(r_s, r_delta, r_D, r_E, ncp);
  }
  __syncwarp();
  const float sc = y_scale != nullptr && live ? y_scale[b] : 1.0f;
  const float fl = y_scale != nullptr && live ? floor_[b] : 0.0f;
  const int capo = pl.tslot / (logistic ? 2 : 1);
  int nc = 0;  // active changepoints at this lane's last cell
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = (tile0 + it) * TT;
    // The stage the next tile goes to was read by tile it - 1, which
    // every warp finished before the barrier that ended it.
    if (it + 1 < ntiles && warp == 0 && lane < nrows)
      stage_tile(stages + ((it + 1) & 1) * pl.stage, pl, full + ((it + 1) & 1),
                 row0, lane, B, T, Fs, R, t0 + TT, min(TT, T - t0 - TT),
                 per_series, logistic, t, cap, xs, xs_bstride, xr);
    mbar_wait(full + (it & 1), (it >> 1) & 1);
    if (live) {
      const float* st = stages + (it & 1) * pl.stage;
      const int n = min(TT, T - t0);
      // The staged cells start at the slot plus the copy's offset in its
      // first 16-byte piece.
      const long long x_first =
          b * xs_bstride + static_cast<long long>(t0) * Fs;
      const float* xrow0 = st + pl.x + (per_series ? warp * pl.xslot : 0) +
                           static_cast<int>(x_first & 3);
      const float* rrow0 = st + pl.r + warp * pl.rslot +
                           static_cast<int>(((b * T + t0) * R) & 3);
      const float* trow = st + pl.t + warp * pl.tslot +
                          static_cast<int>((b * T + t0) & 3);
      // The lane's cells j = lane + 32 q of the tile, q < C; past n they
      // read stale slots and store nothing.
      float g[C], add[C], mult[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int j = lane + 32 * q;
        const float tv = trow[j];
        if (growth == kLinear) {
          if (j < n) nc = active_changepoints(tv, r_s, ncp, nc);
          g[q] = linear_trend(tv, segment_line(k, m, r_D[nc], r_E[nc]));
        } else if (logistic) {
          g[q] = logistic_trend(tv, trow[capo + j], k, m, r_s, r_delta,
                                r_gamma, ncp);
        } else {
          g[q] = m;
        }
      }
      feature_totals<C>(xrow0 + lane * Fs, Fs, rrow0 + lane * R, R, r_ba,
                        r_bm, add, mult);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int j = lane + 32 * q;
        if (j >= n) continue;
        const long long cell = b * T + t0 + j;
        const float y = g[q] * (1.0f + mult[q]) + add[q];
        if (y_scale != nullptr) {
          yhat[cell] = __fadd_rn(__fmul_rn(y, sc), fl);
          trend[cell] = __fadd_rn(__fmul_rn(g[q], sc), fl);
          add_out[cell] = __fmul_rn(add[q], sc);
        } else {
          yhat[cell] = y;
          trend[cell] = g[q];
          add_out[cell] = add[q];
        }
        mult_out[cell] = mult[q];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Floats of shared memory one block takes (0 past the card's limit).
extern "C" long long tsspark_forward_smem(int T, int ncp, int Fs, int R,
                                          int per_series, int growth) {
  const bool ps = per_series != 0, lg = growth == kLogistic;
  const Plan pl(ncp, Fs, R, T, tile_for(T, ncp, Fs, R, ps, lg), ps, lg);
  return 4ll * pl.total <= kMaxSmemBytes ? pl.total : 0;
}

extern "C" int tsspark_forward(
    const float* theta, const float* t, const float* s, const float* cap,
    const float* xs, long long xs_bstride, const float* xr, const float* mm,
    const float* y_scale, const float* floor_,
    float* yhat, float* trend, float* add_out, float* mult_out,
    int B, int T, int P, int ncp, int Fs, int R, int growth, void* stream) {
  if (B == 0 || T == 0) return 0;
  const bool lg = growth == kLogistic;
  const int TT = tile_for(T, ncp, Fs, R, xs_bstride != 0, lg);
  const Plan pl(ncp, Fs, R, T, TT, xs_bstride != 0, lg);
  const size_t shmem = sizeof(float) * pl.total;
  if (shmem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (T + TT - 1) / TT;
  const dim3 grid((B + kRows - 1) / kRows,
                  (ntiles + kTileSpan - 1) / kTileSpan);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, shmem, st>>>(
        theta, t, s, cap, xs, xs_bstride, xr, mm, y_scale, floor_, yhat,
        trend, add_out, mult_out, B, T, P, ncp, Fs, R, growth);
    return static_cast<int>(cudaGetLastError());
  };
  if (TT == 32) return launch(forward_kernel<1>);
  if (TT == 64) return launch(forward_kernel<2>);
  if (TT == 128) return launch(forward_kernel<4>);
  return launch(forward_kernel<8>);
}

extern "C" const char* tsspark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
