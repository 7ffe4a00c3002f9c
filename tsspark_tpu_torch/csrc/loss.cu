// K3 `loss`: the MAP objective of every series row, and its gradient.
//
// Replaces the XLA-fused loss and reverse pass of the JAX package (it has
// no Pallas kernel; jax.vjp of the loss was left to XLA's fusion):
//   tsspark_tpu/models/prophet/loss.py  neg_log_posterior, value_batch,
//                                       value_and_grad_batch
//
// Per row i, on data row b = i % B (so an (N*B, P) stack of trial points
// reuses the (B, T) data), with sigma = 1e-5 + exp(log_sigma):
//   yhat_t = trend_t * (1 + mult_t) + add_t          (prophet_model.cuh)
//   r_t    = (y_t - yhat_t) * mask_t
//   f      = 0.5 * sum r^2 / sigma^2 + n_obs * log(sigma)
//            + 0.5 (k/k_s)^2 + 0.5 (m/m_s)^2 + 0.5 (sigma/sigma_s)^2
//            + sum_j smooth_abs(delta_j) / cp_s + 0.5 sum_f (beta_f/p_f)^2
// and, in gradient mode, with w_t = r_t * mask_t / sigma^2 (= -df/dyhat_t)
// and u_t = w_t (1 + mult_t):
//   df/dk       = -sum u t                            + k / k_s^2
//   df/dm       = -sum u                              + m / m_s^2
//   df/ddelta_j = -sum_{t > s_j} u (t - s_j)          + smooth_abs'(delta_j)/cp_s
//   df/dbeta_f  = -sum w ((1 - mm_f) + mm_f trend) x_f + beta_f / p_f^2
//   df/dlog_sig = e^ls (-sum r^2 / sigma^3 + n_obs / sigma + sigma / sigma_s^2)
// (flat growth: trend = m, and k and delta see only their priors).
// Linear and flat growth; logistic growth is refused by the wrapper.
//
// What bounds it: bytes.  A row reads t, y, mask and its R regressor
// columns (six floats a cell for config 3: 343 MB at 8192 x 1746, 0.10 ms
// at 3.35 TB/s); the (T, Fs) seasonal matrix is shared by every row.  In
// practice the issue rate binds first (PERF.md), so the design spends
// shared memory and a copy engine to take address arithmetic and copy
// instructions off the row warps, and registers to keep every sum.  At 16
// to 24 seasonal columns the gradient mode needs more than the 128
// registers a thread of two blocks a multiprocessor (ptxas spills), so it
// runs one block a multiprocessor there (min_blocks).
//
// Design.  A block is kRowWarps = 7 row warps, one row each (a compile-time
// constant; rows past N are masked), and one producer warp.  The producer
// keeps a kStages-deep ring of T tiles (128 cells; 32 for a per-series
// seasonal matrix) in flight with Hopper's bulk copy engine (TMA,
// cp.async.bulk): lane w copies row w's t, y, mask and regressor cells as
// whole 16-byte pieces, lane 31 the tile's (tile x Fs) seasonal slice ONCE
// for all seven rows (per series: each row lane its own slice).  A stage's
// `full` mbarrier counts the bytes; its `empty` mbarrier the rows done with
// it.  Row warps wait for data only: no block-wide barrier after set-up.
// Lane l of a row takes the cells l, l + 32, l + 64, ... in ascending
// order, whatever the tile size.
//   Every sum stays in the lane's registers for the whole walk over T:
// sum r^2, n_obs, sum u, sum u t and one gradient sum per seasonal column
// (the columns are unrolled to kFs, the next of 8, 16, 24, 32, 48, 64 at
// or above Fs; columns past Fs carry zero coefficients and read the staged
// slice's finite neighbours; regressors go four at a time the same way,
// their sums in the lane's shared-memory slots).  The changepoint terms
// cost O(1) a cell: the trend is taken in the prefix form of
// prophet_model.cuh, each lane carrying its segment n(t) along its
// ascending cells.  For the gradient, t rises along the row, so the cells
// past changepoint j are the suffix after its boundary:
//   sum_{t > s_j} u (t - s_j) = (U - U_j) - s_j (V - V_j),
// U, V = sum u, sum u t over the row, U_j, V_j the same sums over the
// cells before boundary j, taken (a warp sum) in the step that crosses
// it.  df/dk and df/dm are V and U.  Value mode does none of the gradient
// work.
//   Reduction order: each lane adds its cells in ascending order; the
// slots are added over the 32 lanes in lane order, the register sums by a
// fixed shuffle tree; nothing is atomic.  The order depends only on T,
// the row's own t and s, and the constants above, so a row's loss and
// gradient are the same bits at any batch width, at any place in the
// batch and in a trial stack (the solver's compaction relies on that).
// Precision is float32 throughout; no tensor cores.
//
// Limits (the wrapper raises ValueError past them): an even Fs of at
// most 64 (Fourier columns come in sin/cos pairs), and a shared-memory
// plan within the card's 227 KB per block; t, y, mask, the seasonal and
// regressor matrices start on 16-byte boundaries (the wrapper copies them
// if not).

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

// Shared-memory plan of one block, in floats (the stages' mbarriers come
// first, 2 floats each).  Per warp: theta, s, the prefix sums D and E, the
// seasonal coefficients (additive, multiplicative, 1 - mm, mm; kFs each,
// zero past Fs), the same four for the regressors (zero past R, to a
// multiple of 4), the boundary snapshots, the row's column sums and the
// prior scales.  Per stage: each row's t, y, mask and regressor cells and
// the seasonal slice(s), each with 8 floats of room for the 16-byte
// pieces around them.  Gradient mode: each lane's regressor sums.
struct Plan {
  StageLayout sl;
  int R4, th, s, D, E, ba, bm, om, mm, bar, bmr, omr, mmr, snu, snv, res,
      ps, row, rows0, racc, total;
  __host__ __device__ Plan(bool grad, int kFs, int P, int ncp, int Fs, int R,
                           bool per_series)
      : sl(kFs, Fs, R, per_series) {
    R4 = round4(R);
    th = 0;
    s = th + round4(P);
    D = s + round4(ncp);
    E = D + round4(ncp + 1);
    ba = E + round4(ncp + 1);
    bm = ba + kFs;
    om = bm + kFs;
    mm = om + kFs;
    bar = mm + kFs;
    bmr = bar + R4;
    omr = bmr + R4;
    mmr = omr + R4;
    snu = mmr + R4;
    snv = snu + round4(ncp);
    res = snv + round4(ncp);
    ps = res + round4(R + kFs + 2);
    row = ps + round4(Fs + R);
    rows0 = 4 * kStages;
    racc = grad ? R4 * kPipeThreads : 0;
    total = rows0 + kRowWarps * row + kStages * sl.size + racc;
  }
};

// Blocks a multiprocessor the register budget is cut for: two (128
// registers a thread) where the kernel fits in them without spilling, one
// where ptxas would spill (-Xptxas -v, printed by chip_smoke.py).
constexpr int min_blocks(bool grad, int kFs) {
  return kFs <= 24 && !(grad && kFs >= 16) ? 2 : 1;
}

template <bool kGrad, int kFs>
__global__ void __launch_bounds__(kPipeThreads, min_blocks(kGrad, kFs))
    loss_kernel(
    const float* __restrict__ theta,  // (N, P); row i uses data row i % B
    const float* __restrict__ t,      // (B, T), ascending along T
    const float* __restrict__ y,      // (B, T)
    const float* __restrict__ mask,   // (B, T)
    const float* __restrict__ s,      // (B, ncp), ascending
    const float* __restrict__ xs,     // (T, Fs) or (B, T, Fs)
    long long xs_bstride,             // 0 (shared) or T * Fs
    const float* __restrict__ xr,     // (B, T, R)
    const float* __restrict__ ps,     // (F,) feature prior scales
    const float* __restrict__ mm,     // (F,) multiplicative mask
    float* __restrict__ f_out,        // (N,)
    float* __restrict__ g_out,        // (N, P), gradient mode only
    int N, int B, int T, int P, int ncp, int Fs, int R, int growth,
    float k_scale, float m_scale, float sigma_scale, float cp_scale) {
  extern __shared__ __align__(16) float sh[];
  const bool per_series = xs_bstride != 0;
  const Plan pl(kGrad, kFs, P, ncp, Fs, R, per_series);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowWarps;
  const int nlive =
      static_cast<int>(min(static_cast<long long>(kRowWarps), N - row0));
  const bool live = warp < kRowWarps && i < N;
  const long long b = live ? i % B : 0;
  const int F = Fs + R;
  const int R4 = pl.R4;
  const bool linear = growth == kLinear;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sh);
  float* rp = sh + pl.rows0 + warp * pl.row;
  float* r_th = rp + pl.th;
  float* r_s = rp + pl.s;
  float* r_D = rp + pl.D;
  float* r_E = rp + pl.E;
  float* r_ba = rp + pl.ba;
  float* r_bm = rp + pl.bm;
  float* r_om = rp + pl.om;
  float* r_mm = rp + pl.mm;
  float* r_bar = rp + pl.bar;
  float* r_bmr = rp + pl.bmr;
  float* r_omr = rp + pl.omr;
  float* r_mmr = rp + pl.mmr;
  float* r_snu = rp + pl.snu;
  float* r_snv = rp + pl.snv;
  float* r_res = rp + pl.res;
  float* r_ps = rp + pl.ps;
  float* stages = sh + pl.rows0 + kRowWarps * pl.row;
  float4* racc = reinterpret_cast<float4*>(stages + kStages * pl.sl.size) + tid;

  if (live) {
    const float* th = theta + i * P;
    for (int j = lane; j < P; j += 32) r_th[j] = th[j];
    for (int j = lane; j < ncp; j += 32) r_s[j] = s[b * ncp + j];
    for (int f = lane; f < F; f += 32) r_ps[f] = ps[f];
    for (int f = lane; f < kFs; f += 32) {
      const bool in = f < Fs;
      const float be = in ? th[3 + ncp + f] : 0.0f;
      const float mf = in ? mm[f] : 0.0f;
      r_ba[f] = be * (1.0f - mf);
      r_bm[f] = be * mf;
      r_om[f] = in ? 1.0f - mf : 0.0f;
      r_mm[f] = mf;
    }
    for (int r = lane; r < R4; r += 32) {
      const bool in = r < R;
      const float be = in ? th[3 + ncp + Fs + r] : 0.0f;
      const float mf = in ? mm[Fs + r] : 0.0f;
      r_bar[r] = be * (1.0f - mf);
      r_bmr[r] = be * mf;
      r_omr[r] = in ? 1.0f - mf : 0.0f;
      r_mmr[r] = mf;
    }
  }
  // Zero the stages (the pads past a staged slice must hold finite
  // values) and the regressor sums.
  for (int j = tid; j < kStages * pl.sl.size + pl.racc; j += kPipeThreads)
    stages[j] = 0.0f;
  pipeline_init(bars, nlive, per_series);
  const bool has_mult = any_multiplicative(mm, F);
  __syncwarp();
  if (live && linear && lane == 0) linear_prefix(r_s, r_th + 3, r_D, r_E, ncp);
  fence_async_shared();
  __syncthreads();

  const int ntiles = (T + pl.sl.tile - 1) / pl.sl.tile;
  if (warp == kRowWarps) {
    produce_tiles(stages, pl.sl, bars, nlive, row0, B, T, R, Fs, t, y, mask,
                  xr, xs, xs_bstride);
    return;
  }
  if (!live) return;

  // k, m and sigma are read again after the walk: the walk keeps only
  // 1 / sigma^2 and the lane's segment line in registers.
  const float inv_s2 = 1.0f / sq(sigma_of(r_th[2]));
  const float inf = __int_as_float(0x7f800000);

  float ssr = 0.0f, nobs = 0.0f;
  float TU = 0.0f, TV = 0.0f;  // the lane's sum u and sum u t
  float acc[kFs];              // seasonal gradient sums
#pragma unroll
  for (int f = 0; f < kFs; ++f) acc[f] = 0.0f;
  int nl = 0;  // the lane's active changepoints, n(t) of its last cell
  int q = 0;   // boundaries the row's walk has passed
  float s_lo = -inf;
  float s_hi = ncp > 0 ? r_s[0] : inf;
  Line line = segment_line(r_th[0], r_th[1], 0.0f, 0.0f);

  for (int it = 0; it < ntiles; ++it) {
    mbar_wait(bars + it % kStages, (it / kStages) & 1);
    const int t0 = it * pl.sl.tile;
    const int n = min(pl.sl.tile, T - t0);
    const long long c0 = b * T + t0;
    const float* st = stages + (it % kStages) * pl.sl.size;
    const float* rows = st + warp * pl.sl.row;
    const float* tp = rows + pl.sl.t + (c0 & 3);
    const float* yp = rows + pl.sl.y + (c0 & 3);
    const float* mp = rows + pl.sl.m + (c0 & 3);
    const float* rxp = rows + pl.sl.r + ((c0 * R) & 3);
    const float* xp =
        st + pl.sl.x0 + (per_series ? warp * pl.sl.x1 : 0) +
        ((b * xs_bstride + static_cast<long long>(t0) * Fs) & 3);
    for (int step = 0; step < n; step += 32) {
      const int cl = step + lane;
      const bool valid = cl < n;
      float u = 0.0f, uv = 0.0f;
      const float tv = valid ? tp[cl] : 0.0f;
      if (valid) {
        float g = r_th[1];
        if (linear) {
          if (!(tv > s_lo) || tv > s_hi) {
            nl = active_changepoints(tv, r_s, ncp, nl);
            s_lo = nl > 0 ? r_s[nl - 1] : -inf;
            s_hi = nl < ncp ? r_s[nl] : inf;
            line = segment_line(r_th[0], r_th[1], r_D[nl], r_E[nl]);
          }
          g = linear_trend(tv, line);
        }
        // Feature totals: seasonal columns in order, then regressors.
        float xv[kFs];
        const float* xrow = xp + cl * Fs;
#pragma unroll
        for (int f = 0; f < kFs; f += 2) {
          const float2 v = *reinterpret_cast<const float2*>(xrow + f);
          xv[f] = v.x;
          xv[f + 1] = v.y;
        }
        float add_s = 0.0f, mult_s = 0.0f;
#pragma unroll
        for (int f = 0; f < kFs; f += 4) {
          // Gradient mode keeps its registers for the column sums.
          const float4 c = kGrad ? lds4_volatile(r_ba + f)
                                 : *reinterpret_cast<const float4*>(r_ba + f);
          add_s = add_s + c.x * xv[f];
          add_s = add_s + c.y * xv[f + 1];
          add_s = add_s + c.z * xv[f + 2];
          add_s = add_s + c.w * xv[f + 3];
        }
        if (has_mult) {
#pragma unroll
          for (int f = 0; f < kFs; f += 4) {
            const float4 c = lds4_volatile(r_bm + f);
            mult_s = mult_s + c.x * xv[f];
            mult_s = mult_s + c.y * xv[f + 1];
            mult_s = mult_s + c.z * xv[f + 2];
            mult_s = mult_s + c.w * xv[f + 3];
          }
        }
        // Regressors four at a time; columns past R have zero
        // coefficients and read the staged cells' finite neighbours.
        const float* xq = rxp + cl * R;
        float add_r = 0.0f, mult_r = 0.0f;
        for (int r = 0; r < R; r += 4) {
          const float4 c = lds4_volatile(r_bar + r);
          const float x0 = xq[r], x1 = xq[r + 1], x2 = xq[r + 2],
                      x3 = xq[r + 3];
          add_r = add_r + c.x * x0;
          add_r = add_r + c.y * x1;
          add_r = add_r + c.z * x2;
          add_r = add_r + c.w * x3;
          if (has_mult) {
            const float4 e = lds4_volatile(r_bmr + r);
            mult_r = mult_r + e.x * x0;
            mult_r = mult_r + e.y * x1;
            mult_r = mult_r + e.z * x2;
            mult_r = mult_r + e.w * x3;
          }
        }
        const float add = add_s + add_r;
        const float mult = mult_s + mult_r;
        const float yhat = g * (1.0f + mult) + add;
        const float mk = mp[cl];
        const float res = (yp[cl] - yhat) * mk;
        ssr = ssr + res * res;
        nobs = nobs + mk;
        if (kGrad) {
          const float w = res * mk * inv_s2;
          u = w * (1.0f + mult);
          uv = u * tv;
          const float wg = w * g;
          // The cell's seasonal row is read again (volatile: not kept
          // from the forward pass), so the column sums and the row
          // together fit the registers of two blocks a multiprocessor.
          if (has_mult) {
#pragma unroll
            for (int f = 0; f < kFs; f += 4) {
              const float4 o = lds4_volatile(r_om + f);
              const float4 p = lds4_volatile(r_mm + f);
              const float2 x01 = lds2_volatile(xrow + f);
              const float2 x23 = lds2_volatile(xrow + f + 2);
              acc[f] = acc[f] + (o.x * w + p.x * wg) * x01.x;
              acc[f + 1] = acc[f + 1] + (o.y * w + p.y * wg) * x01.y;
              acc[f + 2] = acc[f + 2] + (o.z * w + p.z * wg) * x23.x;
              acc[f + 3] = acc[f + 3] + (o.w * w + p.w * wg) * x23.y;
            }
          } else {
#pragma unroll
            for (int f = 0; f < kFs; f += 2) {
              const float2 x = lds2_volatile(xrow + f);
              acc[f] = acc[f] + w * x.x;
              acc[f + 1] = acc[f + 1] + w * x.y;
            }
          }
          for (int r = 0; r < R; r += 4) {
            const float4 o = lds4_volatile(r_omr + r);
            const float4 p = lds4_volatile(r_mmr + r);
            float4 a = racc[(r >> 2) * kPipeThreads];
            a.x = a.x + (o.x * w + p.x * wg) * xq[r];
            a.y = a.y + (o.y * w + p.y * wg) * xq[r + 1];
            a.z = a.z + (o.z * w + p.z * wg) * xq[r + 2];
            a.w = a.w + (o.w * w + p.w * wg) * xq[r + 3];
            racc[(r >> 2) * kPipeThreads] = a;
          }
        }
      }
      if (kGrad && linear) {
        // Boundaries j crossed in this step (t ascends along the row, so
        // the lanes past boundary j are those with n > j): the row's
        // sums of u and u t before it, all earlier cells and this step's
        // lanes with n <= j, by a fixed shuffle tree.
        const int q_next = __shfl_sync(0xffffffffu, nl, min(n - step, 32) - 1);
        for (int j = q; j < q_next; ++j) {
          const bool before = valid && nl <= j;
          const float su = warp_sum(TU + (before ? u : 0.0f));
          const float sv = warp_sum(TV + (before ? uv : 0.0f));
          if (lane == 0) {
            r_snu[j] = su;
            r_snv[j] = sv;
          }
        }
        q = q_next;
      }
      TU = TU + u;
      TV = TV + uv;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + kStages + it % kStages);
  }

  const float k = r_th[0];
  const float m = r_th[1];
  const float log_sigma = r_th[2];
  const float sigma = sigma_of(log_sigma);
  ssr = warp_sum(ssr);
  nobs = warp_sum(nobs);
  if (kGrad) {
    const float tu = warp_sum(TU);
    const float tv_sum = warp_sum(TV);
    // Regressor sums over the row's 32 lanes in lane order, then the
    // seasonal sums by the shuffle tree: r_res[0 .. R) and [R .. R + kFs).
    __syncwarp();
    for (int r = lane; r < R; r += 32) {
      const float* col = reinterpret_cast<const float*>(
          racc - tid + (r >> 2) * kPipeThreads + warp * 32);
      float v = 0.0f;
      for (int x = 0; x < 32; ++x) v = v + col[4 * x + (r & 3)];
      r_res[r] = v;
    }
#pragma unroll
    for (int f = 0; f < kFs; ++f) {
      const float v = warp_sum(acc[f]);
      if (lane == 0) r_res[R + f] = v;
    }
    if (lane == 0) {
      r_res[R + kFs] = tu;
      r_res[R + kFs + 1] = tv_sum;
    }
    __syncwarp();
    const float TUr = r_res[R + kFs], TVr = r_res[R + kFs + 1];
    float* g = g_out + i * P;
    for (int j = lane; j < ncp; j += 32) {
      // sum_{t > s_j} u (t - s_j): the sums past boundary j (none if the
      // walk never crossed it).
      float data = 0.0f;
      if (linear && j < q)
        data = (TVr - r_snv[j]) - r_s[j] * (TUr - r_snu[j]);
      g[3 + j] = smooth_abs_grad(r_th[3 + j]) / cp_scale - data;
    }
    for (int f = lane; f < F; f += 32) {
      const float p = r_ps[f];
      const float sum = f < Fs ? r_res[R + f] : r_res[f - Fs];
      g[3 + ncp + f] = r_th[3 + ncp + f] / (p * p) - sum;
    }
    if (lane == 0) {
      g[0] = k / (k_scale * k_scale) - (linear ? TVr : 0.0f);
      g[1] = m / (m_scale * m_scale) - TUr;
      const float e = expf(log_sigma);
      g[2] = e * (-ssr / (sigma * sigma * sigma) + nobs / sigma +
                  sigma / (sigma_scale * sigma_scale));
    }
  }
  if (lane == 0) {
    float prior = 0.5f * sq(k / k_scale);
    prior = prior + 0.5f * sq(m / m_scale);
    prior = prior + 0.5f * sq(sigma / sigma_scale);
    float lap = 0.0f;
    for (int j = 0; j < ncp; ++j) lap = lap + smooth_abs(r_th[3 + j]) / cp_scale;
    prior = prior + lap;
    float quad = 0.0f;
    for (int f = 0; f < F; ++f) quad = quad + sq(r_th[3 + ncp + f] / r_ps[f]);
    prior = prior + 0.5f * quad;
    const float nll = 0.5f * ssr / (sigma * sigma) + nobs * logf(sigma);
    f_out[i] = nll + prior;
  }
}

template <bool kGrad, int kFs>
int launch(const float* theta, const float* t, const float* y,
           const float* mask, const float* s, const float* xs,
           long long xs_bstride, const float* xr, const float* ps,
           const float* mm, float* f_out, float* g_out, int N, int B, int T,
           int P, int ncp, int Fs, int R, int growth, float k_scale,
           float m_scale, float sigma_scale, float cp_scale,
           cudaStream_t st) {
  const Plan pl(kGrad, kFs, P, ncp, Fs, R, xs_bstride != 0);
  const size_t bytes = sizeof(float) * static_cast<size_t>(pl.total);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = loss_kernel<kGrad, kFs>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Room for two blocks a multiprocessor where they fit.
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int grid = (N + kRowWarps - 1) / kRowWarps;
  kernel<<<grid, kPipeThreads, bytes, st>>>(
      theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm, f_out, g_out, N, B, T,
      P, ncp, Fs, R, growth, k_scale, m_scale, sigma_scale, cp_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrad>
int dispatch(const float* theta, const float* t, const float* y,
             const float* mask, const float* s, const float* xs,
             long long xs_bstride, const float* xr, const float* ps,
             const float* mm, float* f_out, float* g_out, int N, int B,
             int T, int P, int ncp, int Fs, int R, int growth, float k_scale,
             float m_scale, float sigma_scale, float cp_scale,
             cudaStream_t st) {
#define TSSPARK_LOSS(KF)                                                     \
  return launch<kGrad, KF>(theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm, \
                           f_out, g_out, N, B, T, P, ncp, Fs, R, growth,     \
                           k_scale, m_scale, sigma_scale, cp_scale, st)
  if (Fs <= 8) TSSPARK_LOSS(8);
  if (Fs <= 16) TSSPARK_LOSS(16);
  if (Fs <= 24) TSSPARK_LOSS(24);
  if (Fs <= 32) TSSPARK_LOSS(32);
  if (Fs <= 48) TSSPARK_LOSS(48);
  TSSPARK_LOSS(64);
#undef TSSPARK_LOSS
}

}  // namespace

extern "C" int tsspark_loss(
    const float* theta, const float* t, const float* y, const float* mask,
    const float* s, const float* xs, long long xs_bstride, const float* xr,
    const float* ps, const float* mm, float* f_out, float* g_out, int N,
    int B, int T, int P, int ncp, int Fs, int R, int growth, float k_scale,
    float m_scale, float sigma_scale, float cp_scale, void* stream) {
  if (N == 0) return 0;
  const unsigned long long align = reinterpret_cast<unsigned long long>(t) |
      reinterpret_cast<unsigned long long>(y) |
      reinterpret_cast<unsigned long long>(mask) |
      reinterpret_cast<unsigned long long>(xs) |
      reinterpret_cast<unsigned long long>(xr);
  if (Fs % 2 != 0 || Fs > 64 || (align & 15ull) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_out != nullptr)
    return dispatch<true>(theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm,
                          f_out, g_out, N, B, T, P, ncp, Fs, R, growth,
                          k_scale, m_scale, sigma_scale, cp_scale, st);
  return dispatch<false>(theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm,
                         f_out, nullptr, N, B, T, P, ncp, Fs, R, growth,
                         k_scale, m_scale, sigma_scale, cp_scale, st);
}
