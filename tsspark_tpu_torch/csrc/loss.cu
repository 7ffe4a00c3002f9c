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
// Logistic growth, trend_t = cap_t sigmoid(x_t), x_t = rate_t (t - off_t),
// rate_t = k + sum_{s_j <= t} delta_j, off_t = m + sum_{s_j <= t} gamma_j,
// with v_t = -u_t cap_t sigmoid(x_t) (1 - sigmoid(x_t)) (= df/dx_t):
//   df/dk, df/dm, df/ddelta_j = the pull-back through gamma's recursion
//   (kernels/loss.py _logistic_pullback) of
//     A = sum v (t - off), C = sum v (-rate) and, for each changepoint j,
//     their suffix sums over t >= s_j
//   plus the priors.
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
//   Logistic growth is its own instantiation (kLogistic), so the linear
// and flat ones keep their code, registers and bits.  One lane of a row
// runs the offset recursion (logistic_prefix, prophet_model.cuh) into the
// row's D and G slots; a lane carries its segment n(t) = #{s_j <= t} and
// takes rate = k + D_n and off = m + G_n in O(1) a cell, and the
// producer stages each row's capacity cells beside t.  Gradient mode
// sums A and C where the linear trend sums U and V, with the same
// snapshot at each boundary, so the suffix sums past s_j are A - A_j and
// C - C_j; after the walk one lane runs the recursion's pull-back, last
// changepoint first, in _logistic_pullback's arithmetic.
//   Trial-stack layout (stack_kernel, value mode, N = n B rows with
// n >= 1; the line search's trials of logistic and flat growth): a
// block's row warps take trials of ONE series, kTrialsPerWarp = 3 a warp,
// so a block holds kStackTrials = 21 of them (config 4's line search: all
// of a series' trials in one block).  Series b takes G = ceil(n / 21)
// consecutive blocks, warp w of block x = b G + g the trials 21g + 3w ..
// 21g + 3w + 2 (rows j B + b), so the producer stages one data row a stage
// (lane 0; the shared seasonal slice as in the row layout) for all of
// them, and a launch reads the data from device memory G times (once at
// config 4), where the row layout read it n times.  A lane loads a cell's
// data once and scores its warp's three trials on it: three independent
// chains where the row layout's lane waits on one.  The pass is bound by
// latency, not by bytes (on the H100 a layout of seven trial warps a block
// that read the data three times took as long as the row layout, a ring
// of 4 or 8 stages bought nothing, and one block more a multiprocessor
// cut either by a quarter), so the kernel runs three blocks a
// multiprocessor where its registers allow (kFs <= 24).  Each trial keeps
// its own slot (parameters, prefix sums, split coefficients) and the row
// layout's arithmetic, cell order and shuffle tree, so a row's value is
// the same bits in either layout.
//   Draw-stack layout (draw_kernel in loss_draws.cuh, built by sources of
// its own; gradient mode, N = n B rows with n > 1; ADVI's K draws of
// every series): a warp takes kD = 4 draws of
// ONE series (2 past 32 seasonal columns), so the block's seven row
// warps are seven series, as in the row layout, and the producer stages
// each data row once for its four draws.  Warp w of block x holds unit
// u = 7 x + w: series u % B, draws 4 (u / B) .. 4 (u / B) + 3 (rows
// j B + b).  What held the row layout back here was not the staging but
// the lane's work a cell: its seasonal row read from shared memory twice
// (the forward sum and the column sums) for one row, the coefficients
// once more, and one dependent multiply-add chain.  A lane of this layout
// reads the cell's seasonal values once a pass for all of its warp's
// draws, runs four independent chains, and adds each column pair into
// four draws' sums; the columns past Fs (the bucket's zero columns) are
// skipped, and 25 to 28 columns take a bucket of 28 of their own.  The
// lane keeps its draws' column sums in registers (112 at 28 columns), so
// the kernel runs one block a multiprocessor, as the row layout's
// gradient does at kFs >= 16.  (On the H100 a variant that moved the
// column sums to shared memory, two blocks a multiprocessor, was only a
// few percent faster and gave up the row layout's bits: PERF.md.)  Each draw keeps its own slot and the row
// layout's arithmetic, cell order and shuffle tree, and its sums round
// each multiply-add as the row layout's compiled code does (fused /
// unfused below), so a draw's f and g are the bits of its rows'
// row-layout launch alone.
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

#include "loss_plan.cuh"
#include "prophet_model.cuh"

namespace {

using namespace tsspark;

// Blocks a multiprocessor the register budget is cut for: two (128
// registers a thread) where the kernel fits in them without spilling, one
// where ptxas would spill (-Xptxas -v, printed by chip_smoke.py).
constexpr int min_blocks(bool grad, int kFs) {
  return kFs <= 24 && !(grad && kFs >= 16) ? 2 : 1;
}

// A cell's kFs seasonal values from its staged row, two at a time.
template <int kFs>
__device__ __forceinline__ void load_cell_x(const float* xrow, float* xv) {
#pragma unroll
  for (int f = 0; f < kFs; f += 2) {
    const float2 v = *reinterpret_cast<const float2*>(xrow + f);
    xv[f] = v.x;
    xv[f + 1] = v.y;
  }
}

// Feature totals of one cell for the row in slot rp: the seasonal columns
// in order, then the regressors four at a time (columns past R have zero
// coefficients and read the staged cells' finite neighbours), then the two
// added.  kVolatile: the additive seasonal coefficients are read from
// shared memory at each cell (gradient mode keeps its registers for the
// column sums).
template <int kFs, bool kVolatile>
__device__ __forceinline__ void cell_totals(const float* xv, const float* xq,
                                            int R, const float* rp,
                                            const Plan& pl, bool has_mult,
                                            float& add, float& mult) {
  const float* r_ba = rp + pl.ba;
  const float* r_bm = rp + pl.bm;
  float add_s = 0.0f, mult_s = 0.0f;
#pragma unroll
  for (int f = 0; f < kFs; f += 4) {
    const float4 c = kVolatile ? lds4_volatile(r_ba + f)
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
  float add_r = 0.0f, mult_r = 0.0f;
  for (int r = 0; r < R; r += 4) {
    const float4 c = lds4_volatile(rp + pl.bar + r);
    const float x0 = xq[r], x1 = xq[r + 1], x2 = xq[r + 2], x3 = xq[r + 3];
    add_r = add_r + c.x * x0;
    add_r = add_r + c.y * x1;
    add_r = add_r + c.z * x2;
    add_r = add_r + c.w * x3;
    if (has_mult) {
      const float4 e = lds4_volatile(rp + pl.bmr + r);
      mult_r = mult_r + e.x * x0;
      mult_r = mult_r + e.y * x1;
      mult_r = mult_r + e.z * x2;
      mult_r = mult_r + e.w * x3;
    }
  }
  add = add_s + add_r;
  mult = mult_s + mult_r;
}

template <bool kGrad, int kFs, bool kLogistic>
__global__ void __launch_bounds__(kPipeThreads, min_blocks(kGrad, kFs))
    loss_kernel(
    const float* __restrict__ theta,  // (N, P); row i uses data row i % B
    const float* __restrict__ t,      // (B, T), ascending along T
    const float* __restrict__ y,      // (B, T)
    const float* __restrict__ mask,   // (B, T)
    const float* __restrict__ cap,    // (B, T), logistic growth only
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
  const Plan pl(kGrad, kFs, P, ncp, Fs, R, per_series, kLogistic);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowWarps;
  const int nlive =
      static_cast<int>(min(static_cast<long long>(kRowWarps), N - row0));
  const long long i = row0 + warp;
  const bool live = warp < nlive;
  const long long b = live ? i % B : 0;
  const int F = Fs + R;
  const bool linear = !kLogistic && growth == kLinear;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sh);
  float* rp = sh + pl.rows0 + warp * pl.row;
  float* r_th = rp + pl.th;
  float* r_s = rp + pl.s;
  float* r_D = rp + pl.D;
  float* r_E = rp + pl.E;
  float* r_om = rp + pl.om;
  float* r_mm = rp + pl.mm;
  float* r_omr = rp + pl.omr;
  float* r_mmr = rp + pl.mmr;
  float* r_snu = rp + pl.snu;
  float* r_snv = rp + pl.snv;
  float* r_res = rp + pl.res;
  float* r_ps = rp + pl.ps;
  float* stages = sh + pl.rows0 + kRowWarps * pl.row;
  float4* racc =
      reinterpret_cast<float4*>(stages + kStages * pl.sl.size) + tid;

  // Zero the stages (the pads past a staged slice must hold finite
  // values) and the regressor sums; the barriers.  The producer starts
  // its copies at once; the row warps fill their slots meanwhile.
  for (int j = tid; j < kStages * pl.sl.size + pl.racc; j += kPipeThreads)
    stages[j] = 0.0f;
  pipeline_init(bars, nlive, per_series, nlive);
  fence_async_shared();
  __syncthreads();
  const bool has_mult = any_multiplicative(mm, F);

  const int ntiles = (T + pl.sl.tile - 1) / pl.sl.tile;
  if (warp == kRowWarps) {
    produce_tiles<kLogistic>(stages, pl.sl, bars, nlive, row0, B, T, R, Fs,
                             t, y, mask, xr, xs, xs_bstride, cap);
    return;
  }
  if (!live) return;

  fill_slot<kFs>(rp, pl, theta + i * P, s + b * ncp, ps, mm, P, ncp, Fs, R,
                 lane);
  __syncwarp();
  if constexpr (kLogistic) {
    if (lane == 0)
      logistic_prefix(r_th[0], r_th[1], r_s, r_th + 3, r_D, r_E, ncp);
  } else {
    if (linear && lane == 0) linear_prefix(r_s, r_th + 3, r_D, r_E, ncp);
  }
  __syncwarp();

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
  // Logistic growth: the segment's rate k + D_n and offset m + G_n.
  float rate = 0.0f, off = 0.0f;
  if constexpr (kLogistic) {
    rate = r_th[0] + r_D[0];
    off = r_th[1] + r_E[0];
  }

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
    const float* cp = rows + pl.sl.c + (c0 & 3);
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
        float capv = 0.0f, sig = 0.0f;
        if constexpr (kLogistic) {
          if (!(tv >= s_lo && tv < s_hi)) {
            nl = active_changepoints_at(tv, r_s, ncp, nl);
            s_lo = nl > 0 ? r_s[nl - 1] : -inf;
            s_hi = nl < ncp ? r_s[nl] : inf;
            rate = r_th[0] + r_D[nl];
            off = r_th[1] + r_E[nl];
          }
          capv = cp[cl];
          sig = sigmoid(rate * (tv - off));
          g = capv * sig;
        } else if (linear) {
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
        load_cell_x<kFs>(xrow, xv);
        const float* xq = rxp + cl * R;
        float add, mult;
        cell_totals<kFs, kGrad>(xv, xq, R, rp, pl, has_mult, add, mult);
        const float yhat = g * (1.0f + mult) + add;
        const float mk = mp[cl];
        const float res = (yp[cl] - yhat) * mk;
        ssr = ssr + res * res;
        nobs = nobs + mk;
        if (kGrad) {
          const float w = res * mk * inv_s2;
          if constexpr (kLogistic) {
            // A and C's terms: v (t - off) and v (-rate), v = df/dx.
            const float v = -(w * (1.0f + mult)) * capv * sig * (1.0f - sig);
            u = v * (tv - off);
            uv = -(v * rate);
          } else {
            u = w * (1.0f + mult);
            uv = u * tv;
          }
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
      if (kGrad && (linear || kLogistic)) {
        // Boundaries j crossed in this step (t ascends along the row, so
        // the lanes past boundary j are those with n > j): the row's
        // sums of u and u t (logistic: of A's and C's terms) before it,
        // all earlier cells and this step's lanes with n <= j, by a fixed
        // shuffle tree.
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
    if constexpr (kLogistic) {
      if (lane == 0)
        logistic_pullback(r_th, r_s, r_D, r_E, r_snu, r_snv, TUr, TVr, q,
                          ncp, k_scale, m_scale, cp_scale, g);
    }
    for (int j = lane; j < ncp && !kLogistic; j += 32) {
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
      if (!kLogistic) {
        g[0] = k / (k_scale * k_scale) - (linear ? TVr : 0.0f);
        g[1] = m / (m_scale * m_scale) - TUr;
      }
      const float e = expf(log_sigma);
      g[2] = e * (-ssr / (sigma * sigma * sigma) + nobs / sigma +
                  sigma / (sigma_scale * sigma_scale));
    }
  }
  if (lane == 0)
    f_out[i] = row_objective(r_th, r_ps, ssr, nobs, ncp, F, k_scale, m_scale,
                             sigma_scale, cp_scale);
}

// The trial-stack layout's kernel (value mode; see the header): warp w
// of block x scores trials j0 .. j0 + 2 of series b, j0 = 21 g + 3 w, on
// the one data row its block stages.
template <int kFs, bool kLogistic>
__global__ void __launch_bounds__(kPipeThreads,
                                  kFs <= 24 ? 3 : min_blocks(false, kFs))
    stack_kernel(const float* __restrict__ theta, const float* __restrict__ t,
                 const float* __restrict__ y, const float* __restrict__ mask,
                 const float* __restrict__ cap, const float* __restrict__ s,
                 const float* __restrict__ xs, long long xs_bstride,
                 const float* __restrict__ xr, const float* __restrict__ ps,
                 const float* __restrict__ mm, float* __restrict__ f_out,
                 int N, int B, int T, int P, int ncp, int Fs, int R,
                 int growth, float k_scale, float m_scale, float sigma_scale,
                 float cp_scale) {
  constexpr int kTW = kTrialsPerWarp;
  extern __shared__ __align__(16) float sh[];
  const bool per_series = xs_bstride != 0;
  const Plan pl(false, kFs, P, ncp, Fs, R, per_series, kLogistic, true);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n = N / B;
  const int groups = (n + kStackTrials - 1) / kStackTrials;
  const long long b = blockIdx.x / groups;
  const int g0 = static_cast<int>(blockIdx.x % groups) * kStackTrials;
  const int j0 = g0 + warp * kTW;      // this warp's first trial
  const int ntr = min(kTW, n - j0);    // its trials
  const int nlive = (min(kStackTrials, n - g0) + kTW - 1) / kTW;
  const bool live = warp < nlive;
  const int F = Fs + R;
  const bool linear = !kLogistic && growth == kLinear;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sh);
  float* slots = sh + pl.rows0 + warp * kTW * pl.row;  // trial k: + k row
  float* stages = sh + pl.rows0 + kStackTrials * pl.row;

  for (int j = tid; j < kStages * pl.sl.size; j += kPipeThreads)
    stages[j] = 0.0f;
  pipeline_init(bars, nlive, per_series, 1);
  fence_async_shared();
  __syncthreads();
  const bool has_mult = any_multiplicative(mm, F);

  const int ntiles = (T + pl.sl.tile - 1) / pl.sl.tile;
  if (warp == kRowWarps) {
    produce_tiles<kLogistic>(stages, pl.sl, bars, 1, b, B, T, R, Fs, t, y,
                             mask, xr, xs, xs_bstride, cap);
    return;
  }
  if (!live) return;

  // Each trial's slot (a warp with fewer trials repeats its last one, its
  // value not written), then each trial's prefix sums, lane k trial k's.
#pragma unroll
  for (int k = 0; k < kTW; ++k) {
    const long long i = static_cast<long long>(j0 + min(k, ntr - 1)) * B + b;
    fill_slot<kFs>(slots + k * pl.row, pl, theta + i * P, s + b * ncp, ps,
                   mm, P, ncp, Fs, R, lane);
  }
  __syncwarp();
  if (lane < kTW) {
    float* rp = slots + lane * pl.row;
    if constexpr (kLogistic) {
      logistic_prefix(rp[pl.th], rp[pl.th + 1], rp + pl.s, rp + pl.th + 3,
                      rp + pl.D, rp + pl.E, ncp);
    } else {
      if (linear) linear_prefix(rp + pl.s, rp + pl.th + 3, rp + pl.D,
                                rp + pl.E, ncp);
    }
  }
  __syncwarp();

  // The row layout's walk, its trend and sums kept for each trial; the
  // changepoint segment is the series', so all trials share it.
  const float* r_s = slots + pl.s;
  const float inf = __int_as_float(0x7f800000);
  float ssr[kTW], rate[kTW], off[kTW];
  Line line[kTW];
  float nobs = 0.0f;
#pragma unroll
  for (int k = 0; k < kTW; ++k) {
    const float* r_th = slots + k * pl.row + pl.th;
    ssr[k] = 0.0f;
    line[k] = segment_line(r_th[0], r_th[1], 0.0f, 0.0f);
    rate[k] = off[k] = 0.0f;
    if constexpr (kLogistic) {
      rate[k] = r_th[0] + slots[k * pl.row + pl.D];
      off[k] = r_th[1] + slots[k * pl.row + pl.E];
    }
  }
  int nl = 0;
  float s_lo = -inf;
  float s_hi = ncp > 0 ? r_s[0] : inf;

  for (int it = 0; it < ntiles; ++it) {
    mbar_wait(bars + it % kStages, (it / kStages) & 1);
    const int t0 = it * pl.sl.tile;
    const int nc = min(pl.sl.tile, T - t0);
    const long long c0 = b * T + t0;
    const float* st = stages + (it % kStages) * pl.sl.size;
    const float* tp = st + pl.sl.t + (c0 & 3);
    const float* yp = st + pl.sl.y + (c0 & 3);
    const float* mp = st + pl.sl.m + (c0 & 3);
    const float* cp = st + pl.sl.c + (c0 & 3);
    const float* rxp = st + pl.sl.r + ((c0 * R) & 3);
    const float* xp = st + pl.sl.x0 +
                      ((b * xs_bstride + static_cast<long long>(t0) * Fs) & 3);
    for (int step = 0; step < nc; step += 32) {
      const int cl = step + lane;
      if (cl < nc) {
        const float tv = tp[cl];
        if constexpr (kLogistic) {
          if (!(tv >= s_lo && tv < s_hi)) {
            nl = active_changepoints_at(tv, r_s, ncp, nl);
            s_lo = nl > 0 ? r_s[nl - 1] : -inf;
            s_hi = nl < ncp ? r_s[nl] : inf;
#pragma unroll
            for (int k = 0; k < kTW; ++k) {
              const float* rp = slots + k * pl.row;
              rate[k] = rp[pl.th] + rp[pl.D + nl];
              off[k] = rp[pl.th + 1] + rp[pl.E + nl];
            }
          }
        } else if (linear) {
          if (!(tv > s_lo) || tv > s_hi) {
            nl = active_changepoints(tv, r_s, ncp, nl);
            s_lo = nl > 0 ? r_s[nl - 1] : -inf;
            s_hi = nl < ncp ? r_s[nl] : inf;
#pragma unroll
            for (int k = 0; k < kTW; ++k) {
              const float* rp = slots + k * pl.row;
              line[k] = segment_line(rp[pl.th], rp[pl.th + 1], rp[pl.D + nl],
                                     rp[pl.E + nl]);
            }
          }
        }
        const float capv = kLogistic ? cp[cl] : 0.0f;
        float xv[kFs];
        load_cell_x<kFs>(xp + cl * Fs, xv);
        const float* xq = rxp + cl * R;
        const float mk = mp[cl];
        const float yv = yp[cl];
#pragma unroll
        for (int k = 0; k < kTW; ++k) {
          const float* rp = slots + k * pl.row;
          float g = rp[pl.th + 1];
          if constexpr (kLogistic) {
            g = capv * sigmoid(rate[k] * (tv - off[k]));
          } else if (linear) {
            g = linear_trend(tv, line[k]);
          }
          float add, mult;
          cell_totals<kFs, false>(xv, xq, R, rp, pl, has_mult, add, mult);
          const float yhat = g * (1.0f + mult) + add;
          const float res = (yv - yhat) * mk;
          ssr[k] = ssr[k] + res * res;
        }
        nobs = nobs + mk;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + kStages + it % kStages);
  }

  nobs = warp_sum(nobs);
#pragma unroll
  for (int k = 0; k < kTW; ++k) {
    const float v = warp_sum(ssr[k]);
    if (lane == 0 && k < ntr) {
      const float* rp = slots + k * pl.row;
      f_out[static_cast<long long>(j0 + k) * B + b] =
          row_objective(rp + pl.th, rp + pl.ps, v, nobs, ncp, F, k_scale,
                        m_scale, sigma_scale, cp_scale);
    }
  }
}

// The launch of one instantiation: on a stack of n > 1 copies of the
// batch (N > B), the stack layout of the mode where its plan fits the
// card's shared memory: in value mode the trial-stack layout (ceil(n /
// 21) blocks a series), in gradient mode the draw-stack layout (ceil(n /
// kD) warps a series, seven a block); else the row layout (7 rows a
// block).  kernels/loss.py uses_stack_layout makes the same choice to
// count it.
template <bool kGrad, int kFs, bool kLogistic>
int launch(const float* theta, const float* t, const float* y,
           const float* mask, const float* cap, const float* s,
           const float* xs, long long xs_bstride, const float* xr,
           const float* ps, const float* mm, float* f_out, float* g_out,
           int N, int B, int T, int P, int ncp, int Fs, int R, int growth,
           float k_scale, float m_scale, float sigma_scale, float cp_scale,
           cudaStream_t st) {
  const bool per_series = xs_bstride != 0;
  if constexpr (!kGrad) {
    const Plan sp(false, kFs, P, ncp, Fs, R, per_series, kLogistic, true);
    const size_t bytes = sizeof(float) * static_cast<size_t>(sp.total);
    if (N > B && bytes <= kMaxSmemBytes)
      return launch_kernel(
          stack_kernel<kFs, kLogistic>,
          static_cast<long long>(B) * ((N / B + kStackTrials - 1) /
                                       kStackTrials),
          bytes, st, theta, t, y, mask, cap, s, xs, xs_bstride, xr, ps, mm,
          f_out, N, B, T, P, ncp, Fs, R, growth, k_scale, m_scale,
          sigma_scale, cp_scale);
  } else {
    if (N > B) {
      const int e = (kLogistic ? draw_stack_logistic : draw_stack)(
          kFs, theta, t, y, mask, cap, s, xs, xs_bstride, xr, ps, mm, f_out,
          g_out, N, B, T, P, ncp, Fs, R, growth, k_scale, m_scale,
          sigma_scale, cp_scale, st);
      if (e >= 0) return e;
    }
  }
  const Plan pl(kGrad, kFs, P, ncp, Fs, R, per_series, kLogistic);
  const size_t bytes = sizeof(float) * static_cast<size_t>(pl.total);
  return launch_kernel(loss_kernel<kGrad, kFs, kLogistic>,
                       (N + kRowWarps - 1) / kRowWarps, bytes, st, theta, t,
                       y, mask, cap, s, xs, xs_bstride, xr, ps, mm, f_out,
                       g_out, N, B, T, P, ncp, Fs, R, growth, k_scale,
                       m_scale, sigma_scale, cp_scale);
}

template <bool kGrad, bool kLogistic>
int dispatch(const float* theta, const float* t, const float* y,
             const float* mask, const float* cap, const float* s,
             const float* xs, long long xs_bstride, const float* xr,
             const float* ps, const float* mm, float* f_out, float* g_out,
             int N, int B, int T, int P, int ncp, int Fs, int R, int growth,
             float k_scale, float m_scale, float sigma_scale, float cp_scale,
             cudaStream_t st) {
#define TSSPARK_LOSS(KF)                                                     \
  return launch<kGrad, KF, kLogistic>(                                       \
      theta, t, y, mask, cap, s, xs, xs_bstride, xr, ps, mm, f_out, g_out, N, \
      B, T, P, ncp, Fs, R, growth, k_scale, m_scale, sigma_scale, cp_scale, st)
  if (Fs <= 8) TSSPARK_LOSS(8);
  if (Fs <= 16) TSSPARK_LOSS(16);
  if (Fs <= 24) TSSPARK_LOSS(24);
  if (Fs <= 32) TSSPARK_LOSS(32);
  if (Fs <= 48) TSSPARK_LOSS(48);
  TSSPARK_LOSS(64);
#undef TSSPARK_LOSS
}

}  // namespace

// cap: (B, T) capacities for logistic growth, null for linear and flat.
// N: a multiple of B (a stack of N / B copies of the batch).
extern "C" int tsspark_loss(
    const float* theta, const float* t, const float* y, const float* mask,
    const float* cap, const float* s, const float* xs, long long xs_bstride,
    const float* xr, const float* ps, const float* mm, float* f_out,
    float* g_out, int N,
    int B, int T, int P, int ncp, int Fs, int R, int growth, float k_scale,
    float m_scale, float sigma_scale, float cp_scale, void* stream) {
  if (N == 0) return 0;
  if (B <= 0 || N % B != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool logistic = growth == kLogistic;
  const unsigned long long align = reinterpret_cast<unsigned long long>(t) |
      reinterpret_cast<unsigned long long>(y) |
      reinterpret_cast<unsigned long long>(mask) |
      reinterpret_cast<unsigned long long>(logistic ? cap : t) |
      reinterpret_cast<unsigned long long>(xs) |
      reinterpret_cast<unsigned long long>(xr);
  if (Fs % 2 != 0 || Fs > 64 || (align & 15ull) != 0 ||
      (logistic && cap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TSSPARK_DISPATCH(GRAD, LOGI, G)                                      \
  return dispatch<GRAD, LOGI>(theta, t, y, mask, cap, s, xs, xs_bstride, xr, \
                              ps, mm, f_out, G, N, B, T, P, ncp, Fs, R,      \
                              growth, k_scale, m_scale, sigma_scale,         \
                              cp_scale, st)
  if (logistic) {
    if (g_out != nullptr) TSSPARK_DISPATCH(true, true, g_out);
    TSSPARK_DISPATCH(false, true, nullptr);
  }
  if (g_out != nullptr) TSSPARK_DISPATCH(true, false, g_out);
  TSSPARK_DISPATCH(false, false, nullptr);
#undef TSSPARK_DISPATCH
}
