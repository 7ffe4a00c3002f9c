// K3's draw-stack layout (gradient mode on a stack of n > 1 copies of
// the batch; the design is in loss.cu's header): its kernel and launch,
// instantiated by loss_draws.cu (linear and flat growth) and
// loss_draws_logistic.cu (logistic growth).
#pragma once

#include <cuda_runtime.h>

#include "loss_plan.cuh"
#include "prophet_model.cuh"

namespace {

using namespace tsspark;

// Feature totals of one cell for the kD draws of a draw-stack warp (slot
// k at slots + k row), each in cell_totals's order: the seasonal columns
// in order, then the regressors four at a time, then the two added.  The
// cell's seasonal values are read once for all draws; whole quads of
// columns past Fs (zero coefficients in every draw) are skipped.
template <int kFs, int kD>
__device__ __forceinline__ void draw_totals(const float* xrow,
                                            const float* xq, int Fs, int R,
                                            const float* slots,
                                            const Plan& pl, bool has_mult,
                                            float* add, float* mult) {
  float add_s[kD], mult_s[kD], add_r[kD], mult_r[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k)
    add_s[k] = mult_s[k] = add_r[k] = mult_r[k] = 0.0f;
#pragma unroll
  for (int f = 0; f < kFs; f += 4) {
    if (f < Fs) {
      const float2 x01 = lds2_volatile(xrow + f);
      const float2 x23 = lds2_volatile(xrow + f + 2);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float4 c = lds4_volatile(slots + k * pl.row + pl.ba + f);
        add_s[k] = add_s[k] + c.x * x01.x;
        add_s[k] = add_s[k] + c.y * x01.y;
        add_s[k] = add_s[k] + c.z * x23.x;
        add_s[k] = add_s[k] + c.w * x23.y;
      }
    }
  }
  if (has_mult) {
#pragma unroll
    for (int f = 0; f < kFs; f += 4) {
      if (f < Fs) {
        const float2 x01 = lds2_volatile(xrow + f);
        const float2 x23 = lds2_volatile(xrow + f + 2);
#pragma unroll
        for (int k = 0; k < kD; ++k) {
          const float4 c = lds4_volatile(slots + k * pl.row + pl.bm + f);
          mult_s[k] = mult_s[k] + c.x * x01.x;
          mult_s[k] = mult_s[k] + c.y * x01.y;
          mult_s[k] = mult_s[k] + c.z * x23.x;
          mult_s[k] = mult_s[k] + c.w * x23.y;
        }
      }
    }
  }
  for (int r = 0; r < R; r += 4) {
    const float x0 = xq[r], x1 = xq[r + 1], x2 = xq[r + 2], x3 = xq[r + 3];
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      const float* rp = slots + k * pl.row;
      const float4 c = lds4_volatile(rp + pl.bar + r);
      add_r[k] = add_r[k] + c.x * x0;
      add_r[k] = add_r[k] + c.y * x1;
      add_r[k] = add_r[k] + c.z * x2;
      add_r[k] = add_r[k] + c.w * x3;
      if (has_mult) {
        const float4 e = lds4_volatile(rp + pl.bmr + r);
        mult_r[k] = mult_r[k] + e.x * x0;
        mult_r[k] = mult_r[k] + e.y * x1;
        mult_r[k] = mult_r[k] + e.z * x2;
        mult_r[k] = mult_r[k] + e.w * x3;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    add[k] = add_s[k] + add_r[k];
    mult[k] = mult_s[k] + mult_r[k];
  }
}

// The draw-stack layout's sum steps, rounded as loss_kernel's compiled
// code rounds the same steps, so that each draw's sums are the bits of
// its rows' row-layout launch.  nvcc 12.8 for sm_90a fuses some of
// loss_kernel's multiply-adds and not others: the sum of squares and the
// regressor sums fused, the seasonal column sums fused in the third
// column of each four and unfused in the rest (read on the card against
// the row layout, column by column).  The card checks the bits every run
// (chip_smoke.py's uncertainty phase, the card tests): a toolchain that
// fuses otherwise shows there.
__device__ __forceinline__ float fused(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}

__device__ __forceinline__ float unfused(float a, float b, float acc) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// A seasonal column's step for column f (unrolled: f is a constant):
// acc + t x, t = w, or (1 - mm) w + mm wg with multiplicative features
// (exact: mm is 0 or 1).
__device__ __forceinline__ float season_col(float acc, float t, float x,
                                            int f) {
  return f % 4 == 2 ? fused(t, x, acc) : unfused(t, x, acc);
}

// The draw-stack layout's kernel (gradient mode; see the header): warp w
// of block x takes unit u = 7 x + w, the draws kD (u / B) .. kD (u / B) +
// kD - 1 of series u % B (a warp with fewer draws repeats its last one,
// its outputs not written), on the one data row the producer stages for
// it.  Each draw's walk is loss_kernel's in gradient mode.
template <int kFs, bool kLogistic>
__global__ void __launch_bounds__(kPipeThreads, 1)
    draw_kernel(const float* __restrict__ theta, const float* __restrict__ t,
                const float* __restrict__ y, const float* __restrict__ mask,
                const float* __restrict__ cap, const float* __restrict__ s,
                const float* __restrict__ xs, long long xs_bstride,
                const float* __restrict__ xr, const float* __restrict__ ps,
                const float* __restrict__ mm, float* __restrict__ f_out,
                float* __restrict__ g_out, int N, int B, int T, int P,
                int ncp, int Fs, int R, int growth, float k_scale,
                float m_scale, float sigma_scale, float cp_scale) {
  constexpr int kD = draws_per_warp(kFs);
  extern __shared__ __align__(16) float sh[];
  const bool per_series = xs_bstride != 0;
  const Plan pl(true, kFs, P, ncp, Fs, R, per_series, kLogistic, false, kD);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n = N / B;
  const long long units = static_cast<long long>((n + kD - 1) / kD) * B;
  const long long u0 = static_cast<long long>(blockIdx.x) * kRowWarps;
  const int nlive =
      static_cast<int>(min(static_cast<long long>(kRowWarps), units - u0));
  const long long unit = u0 + warp;
  const bool live = warp < nlive;
  const long long b = live ? unit % B : 0;
  const int j0 = live ? static_cast<int>(unit / B) * kD : 0;  // first draw
  const int nd = live ? min(kD, n - j0) : 0;                  // its draws
  const int F = Fs + R;
  const bool linear = !kLogistic && growth == kLinear;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sh);
  float* slots = sh + pl.rows0 + warp * kD * pl.row;  // draw k: + k row
  float* stages = sh + pl.rows0 + kRowWarps * kD * pl.row;
  float4* racc =
      reinterpret_cast<float4*>(stages + kStages * pl.sl.size) + tid;

  for (int j = tid; j < kStages * pl.sl.size + pl.racc; j += kPipeThreads)
    stages[j] = 0.0f;
  pipeline_init(bars, nlive, per_series, nlive);
  fence_async_shared();
  __syncthreads();
  const bool has_mult = any_multiplicative(mm, F);

  const int ntiles = (T + pl.sl.tile - 1) / pl.sl.tile;
  if (warp == kRowWarps) {
    produce_tiles<kLogistic>(stages, pl.sl, bars, nlive, u0, B, T, R, Fs,
                             t, y, mask, xr, xs, xs_bstride, cap);
    return;
  }
  if (!live) return;

#pragma unroll
  for (int k = 0; k < kD; ++k) {
    const long long i = static_cast<long long>(j0 + min(k, nd - 1)) * B + b;
    fill_slot<kFs>(slots + k * pl.row, pl, theta + i * P, s + b * ncp, ps,
                   mm, P, ncp, Fs, R, lane);
  }
  __syncwarp();
  if (lane < kD) {
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

  // The series' changepoints (slot 0's copy); the split coefficients 1 - mm
  // and mm, the same in every slot.
  const float* r_s = slots + pl.s;
  const float* r_om = slots + pl.om;
  const float* r_mm = slots + pl.mm;
  const float* r_omr = slots + pl.omr;
  const float* r_mmr = slots + pl.mmr;
  const float inf = __int_as_float(0x7f800000);
  float inv_s2[kD], ssr[kD], TU[kD], TV[kD], rate[kD], off[kD];
  Line line[kD];
  float acc[kD][kFs];  // seasonal gradient sums, each draw's
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    const float* r_th = slots + k * pl.row + pl.th;
    inv_s2[k] = 1.0f / sq(sigma_of(r_th[2]));
    ssr[k] = TU[k] = TV[k] = 0.0f;
    line[k] = segment_line(r_th[0], r_th[1], 0.0f, 0.0f);
    rate[k] = off[k] = 0.0f;
    if constexpr (kLogistic) {
      rate[k] = r_th[0] + slots[k * pl.row + pl.D];
      off[k] = r_th[1] + slots[k * pl.row + pl.E];
    }
#pragma unroll
    for (int f = 0; f < kFs; ++f) acc[k][f] = 0.0f;
  }
  float nobs = 0.0f;
  int nl = 0;  // the lane's active changepoints, n(t) of its last cell
  int q = 0;   // boundaries the walk has passed
  float s_lo = -inf;
  float s_hi = ncp > 0 ? r_s[0] : inf;

  for (int it = 0; it < ntiles; ++it) {
    mbar_wait(bars + it % kStages, (it / kStages) & 1);
    const int t0 = it * pl.sl.tile;
    const int nc = min(pl.sl.tile, T - t0);
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
    for (int step = 0; step < nc; step += 32) {
      const int cl = step + lane;
      const bool valid = cl < nc;
      float u[kD], uv[kD];
#pragma unroll
      for (int k = 0; k < kD; ++k) u[k] = uv[k] = 0.0f;
      const float tv = valid ? tp[cl] : 0.0f;
      if (valid) {
        if constexpr (kLogistic) {
          if (!(tv >= s_lo && tv < s_hi)) {
            nl = active_changepoints_at(tv, r_s, ncp, nl);
            s_lo = nl > 0 ? r_s[nl - 1] : -inf;
            s_hi = nl < ncp ? r_s[nl] : inf;
#pragma unroll
            for (int k = 0; k < kD; ++k) {
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
            for (int k = 0; k < kD; ++k) {
              const float* rp = slots + k * pl.row;
              line[k] = segment_line(rp[pl.th], rp[pl.th + 1], rp[pl.D + nl],
                                     rp[pl.E + nl]);
            }
          }
        }
        const float capv = kLogistic ? cp[cl] : 0.0f;
        const float* xrow = xp + cl * Fs;
        const float* xq = rxp + cl * R;
        float add[kD], mult[kD];
        draw_totals<kFs, kD>(xrow, xq, Fs, R, slots, pl, has_mult, add,
                             mult);
        const float mk = mp[cl];
        const float yv = yp[cl];
        float w[kD], wg[kD];
#pragma unroll
        for (int k = 0; k < kD; ++k) {
          float g = slots[k * pl.row + pl.th + 1];
          float sig = 0.0f;
          if constexpr (kLogistic) {
            sig = sigmoid(rate[k] * (tv - off[k]));
            g = capv * sig;
          } else if (linear) {
            g = linear_trend(tv, line[k]);
          }
          const float yhat = g * (1.0f + mult[k]) + add[k];
          const float res = (yv - yhat) * mk;
          ssr[k] = fused(res, res, ssr[k]);
          w[k] = res * mk * inv_s2[k];
          if constexpr (kLogistic) {
            const float v =
                -(w[k] * (1.0f + mult[k])) * capv * sig * (1.0f - sig);
            u[k] = v * (tv - off[k]);
            uv[k] = -(v * rate[k]);
          } else {
            u[k] = w[k] * (1.0f + mult[k]);
            uv[k] = u[k] * tv;
          }
          wg[k] = w[k] * g;
        }
        nobs = nobs + mk;
        // The column sums: each seasonal pair (quad, with multiplicative
        // features) read once for the warp's draws.
        if (has_mult) {
#pragma unroll
          for (int f = 0; f < kFs; f += 4) {
            if (f < Fs) {
              const float4 o = lds4_volatile(r_om + f);
              const float4 p = lds4_volatile(r_mm + f);
              const float2 x01 = lds2_volatile(xrow + f);
              const float2 x23 = lds2_volatile(xrow + f + 2);
#pragma unroll
              for (int k = 0; k < kD; ++k) {
                acc[k][f] =
                    season_col(acc[k][f], o.x * w[k] + p.x * wg[k],
                               x01.x, f);
                acc[k][f + 1] =
                    season_col(acc[k][f + 1], o.y * w[k] + p.y * wg[k],
                               x01.y, f + 1);
                acc[k][f + 2] =
                    season_col(acc[k][f + 2], o.z * w[k] + p.z * wg[k],
                               x23.x, f + 2);
                acc[k][f + 3] =
                    season_col(acc[k][f + 3], o.w * w[k] + p.w * wg[k],
                               x23.y, f + 3);
              }
            }
          }
        } else {
#pragma unroll
          for (int f = 0; f < kFs; f += 2) {
            if (f < Fs) {
              const float2 x = lds2_volatile(xrow + f);
#pragma unroll
              for (int k = 0; k < kD; ++k) {
                acc[k][f] = season_col(acc[k][f], w[k], x.x, f);
                acc[k][f + 1] = season_col(acc[k][f + 1], w[k], x.y, f + 1);
              }
            }
          }
        }
        for (int r = 0; r < R; r += 4) {
          const float4 o = lds4_volatile(r_omr + r);
          const float4 p = lds4_volatile(r_mmr + r);
#pragma unroll
          for (int k = 0; k < kD; ++k) {
            float4* ak = racc + ((k * pl.R4 + r) >> 2) * kPipeThreads;
            float4 a = *ak;
            a.x = fused(o.x * w[k] + p.x * wg[k], xq[r], a.x);
            a.y = fused(o.y * w[k] + p.y * wg[k], xq[r + 1], a.y);
            a.z = fused(o.z * w[k] + p.z * wg[k], xq[r + 2], a.z);
            a.w = fused(o.w * w[k] + p.w * wg[k], xq[r + 3], a.w);
            *ak = a;
          }
        }
      }
      if (linear || kLogistic) {
        // Boundaries crossed in this step: each draw's snapshot, as the
        // row layout takes it.
        const int q_next =
            __shfl_sync(0xffffffffu, nl, min(nc - step, 32) - 1);
        for (int j = q; j < q_next; ++j) {
          const bool before = valid && nl <= j;
#pragma unroll
          for (int k = 0; k < kD; ++k) {
            if (k < nd) {
              const float su = warp_sum(TU[k] + (before ? u[k] : 0.0f));
              const float sv = warp_sum(TV[k] + (before ? uv[k] : 0.0f));
              if (lane == 0) {
                slots[k * pl.row + pl.snu + j] = su;
                slots[k * pl.row + pl.snv + j] = sv;
              }
            }
          }
        }
        q = q_next;
      }
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        TU[k] = TU[k] + u[k];
        TV[k] = TV[k] + uv[k];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + kStages + it % kStages);
  }

  nobs = warp_sum(nobs);
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    if (k < nd) {
      float* rp = slots + k * pl.row;
      const float* r_th = rp + pl.th;
      const float* r_sk = rp + pl.s;
      const float* r_ps = rp + pl.ps;
      float* r_res = rp + pl.res;
      const long long i = static_cast<long long>(j0 + k) * B + b;
      const float kk = r_th[0];
      const float m = r_th[1];
      const float log_sigma = r_th[2];
      const float sigma = sigma_of(log_sigma);
      const float ssr_k = warp_sum(ssr[k]);
      const float tu = warp_sum(TU[k]);
      const float tv_sum = warp_sum(TV[k]);
      __syncwarp();
      for (int r = lane; r < R; r += 32) {
        const float* col = reinterpret_cast<const float*>(
            racc - tid + ((k * pl.R4 + r) >> 2) * kPipeThreads + warp * 32);
        float v = 0.0f;
        for (int x = 0; x < 32; ++x) v = v + col[4 * x + (r & 3)];
        r_res[r] = v;
      }
#pragma unroll
      for (int f = 0; f < kFs; ++f) {
        if (f < Fs) {
          const float v = warp_sum(acc[k][f]);
          if (lane == 0) r_res[R + f] = v;
        }
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
          logistic_pullback(r_th, r_sk, rp + pl.D, rp + pl.E, rp + pl.snu,
                            rp + pl.snv, TUr, TVr, q, ncp, k_scale, m_scale,
                            cp_scale, g);
      }
      for (int j = lane; j < ncp && !kLogistic; j += 32) {
        float data = 0.0f;
        if (linear && j < q)
          data = (TVr - rp[pl.snv + j]) - r_sk[j] * (TUr - rp[pl.snu + j]);
        g[3 + j] = smooth_abs_grad(r_th[3 + j]) / cp_scale - data;
      }
      for (int f = lane; f < F; f += 32) {
        const float p = r_ps[f];
        const float sum = f < Fs ? r_res[R + f] : r_res[f - Fs];
        g[3 + ncp + f] = r_th[3 + ncp + f] / (p * p) - sum;
      }
      if (lane == 0) {
        if (!kLogistic) {
          g[0] = kk / (k_scale * k_scale) - (linear ? TVr : 0.0f);
          g[1] = m / (m_scale * m_scale) - TUr;
        }
        const float e = expf(log_sigma);
        g[2] = e * (-ssr_k / (sigma * sigma * sigma) + nobs / sigma +
                    sigma / (sigma_scale * sigma_scale));
        f_out[i] = row_objective(r_th, r_ps, ssr_k, nobs, ncp, F, k_scale,
                                 m_scale, sigma_scale, cp_scale);
      }
    }
  }
}

// The draw-stack layout's launch with kC seasonal columns a slot (the
// bucket's, or 28 where Fs fits them: every column a lane's registers
// hold is one it sums), or -1 where its plan passes the card's shared
// memory.
template <int kC, bool kLogistic>
int launch_draws(const float* theta, const float* t, const float* y,
                 const float* mask, const float* cap, const float* s,
                 const float* xs, long long xs_bstride, const float* xr,
                 const float* ps, const float* mm, float* f_out,
                 float* g_out, int N, int B, int T, int P, int ncp, int Fs,
                 int R, int growth, float k_scale, float m_scale,
                 float sigma_scale, float cp_scale, cudaStream_t st) {
  constexpr int kD = draws_per_warp(kC);
  const Plan dp(true, kC, P, ncp, Fs, R, xs_bstride != 0, kLogistic, false,
                kD);
  const size_t bytes = sizeof(float) * static_cast<size_t>(dp.total);
  if (bytes > kMaxSmemBytes) return -1;
  const long long units = static_cast<long long>((N / B + kD - 1) / kD) * B;
  return launch_kernel(draw_kernel<kC, kLogistic>,
                       (units + kRowWarps - 1) / kRowWarps, bytes, st, theta,
                       t, y, mask, cap, s, xs, xs_bstride, xr, ps, mm, f_out,
                       g_out, N, B, T, P, ncp, Fs, R, growth, k_scale,
                       m_scale, sigma_scale, cp_scale);
}

// The draw-stack layout's launch for the seasonal bucket kFs (25 to 28
// columns take the bucket of 28), or -1 past its plan.
template <bool kLogistic>
int draw_stack_bucket(TSSPARK_DRAW_STACK_ARGS) {
#define TSSPARK_DRAWS(KC)                                                    \
  return launch_draws<KC, kLogistic>(theta, t, y, mask, cap, s, xs,          \
                                     xs_bstride, xr, ps, mm, f_out, g_out, N, \
                                     B, T, P, ncp, Fs, R, growth, k_scale,    \
                                     m_scale, sigma_scale, cp_scale, st)
  if (kFs == 8) TSSPARK_DRAWS(8);
  if (kFs == 16) TSSPARK_DRAWS(16);
  if (kFs == 24) TSSPARK_DRAWS(24);
  if (kFs == 32 && Fs <= 28) TSSPARK_DRAWS(28);
  if (kFs == 32) TSSPARK_DRAWS(32);
  if (kFs == 48) TSSPARK_DRAWS(48);
  TSSPARK_DRAWS(64);
#undef TSSPARK_DRAWS
}

}  // namespace
