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
// and, in gradient mode, with w_t = r_t * mask_t / sigma^2 (= -df/dyhat_t):
//   df/dk       = -sum w (1 + mult) t                 + k / k_s^2
//   df/dm       = -sum w (1 + mult)                   + m / m_s^2
//   df/ddelta_j = -sum w (1 + mult) relu(t - s_j)     + smooth_abs'(delta_j)/cp_s
//   df/dbeta_f  = -sum w ((1 - mm_f) + mm_f trend) x_f + beta_f / p_f^2
//   df/dlog_sig = e^ls (-sum r^2 / sigma^3 + n_obs / sigma + sigma / sigma_s^2)
// (flat growth: trend = m, and k and delta see only their priors).
// Linear and flat growth; logistic growth is refused by the wrapper.
//
// What bounds it: bytes.  A row reads t, y, mask and its R regressor
// columns (six floats a cell for config 3), the shared (T, Fs) seasonal
// matrix stays in L2; ~300 float operations a cell in gradient mode is
// below the card's float32 rate at 3.35 TB/s.  Design: one block of 256
// threads per row, walking T in tiles of 256 cells.  Phase A: one thread
// per cell computes the forward model and keeps its share of sum r^2 and
// n_obs in registers; in gradient mode it writes t, w (1 + mult), w and
// w * trend of its cell to shared memory.  Phase B: the 2 + ncp + F data
// sums of the gradient, each owned by 256 / (2 + ncp + F) lanes that
// stride over the tile and keep ONE running sum in a register across
// tiles — no per-thread array of 53 accumulators.  At the end each sum's
// lanes are added in lane order and sum r^2 and n_obs go through a fixed
// shuffle tree.  Every sum's order depends only on T and the block size,
// never on the batch width or the row's place in it, and nothing is
// atomic: a row's loss and gradient are the same bits in any batch (the
// solver's compaction relies on that).

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

constexpr int kThreads = 256;

template <bool kGrad>
__global__ void __launch_bounds__(kThreads) loss_kernel(
    const float* __restrict__ theta,  // (N, P); row i uses data row i % B
    const float* __restrict__ t,      // (B, T)
    const float* __restrict__ y,      // (B, T)
    const float* __restrict__ mask,   // (B, T)
    const float* __restrict__ s,      // (B, ncp)
    const float* __restrict__ xs,     // (T, Fs) or (B, T, Fs)
    long long xs_bstride,             // 0 (shared) or T * Fs
    const float* __restrict__ xr,     // (B, T, R)
    const float* __restrict__ ps,     // (F,) feature prior scales
    const float* __restrict__ mm,     // (F,) multiplicative mask
    float* __restrict__ f_out,        // (N,)
    float* __restrict__ g_out,        // (N, P), gradient mode only
    int B, int T, int P, int ncp, int Fs, int R, int growth, float k_scale,
    float m_scale, float sigma_scale, float cp_scale) {
  extern __shared__ float sh[];
  const int F = Fs + R;
  const int nsum = 2 + ncp + F;     // data sums: k, m, delta_j, beta_f
  float* sh_s = sh;                 // ncp changepoints
  float* sh_delta = sh_s + ncp;     // ncp rate changes
  float* sh_ba = sh_delta + ncp;    // F additive coefficients
  float* sh_bm = sh_ba + F;         // F multiplicative coefficients
  float* sh_t = sh_bm + F;          // kThreads: the tile's t
  float* sh_u = sh_t + kThreads;    // w * (1 + mult)
  float* sh_w = sh_u + kThreads;    // w
  float* sh_wg = sh_w + kThreads;   // w * trend
  float* sh_red = sh_wg + kThreads; // kThreads / 32 reduction scratch

  const int tid = threadIdx.x;
  const long long i = blockIdx.x;
  const long long b = i % B;
  const float* th = theta + i * P;
  for (int j = tid; j < ncp; j += kThreads) {
    sh_s[j] = s[b * ncp + j];
    sh_delta[j] = th[3 + j];
  }
  split_coefs(th + 3 + ncp, mm, sh_ba, sh_bm, F);
  __syncthreads();
  const float k = th[0];
  const float m = th[1];
  const float log_sigma = th[2];
  const float sigma = sigma_of(log_sigma);
  const float inv_s2 = 1.0f / (sigma * sigma);
  const bool linear = growth == kLinear;

  // Phase B ownership: sum p, lane l (tid = p * lanes + l).
  const int lanes = kGrad ? kThreads / nsum : 1;
  const int p_own = tid / lanes;
  const int lane = tid - p_own * lanes;
  const bool owner = kGrad && p_own < nsum;
  float acc = 0.0f;
  float ssr = 0.0f, nobs = 0.0f;
  const float* xs_row = xs + b * xs_bstride;

  for (int t0 = 0; t0 < T; t0 += kThreads) {
    const int n = min(kThreads, T - t0);
    if (tid < n) {
      const long long cell = b * T + t0 + tid;
      const float tv = t[cell];
      const float g = linear ? linear_trend(tv, k, m, sh_s, sh_delta, ncp) : m;
      float add, mult;
      feature_totals(xs_row + (long long)(t0 + tid) * Fs, Fs, xr + cell * R,
                     R, sh_ba, sh_bm, &add, &mult);
      const float yhat = g * (1.0f + mult) + add;
      const float mk = mask[cell];
      const float r = (y[cell] - yhat) * mk;
      ssr = ssr + r * r;
      nobs = nobs + mk;
      if (kGrad) {
        const float w = r * mk * inv_s2;
        sh_t[tid] = tv;
        sh_u[tid] = w * (1.0f + mult);
        sh_w[tid] = w;
        sh_wg[tid] = w * g;
      }
    }
    if (kGrad) {
      __syncthreads();
      if (owner) {
        if (p_own == 0) {
          if (linear)
            for (int c = lane; c < n; c += lanes) acc = acc + sh_u[c] * sh_t[c];
        } else if (p_own == 1) {
          for (int c = lane; c < n; c += lanes) acc = acc + sh_u[c];
        } else if (p_own < 2 + ncp) {
          if (linear) {
            const float sj = sh_s[p_own - 2];
            for (int c = lane; c < n; c += lanes)
              acc = acc + sh_u[c] * fmaxf(sh_t[c] - sj, 0.0f);
          }
        } else {
          const int f = p_own - 2 - ncp;
          const float mf = mm[f];
          const float* x;
          long long stride;
          if (f < Fs) {
            x = xs_row + (long long)t0 * Fs + f;
            stride = Fs;
          } else {
            x = xr + (b * T + t0) * R + (f - Fs);
            stride = R;
          }
          for (int c = lane; c < n; c += lanes) {
            const float coef = (1.0f - mf) * sh_w[c] + mf * sh_wg[c];
            acc = acc + coef * x[c * stride];
          }
        }
      }
      __syncthreads();
    }
  }

  ssr = block_sum<kThreads>(ssr, sh_red);
  nobs = block_sum<kThreads>(nobs, sh_red);
  if (kGrad) {
    if (owner) sh_t[tid] = acc;  // index p_own * lanes + lane
    __syncthreads();
    if (tid < nsum) {
      float sum = 0.0f;
      for (int l = 0; l < lanes; ++l) sum = sum + sh_t[tid * lanes + l];
      float prior;
      int idx;
      if (tid == 0) {
        idx = 0;
        prior = k / (k_scale * k_scale);
      } else if (tid == 1) {
        idx = 1;
        prior = m / (m_scale * m_scale);
      } else if (tid < 2 + ncp) {
        idx = tid + 1;
        prior = smooth_abs_grad(sh_delta[tid - 2]) / cp_scale;
      } else {
        const int f = tid - 2 - ncp;
        idx = 3 + ncp + f;
        const float p = ps[f];
        prior = th[idx] / (p * p);
      }
      g_out[i * P + idx] = prior - sum;
    }
  }
  if (tid == 0) {
    float prior = 0.5f * sq(k / k_scale);
    prior = prior + 0.5f * sq(m / m_scale);
    prior = prior + 0.5f * sq(sigma / sigma_scale);
    float lap = 0.0f;
    for (int j = 0; j < ncp; ++j) lap = lap + smooth_abs(sh_delta[j]) / cp_scale;
    prior = prior + lap;
    float quad = 0.0f;
    for (int f = 0; f < F; ++f) quad = quad + sq(th[3 + ncp + f] / ps[f]);
    prior = prior + 0.5f * quad;
    const float nll = 0.5f * ssr / (sigma * sigma) + nobs * logf(sigma);
    f_out[i] = nll + prior;
    if (kGrad) {
      const float e = expf(log_sigma);
      g_out[i * P + 2] =
          e * (-ssr / (sigma * sigma * sigma) + nobs / sigma +
               sigma / (sigma_scale * sigma_scale));
    }
  }
}

}  // namespace

extern "C" int tsspark_loss(
    const float* theta, const float* t, const float* y, const float* mask,
    const float* s, const float* xs, long long xs_bstride, const float* xr,
    const float* ps, const float* mm, float* f_out, float* g_out, int N,
    int B, int T, int P, int ncp, int Fs, int R, int growth, float k_scale,
    float m_scale, float sigma_scale, float cp_scale, void* stream) {
  if (N == 0) return 0;
  const int F = Fs + R;
  const size_t shmem =
      sizeof(float) * (2 * ncp + 2 * F + 4 * kThreads + kThreads / 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_out != nullptr) {
    loss_kernel<true><<<N, kThreads, shmem, st>>>(
        theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm, f_out, g_out, B, T,
        P, ncp, Fs, R, growth, k_scale, m_scale, sigma_scale, cp_scale);
  } else {
    loss_kernel<false><<<N, kThreads, shmem, st>>>(
        theta, t, y, mask, s, xs, xs_bstride, xr, ps, mm, f_out, nullptr, B,
        T, P, ncp, Fs, R, growth, k_scale, m_scale, sigma_scale, cp_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
