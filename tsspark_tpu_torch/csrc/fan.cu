// K4 `fan`: the losses of a whole Armijo step ladder in one pass.
//
// Replaces the XLA-fused closed-form line-search fan of the JAX package
// (no Pallas kernel there):
//   tsspark_tpu/models/prophet/loss.py  fan_value_closed_form
//
// For linear growth the trend and both feature totals are linear in the
// parameters, so along the ray theta + s d the model mean is a polynomial
// in s:  yhat = c0 + s c1 + s^2 c2  with
//   c0 = g0 (1 + m0) + a0,   c1 = gd (1 + m0) + g0 md + ad,   c2 = gd md
// (g, a, m: trend, additive and multiplicative totals of theta (0) and of
// d (d), from prophet_model.cuh, the functions K1 and K3 use).  One pass
// over T takes the six masked sums s00 = sum r0^2, s01 = sum r0 c1,
// s02 = sum r0 c2, s11 = sum c1^2, s12 = sum c1 c2, s22 = sum c2^2
// (r0 = (y - c0) mask, c1 and c2 masked) and n_obs.  Then each rung s of
// the (K, B) ladder costs O(ncp):
//   ssr   = max(s00 - 2 s s01 + s^2 (s11 - 2 s02) + 2 s^3 s12 + s^4 s22, 0)
//   sigma = 1e-5 + exp(ls0 + s lsd)
//   f     = 0.5 ssr / sigma^2 + n_obs log(sigma)
//         + quadratic Gaussian priors of (k, m) and beta in s
//         + 0.5 (sigma / sigma_s)^2 + sum_j smooth_abs(delta0_j + s dd_j)/cp_s
// The clamp keeps f32 cancellation in the expanded sum of squares from
// turning into a falsely negative loss; it propagates NaN, as the JAX
// package's jnp.maximum does, so a non-finite ray is still rejected.
//
// What bounds it: bytes, as K3: a row reads t, y, mask and its regressor
// columns once; ~2x K1's operations per cell.  Design: one block of 256
// threads per row; each thread walks its cells of T and keeps the seven
// sums in registers; a fixed shuffle tree adds them (the order depends
// only on T and the block size — row-local, no atomics); thread 0 forms
// the prior polynomials; then one thread per rung writes its loss.

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) fan_kernel(
    const float* __restrict__ theta,   // (B, P)
    const float* __restrict__ dir,     // (B, P)
    const float* __restrict__ ladder,  // (K, B)
    const float* __restrict__ t,       // (B, T)
    const float* __restrict__ y,       // (B, T)
    const float* __restrict__ mask,    // (B, T)
    const float* __restrict__ s,       // (B, ncp)
    const float* __restrict__ xs,      // (T, Fs) or (B, T, Fs)
    long long xs_bstride,              // 0 (shared) or T * Fs
    const float* __restrict__ xr,      // (B, T, R)
    const float* __restrict__ ps,      // (F,) feature prior scales
    const float* __restrict__ mm,      // (F,) multiplicative mask
    float* __restrict__ out,           // (K, B)
    int B, int T, int P, int ncp, int Fs, int R, int K, float k_scale,
    float m_scale, float sigma_scale, float cp_scale) {
  extern __shared__ float sh[];
  const int F = Fs + R;
  float* sh_s = sh;                  // ncp changepoints
  float* sh_d0 = sh_s + ncp;         // theta's delta
  float* sh_dd = sh_d0 + ncp;        // d's delta
  float* sh_ba0 = sh_dd + ncp;       // F: theta's additive coefficients
  float* sh_bm0 = sh_ba0 + F;        //    theta's multiplicative
  float* sh_bad = sh_bm0 + F;        //    d's additive
  float* sh_bmd = sh_bad + F;        //    d's multiplicative
  float* sh_red = sh_bmd + F;        // kThreads / 32 reduction scratch
  float* sh_sum = sh_red + kThreads / 32;  // 7 sums + 6 prior terms

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* th = theta + b * P;
  const float* dr = dir + b * P;
  for (int j = tid; j < ncp; j += kThreads) {
    sh_s[j] = s[b * ncp + j];
    sh_d0[j] = th[3 + j];
    sh_dd[j] = dr[3 + j];
  }
  split_coefs(th + 3 + ncp, mm, sh_ba0, sh_bm0, F);
  split_coefs(dr + 3 + ncp, mm, sh_bad, sh_bmd, F);
  __syncthreads();
  const float k0 = th[0], m0 = th[1];
  const float kd = dr[0], md = dr[1];

  float s00 = 0.0f, s01 = 0.0f, s02 = 0.0f, s11 = 0.0f, s12 = 0.0f,
        s22 = 0.0f, nobs = 0.0f;
  const float* xs_row = xs + b * xs_bstride;
  for (int c = tid; c < T; c += kThreads) {
    const long long cell = b * T + c;
    const float tv = t[cell];
    const float g0 = linear_trend(tv, k0, m0, sh_s, sh_d0, ncp);
    const float gd = linear_trend(tv, kd, md, sh_s, sh_dd, ncp);
    const float* xrow = xs_row + (long long)c * Fs;
    const float* rrow = xr + cell * R;
    float a0, mu0, ad, mud;
    feature_totals(xrow, Fs, rrow, R, sh_ba0, sh_bm0, &a0, &mu0);
    feature_totals(xrow, Fs, rrow, R, sh_bad, sh_bmd, &ad, &mud);
    const float mk = mask[cell];
    const float c0 = g0 * (1.0f + mu0) + a0;
    const float c1 = gd * (1.0f + mu0) + g0 * mud + ad;
    const float c2 = gd * mud;
    const float r0 = (y[cell] - c0) * mk;
    const float c1m = c1 * mk;
    const float c2m = c2 * mk;
    s00 = s00 + r0 * r0;
    s01 = s01 + r0 * c1m;
    s02 = s02 + r0 * c2m;
    s11 = s11 + c1m * c1m;
    s12 = s12 + c1m * c2m;
    s22 = s22 + c2m * c2m;
    nobs = nobs + mk;
  }
  float sums[7] = {s00, s01, s02, s11, s12, s22, nobs};
  for (int q = 0; q < 7; ++q) {
    const float v = block_sum<kThreads>(sums[q], sh_red);
    if (tid == 0) sh_sum[q] = v;
  }
  if (tid == 0) {
    // quad(a, b, c) = 0.5 sum (a/c)^2 + s sum a b / c^2 + 0.5 s^2 sum (b/c)^2
    // over (k, m) and over beta: the three sums of each.
    sh_sum[7] = sq(k0 / k_scale) + sq(m0 / m_scale);
    sh_sum[8] = k0 * kd / (k_scale * k_scale) + m0 * md / (m_scale * m_scale);
    sh_sum[9] = sq(kd / k_scale) + sq(md / m_scale);
    float qa = 0.0f, qb = 0.0f, qc = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float a = th[3 + ncp + f], bb = dr[3 + ncp + f], p = ps[f];
      qa = qa + sq(a / p);
      qb = qb + a * bb / (p * p);
      qc = qc + sq(bb / p);
    }
    sh_sum[10] = qa;
    sh_sum[11] = qb;
    sh_sum[12] = qc;
  }
  __syncthreads();
  const float ls0 = th[2], lsd = dr[2];
  for (int kk = tid; kk < K; kk += kThreads) {
    const float st = ladder[(long long)kk * B + b];
    const float s2 = st * st;
    const float sigma = kSigmaFloor + expf(ls0 + st * lsd);
    const float poly = sh_sum[0] - 2.0f * st * sh_sum[1] +
                       s2 * (sh_sum[3] - 2.0f * sh_sum[2]) +
                       2.0f * st * s2 * sh_sum[4] + s2 * s2 * sh_sum[5];
    const float ssr = poly < 0.0f ? 0.0f : poly;  // NaN stays NaN
    const float nll = 0.5f * ssr / (sigma * sigma) + sh_sum[6] * logf(sigma);
    float prior = 0.5f * sh_sum[7] + st * sh_sum[8] + 0.5f * st * st * sh_sum[9];
    if (F > 0)
      prior = prior + (0.5f * sh_sum[10] + st * sh_sum[11] +
                       0.5f * st * st * sh_sum[12]);
    prior = prior + 0.5f * sq(sigma / sigma_scale);
    float lap = 0.0f;
    for (int j = 0; j < ncp; ++j)
      lap = lap + smooth_abs(sh_d0[j] + st * sh_dd[j]) / cp_scale;
    prior = prior + lap;
    out[(long long)kk * B + b] = nll + prior;
  }
}

}  // namespace

extern "C" int tsspark_fan(
    const float* theta, const float* dir, const float* ladder, const float* t,
    const float* y, const float* mask, const float* s, const float* xs,
    long long xs_bstride, const float* xr, const float* ps, const float* mm,
    float* out, int B, int T, int P, int ncp, int Fs, int R, int K,
    float k_scale, float m_scale, float sigma_scale, float cp_scale,
    void* stream) {
  if (B == 0 || K == 0) return 0;
  const int F = Fs + R;
  const size_t shmem =
      sizeof(float) * (3 * ncp + 4 * F + kThreads / 32 + 13);
  fan_kernel<<<B, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      theta, dir, ladder, t, y, mask, s, xs, xs_bstride, xr, ps, mm, out, B,
      T, P, ncp, Fs, R, K, k_scale, m_scale, sigma_scale, cp_scale);
  return static_cast<int>(cudaGetLastError());
}
