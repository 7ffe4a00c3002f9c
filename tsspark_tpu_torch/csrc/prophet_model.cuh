// Device functions shared by the port's model kernels: K1 `forward`
// (forward.cu), K3 `loss` (loss.cu) and K4 `fan` (fan.cu).
//
// One definition of the trend, the feature totals, the noise floor and the
// priors, so the served forecast, the fit's objective and its line-search
// fan add the same terms in the same order.  A change to the model goes
// here, and all three kernels pick it up (kernels/build.py hashes this
// header into the library's name, so an edit rebuilds them).
//
// The sums run in changepoint and feature order, the order of the plain
// PyTorch versions (models/prophet/trend.py, design._component).

#pragma once

#include <cuda_runtime.h>

namespace tsspark {

constexpr int kLinear = 0;
constexpr int kLogistic = 1;
constexpr int kFlat = 2;

// models/prophet/loss.py: _HUBER_EPS (smoothed |delta|) and _SIGMA_FLOOR.
constexpr float kHuberEps = 1e-4f;
constexpr float kSigmaFloor = 1e-5f;

__device__ __forceinline__ float safe_div(float a, float b) {
  const float eps = 1e-10f;
  if (fabsf(b) < eps) b = b < 0.0f ? -eps : eps;
  return a / b;
}

// k*t + m + sum_j delta_j * relu(t - s_j).
__device__ __forceinline__ float linear_trend(float tv, float k, float m,
                                              const float* s,
                                              const float* delta, int ncp) {
  float g = k * tv + m;
  for (int j = 0; j < ncp; ++j) g = g + delta[j] * fmaxf(tv - s[j], 0.0f);
  return g;
}

// gamma_j = (s_j - m - sum_{l<j} gamma_l) * (1 - k_{j-1} / k_j),
// k_j = k + (delta_0 + ... + delta_j), summed in changepoint order exactly
// as the plain version sums it: the recursion is ill-conditioned where k_j
// nears 0.  Sequential; one thread runs it.
__device__ __forceinline__ void logistic_gamma(float k, float m,
                                               const float* s,
                                               const float* delta,
                                               float* gamma, int ncp) {
  float gamma_sum = 0.0f, csum = 0.0f;
  float k_prev = k;
  for (int j = 0; j < ncp; ++j) {
    csum = csum + delta[j];
    const float k_next = k + csum;
    const float g = (s[j] - m - gamma_sum) * (1.0f - safe_div(k_prev, k_next));
    gamma[j] = g;
    gamma_sum = gamma_sum + g;
    k_prev = k_next;
  }
}

// cap * sigmoid((k + A delta) * (t - (m + A gamma))), A = 1[t >= s_j].
__device__ __forceinline__ float logistic_trend(float tv, float capv, float k,
                                                float m, const float* s,
                                                const float* delta,
                                                const float* gamma, int ncp) {
  float rate = 0.0f, off = 0.0f;
  for (int j = 0; j < ncp; ++j) {
    if (tv >= s[j]) {
      rate = rate + delta[j];
      off = off + gamma[j];
    }
  }
  const float x = (k + rate) * (tv - (m + off));
  return capv * (1.0f / (1.0f + expf(-x)));
}

// Additive and multiplicative coefficients of the F = Fs + R features:
// ba_f = beta_f * (1 - mm_f), bm_f = beta_f * mm_f.  Block-strided.
__device__ __forceinline__ void split_coefs(const float* beta, const float* mm,
                                            float* ba, float* bm, int F) {
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float b = beta[f];
    const float m = mm[f];
    ba[f] = b * (1.0f - m);
    bm[f] = b * m;
  }
}

// Feature totals of one cell: the Fs seasonal columns at xrow, then the R
// regressor columns at rrow, each block summed in order, then added.
__device__ __forceinline__ void feature_totals(const float* xrow, int Fs,
                                               const float* rrow, int R,
                                               const float* ba,
                                               const float* bm, float* add,
                                               float* mult) {
  float add_s = 0.0f, mult_s = 0.0f;
  for (int f = 0; f < Fs; ++f) {
    const float x = xrow[f];
    add_s = add_s + ba[f] * x;
    mult_s = mult_s + bm[f] * x;
  }
  float add_r = 0.0f, mult_r = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float x = rrow[r];
    add_r = add_r + ba[Fs + r] * x;
    mult_r = mult_r + bm[Fs + r] * x;
  }
  *add = add_s + add_r;
  *mult = mult_s + mult_r;
}

__device__ __forceinline__ float sigma_of(float log_sigma) {
  return kSigmaFloor + expf(log_sigma);
}

// sqrt(x^2 + eps^2) - eps: the C1 |x| of the changepoint prior.
__device__ __forceinline__ float smooth_abs(float x) {
  return sqrtf(x * x + kHuberEps * kHuberEps) - kHuberEps;
}

__device__ __forceinline__ float smooth_abs_grad(float x) {
  return x / sqrtf(x * x + kHuberEps * kHuberEps);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// Sum of v over the block, valid in thread 0: a fixed shuffle tree in each
// warp, then the warps' sums in warp order.  The order depends on nothing
// but the block size, so a row's sum is the same in any batch.  `scratch`
// holds kThreads / 32 floats; every thread of the block must call.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // scratch may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

}  // namespace tsspark
