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
// 3.35 TB/s.  Design: one block per (series row, tile of T).  The row's
// parameters, its changepoints and the per-feature additive and
// multiplicative coefficients are staged once in shared memory (the
// logistic offsets gamma too: their recursion over changepoints runs
// once per block, before the T loop).  Each thread takes one cell and
// keeps every sum in registers; neighbouring threads take neighbouring
// t, so the loads of t and cap and the four stores are coalesced.  A
// shared (T, F) feature matrix has batch stride 0 and stays in L2.
// The sums run in changepoint and feature order, the order of the
// plain PyTorch version.

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

__global__ void forward_kernel(
    const float* __restrict__ theta,    // (B, P)
    const float* __restrict__ t,        // (B, T)
    const float* __restrict__ s,        // (B, ncp)
    const float* __restrict__ cap,      // (B, T), logistic growth only
    const float* __restrict__ xs,       // (T, Fs) or (B, T, Fs)
    long long xs_bstride,               // 0 (shared) or T * Fs
    const float* __restrict__ xr,       // (B, T, R)
    const float* __restrict__ mm,       // (Fs + R,) multiplicative mask
    const float* __restrict__ y_scale,  // (B,) or null
    const float* __restrict__ floor_,   // (B,) or null
    float* __restrict__ yhat, float* __restrict__ trend,
    float* __restrict__ add_out, float* __restrict__ mult_out,
    int T, int P, int ncp, int Fs, int R, int growth) {
  extern __shared__ float sh[];
  const int F = Fs + R;
  float* sh_s = sh;                 // ncp changepoints
  float* sh_delta = sh_s + ncp;     // ncp rate changes
  float* sh_gamma = sh_delta + ncp; // ncp logistic offsets
  float* sh_ba = sh_gamma + ncp;    // F additive coefficients
  float* sh_bm = sh_ba + F;         // F multiplicative coefficients

  const long long b = blockIdx.x;
  const float* th = theta + b * P;
  for (int j = threadIdx.x; j < ncp; j += blockDim.x) {
    sh_s[j] = s[b * ncp + j];
    sh_delta[j] = th[3 + j];
  }
  split_coefs(th + 3 + ncp, mm, sh_ba, sh_bm, F);
  __syncthreads();
  const float k = th[0];
  const float m = th[1];
  if (growth == kLogistic && threadIdx.x == 0)
    logistic_gamma(k, m, sh_s, sh_delta, sh_gamma, ncp);
  __syncthreads();

  const int tt = blockIdx.y * blockDim.x + threadIdx.x;
  if (tt >= T) return;
  const long long cell = b * T + tt;
  const float tv = t[cell];

  float g;
  if (growth == kLinear) {
    g = linear_trend(tv, k, m, sh_s, sh_delta, ncp);
  } else if (growth == kLogistic) {
    g = logistic_trend(tv, cap[cell], k, m, sh_s, sh_delta, sh_gamma, ncp);
  } else {
    g = m;
  }

  float add, mult;
  feature_totals(xs + b * xs_bstride + (long long)tt * Fs, Fs, xr + cell * R,
                 R, sh_ba, sh_bm, &add, &mult);
  const float y = g * (1.0f + mult) + add;
  if (y_scale != nullptr) {
    const float sc = y_scale[b];
    const float fl = floor_[b];
    yhat[cell] = __fadd_rn(__fmul_rn(y, sc), fl);
    trend[cell] = __fadd_rn(__fmul_rn(g, sc), fl);
    add_out[cell] = __fmul_rn(add, sc);
  } else {
    yhat[cell] = y;
    trend[cell] = g;
    add_out[cell] = add;
  }
  mult_out[cell] = mult;
}

}  // namespace

extern "C" int tsspark_forward(
    const float* theta, const float* t, const float* s, const float* cap,
    const float* xs, long long xs_bstride, const float* xr, const float* mm,
    const float* y_scale, const float* floor_,
    float* yhat, float* trend, float* add_out, float* mult_out,
    int B, int T, int P, int ncp, int Fs, int R, int growth, void* stream) {
  if (B == 0 || T == 0) return 0;
  const int tile = T <= 32 ? 32 : (T <= 64 ? 64 : 128);
  const dim3 grid(B, (T + tile - 1) / tile);
  const size_t shmem = sizeof(float) * (3 * ncp + 2 * (Fs + R));
  forward_kernel<<<grid, tile, shmem, static_cast<cudaStream_t>(stream)>>>(
      theta, t, s, cap, xs, xs_bstride, xr, mm, y_scale, floor_,
      yhat, trend, add_out, mult_out, T, P, ncp, Fs, R, growth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tsspark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
