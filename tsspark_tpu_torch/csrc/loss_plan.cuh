// K3's shared pieces (loss.cu: the row and trial-stack layouts;
// loss_draws.cuh: the draw-stack layout, built in loss_draws.cu and
// loss_draws_logistic.cu so the three compile side by side): the block's
// shared-memory plan, a row's slot, its objective and logistic growth's
// pull-back, the launch, and the draw-stack layout's entry points.
#pragma once

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace tsspark {

// The draw-stack layout's launch for the seasonal bucket kFs (linear and
// flat growth, and logistic growth), or -1 where its plan passes the
// card's shared memory: loss.cu's launch then runs the row layout.
#define TSSPARK_DRAW_STACK_ARGS                                              \
  int kFs, const float *theta, const float *t, const float *y,               \
      const float *mask, const float *cap, const float *s, const float *xs,  \
      long long xs_bstride, const float *xr, const float *ps,                \
      const float *mm, float *f_out, float *g_out, int N, int B, int T,      \
      int P, int ncp, int Fs, int R, int growth, float k_scale,              \
      float m_scale, float sigma_scale, float cp_scale, cudaStream_t st
int draw_stack(TSSPARK_DRAW_STACK_ARGS);
int draw_stack_logistic(TSSPARK_DRAW_STACK_ARGS);

}  // namespace tsspark

namespace {

using namespace tsspark;

// Shared-memory plan of one block, in floats (the stages' mbarriers come
// first, 2 floats each).  Per warp: theta, s, the prefix sums D and E (G
// for logistic growth), the
// seasonal coefficients (additive, multiplicative, 1 - mm, mm; kFs each,
// zero past Fs), the same four for the regressors (zero past R, to a
// multiple of 4), the boundary snapshots, the row's column sums and the
// prior scales.  Per stage: each row's t, y, mask and regressor cells and
// the seasonal slice(s), each with 8 floats of room for the 16-byte
// pieces around them (and each row's capacity cells for logistic growth).
// Gradient mode: each lane's regressor sums.  The trial-stack layout
// (stack) holds kStackTrials slots and stages one row a stage; the
// draw-stack layout (draws > 1) holds `draws` slots a row warp and each
// lane's regressor sums for each of them.
constexpr int kTrialsPerWarp = 3;
constexpr int kStackTrials = kRowWarps * kTrialsPerWarp;

// Draws a warp of the draw-stack layout: four where four draws' column
// sums fit a lane's registers (kFs <= 32), else two.
__host__ __device__ constexpr int draws_per_warp(int kFs) {
  return kFs <= 32 ? 4 : 2;
}

struct Plan {
  StageLayout sl;
  int R4, th, s, D, E, ba, bm, om, mm, bar, bmr, omr, mmr, snu, snv, res,
      ps, row, rows0, racc, total;
  __host__ __device__ Plan(bool grad, int kFs, int P, int ncp, int Fs, int R,
                           bool per_series, bool logistic, bool stack = false,
                           int draws = 1)
      : sl(kFs, Fs, R, per_series, logistic, stack ? 1 : kRowWarps) {
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
    racc = grad ? R4 * kPipeThreads * draws : 0;
    rows0 = 4 * kStages;
    total = rows0 + (stack ? kStackTrials : kRowWarps * draws) * row +
            kStages * sl.size + racc;
  }
};

// Logistic growth's df/dk, df/dm and df/ddelta of one row (g[0], g[1],
// g[3 .. 3 + ncp)), one lane: the data sums A = sum v (t - off) and
// C = sum v (-rate), their sums before each boundary j < q (sna, snc;
// the suffix past a boundary the walk never crossed is empty), pulled
// back through the offset recursion last changepoint first, as
// kernels/loss.py _logistic_pullback does, then the priors.
__device__ __forceinline__ void logistic_pullback(
    const float* th, const float* s, const float* D, const float* G,
    const float* sna, const float* snc, float A, float C, int q, int ncp,
    float k_scale, float m_scale, float cp_scale, float* g) {
  const float eps = 1e-10f;
  const float k = th[0], m = th[1];
  float g_gsum = 0.0f, g_kprev = 0.0f, gm_rec = 0.0f, tail = 0.0f;
  for (int j = ncp - 1; j >= 0; --j) {
    const float kp = j > 0 ? k + D[j] : k;
    const float kn = k + D[j + 1];
    const float a = (s[j] - m) - G[j];
    const float omq = 1.0f - safe_div(kp, kn);
    const float gd = j < q ? A - sna[j] : 0.0f;
    const float gg = j < q ? C - snc[j] : 0.0f;
    const float g_gamma = gg + g_gsum;
    const float g_a = g_gamma * omq;
    const float g_q = -(g_gamma * a);
    gm_rec = gm_rec - g_a;
    g_gsum = g_gsum - g_a;
    const bool clamped = fabsf(kn) < eps;
    const float safe = clamped ? (kn < 0.0f ? -eps : eps) : kn;
    const float g_kn = g_kprev + (clamped ? 0.0f : -g_q * kp / (safe * safe));
    tail = tail + g_kn;
    g[3 + j] = smooth_abs_grad(th[3 + j]) / cp_scale + (gd + tail);
    g_kprev = g_q / safe;
  }
  g[0] = k / (k_scale * k_scale) + (A + g_kprev + tail);
  g[1] = m / (m_scale * m_scale) + (C + gm_rec);
}

// A row's slot rp, each lane its share: its parameters th, the series'
// changepoints, the prior scales and the split coefficients (seasonal to
// kFs and regressors to a multiple of 4, zero past Fs and R; 1 - mm and
// mm for the gradient).
template <int kFs>
__device__ __forceinline__ void fill_slot(float* rp, const Plan& pl,
                                          const float* th, const float* s_row,
                                          const float* ps, const float* mm,
                                          int P, int ncp, int Fs, int R,
                                          int lane) {
  const int F = Fs + R;
  for (int j = lane; j < P; j += 32) rp[pl.th + j] = th[j];
  for (int j = lane; j < ncp; j += 32) rp[pl.s + j] = s_row[j];
  for (int f = lane; f < F; f += 32) rp[pl.ps + f] = ps[f];
  for (int f = lane; f < kFs; f += 32) {
    const bool in = f < Fs;
    const float be = in ? th[3 + ncp + f] : 0.0f;
    const float mf = in ? mm[f] : 0.0f;
    split_coefficient(be, mf, rp[pl.ba + f], rp[pl.bm + f]);
    rp[pl.om + f] = in ? 1.0f - mf : 0.0f;
    rp[pl.mm + f] = mf;
  }
  for (int r = lane; r < pl.R4; r += 32) {
    const bool in = r < R;
    const float be = in ? th[3 + ncp + Fs + r] : 0.0f;
    const float mf = in ? mm[Fs + r] : 0.0f;
    split_coefficient(be, mf, rp[pl.bar + r], rp[pl.bmr + r]);
    rp[pl.omr + r] = in ? 1.0f - mf : 0.0f;
    rp[pl.mmr + r] = mf;
  }
}

// A row's objective from its walk's warp sums ssr and n_obs: the negative
// log likelihood and the priors, for its parameters r_th and prior scales
// r_ps.
__device__ __forceinline__ float row_objective(
    const float* r_th, const float* r_ps, float ssr, float nobs, int ncp,
    int F, float k_scale, float m_scale, float sigma_scale, float cp_scale) {
  const float k = r_th[0], m = r_th[1];
  const float sigma = sigma_of(r_th[2]);
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
  return nll + prior;
}

// Set a kernel's dynamic shared memory (past 48 KB) and carve-out, then
// launch it on `grid` blocks.
template <class Kernel, class... Args>
int launch_kernel(Kernel kernel, long long grid, size_t bytes,
                  cudaStream_t st, Args... args) {
  if (bytes > kMaxSmemBytes || grid > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Room for two blocks a multiprocessor where they fit.
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kernel<<<static_cast<unsigned>(grid), kPipeThreads, bytes, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
