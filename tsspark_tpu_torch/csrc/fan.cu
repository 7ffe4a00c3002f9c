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
// columns once (343 MB at 8192 x 1746 for config 3); the seasonal matrix
// is shared; the issue rate binds first (~120 instructions a cell).
// Design: K3's (loss.cu): 7 row warps and a producer warp per block, the
// same bulk-copy (TMA) ring of 128-cell tiles with one staged seasonal
// slice for all seven rows, lane l on cells l, l + 32, ... in ascending
// order.  Both trends share one segment index (theta and d have the same
// changepoints), so each costs two operations a cell in the prefix form.
// The seven sums stay in registers for the whole walk and meet once, in
// one fixed shuffle tree each within the warp: no shared-memory
// reductions and no block barriers.  Then the row's lanes take its rungs,
// (row, rung) pairs across the block.  The order depends only on T and
// the row's own data: a row's fan is the same bits in any batch, and
// nothing is atomic.  Limits as K3's.

#include <cuda_runtime.h>

#include "prophet_model.cuh"

namespace {

using namespace tsspark;

// Shared-memory plan of one block, in floats: the stages' mbarriers; per
// warp theta, d, s, the prefix sums of theta's and d's delta, the seasonal
// coefficients of theta and d (additive, multiplicative; kFs each, zero
// past Fs), the same for the regressors (zero past R, to a multiple of
// 4), 16 reduced sums and the prior scales; per stage, as K3's.
struct Plan {
  StageLayout sl;
  int R4, th, dr, s, D0, E0, Dd, Ed, ba0, bm0, bad, bmd, bar0, bmr0, bard,
      bmrd, sums, ps, row, rows0, total;
  __host__ __device__ Plan(int kFs, int P, int ncp, int Fs, int R,
                           bool per_series)
      : sl(kFs, Fs, R, per_series) {
    R4 = round4(R);
    th = 0;
    dr = th + round4(P);
    s = dr + round4(P);
    D0 = s + round4(ncp);
    E0 = D0 + round4(ncp + 1);
    Dd = E0 + round4(ncp + 1);
    Ed = Dd + round4(ncp + 1);
    ba0 = Ed + round4(ncp + 1);
    bm0 = ba0 + kFs;
    bad = bm0 + kFs;
    bmd = bad + kFs;
    bar0 = bmd + kFs;
    bmr0 = bar0 + R4;
    bard = bmr0 + R4;
    bmrd = bard + R4;
    sums = bmrd + R4;
    ps = sums + 16;
    row = ps + round4(Fs + R);
    rows0 = 4 * kStages;
    total = rows0 + kRowWarps * row + kStages * sl.size;
  }
};

// sum_f c_f x_f in column order; kVolatile keeps the coefficients out of
// registers (see lds4_volatile).
template <int kFs, bool kVolatile = false>
__device__ __forceinline__ float dot4(const float* c, const float (&x)[kFs]) {
  float acc = 0.0f;
#pragma unroll
  for (int f = 0; f < kFs; f += 4) {
    const float4 v = kVolatile ? lds4_volatile(c + f)
                               : *reinterpret_cast<const float4*>(c + f);
    acc = acc + v.x * x[f];
    acc = acc + v.y * x[f + 1];
    acc = acc + v.z * x[f + 2];
    acc = acc + v.w * x[f + 3];
  }
  return acc;
}

template <int kFs>
__global__ void __launch_bounds__(kPipeThreads, kFs <= 24 ? 2 : 1)
    fan_kernel(
    const float* __restrict__ theta,   // (B, P)
    const float* __restrict__ dir,     // (B, P)
    const float* __restrict__ ladder,  // (K, B)
    const float* __restrict__ t,       // (B, T), ascending along T
    const float* __restrict__ y,       // (B, T)
    const float* __restrict__ mask,    // (B, T)
    const float* __restrict__ s,       // (B, ncp), ascending
    const float* __restrict__ xs,      // (T, Fs) or (B, T, Fs)
    long long xs_bstride,              // 0 (shared) or T * Fs
    const float* __restrict__ xr,      // (B, T, R)
    const float* __restrict__ ps,      // (F,) feature prior scales
    const float* __restrict__ mm,      // (F,) multiplicative mask
    float* __restrict__ out,           // (K, B)
    int B, int T, int P, int ncp, int Fs, int R, int K, float k_scale,
    float m_scale, float sigma_scale, float cp_scale) {
  extern __shared__ __align__(16) float sh[];
  const bool per_series = xs_bstride != 0;
  const Plan pl(kFs, P, ncp, Fs, R, per_series);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowWarps;
  const long long row_id = row0 + warp;
  const int nlive =
      static_cast<int>(min(static_cast<long long>(kRowWarps), B - row0));
  const bool live = warp < kRowWarps && row_id < B;
  const long long b = live ? row_id : 0;
  const int F = Fs + R;
  const int R4 = pl.R4;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sh);
  float* rp = sh + pl.rows0 + warp * pl.row;
  float* r_th = rp + pl.th;
  float* r_dr = rp + pl.dr;
  float* r_s = rp + pl.s;
  float* r_D0 = rp + pl.D0;
  float* r_E0 = rp + pl.E0;
  float* r_Dd = rp + pl.Dd;
  float* r_Ed = rp + pl.Ed;
  float* r_ba0 = rp + pl.ba0;
  float* r_bm0 = rp + pl.bm0;
  float* r_bad = rp + pl.bad;
  float* r_bmd = rp + pl.bmd;
  float* r_bar0 = rp + pl.bar0;
  float* r_bmr0 = rp + pl.bmr0;
  float* r_bard = rp + pl.bard;
  float* r_bmrd = rp + pl.bmrd;
  float* r_sums = rp + pl.sums;
  float* r_ps = rp + pl.ps;
  float* stages = sh + pl.rows0 + kRowWarps * pl.row;

  if (live) {
    for (int j = lane; j < P; j += 32) {
      r_th[j] = theta[b * P + j];
      r_dr[j] = dir[b * P + j];
    }
    for (int j = lane; j < ncp; j += 32) r_s[j] = s[b * ncp + j];
    for (int f = lane; f < F; f += 32) r_ps[f] = ps[f];
    __syncwarp();
    for (int f = lane; f < kFs; f += 32) {
      const bool in = f < Fs;
      const float mf = in ? mm[f] : 0.0f;
      const float b0 = in ? r_th[3 + ncp + f] : 0.0f;
      const float bd = in ? r_dr[3 + ncp + f] : 0.0f;
      split_coefficient(b0, mf, r_ba0[f], r_bm0[f]);
      split_coefficient(bd, mf, r_bad[f], r_bmd[f]);
    }
    for (int r = lane; r < R4; r += 32) {
      const bool in = r < R;
      const float mf = in ? mm[Fs + r] : 0.0f;
      const float b0 = in ? r_th[3 + ncp + Fs + r] : 0.0f;
      const float bd = in ? r_dr[3 + ncp + Fs + r] : 0.0f;
      split_coefficient(b0, mf, r_bar0[r], r_bmr0[r]);
      split_coefficient(bd, mf, r_bard[r], r_bmrd[r]);
    }
    if (lane == 0) linear_prefix(r_s, r_th + 3, r_D0, r_E0, ncp);
    if (lane == 1) linear_prefix(r_s, r_dr + 3, r_Dd, r_Ed, ncp);
  }
  for (int j = tid; j < kStages * pl.sl.size; j += kPipeThreads)
    stages[j] = 0.0f;
  pipeline_init(bars, nlive, per_series, nlive);
  const bool has_mult = any_multiplicative(mm, F);
  fence_async_shared();
  __syncthreads();

  const int ntiles = (T + pl.sl.tile - 1) / pl.sl.tile;
  if (warp == kRowWarps) {
    produce_tiles(stages, pl.sl, bars, nlive, row0, B, T, R, Fs, t, y, mask,
                  xr, xs, xs_bstride);
    return;
  }
  if (!live) return;

  const float inf = __int_as_float(0x7f800000);
  float s00 = 0.0f, s01 = 0.0f, s02 = 0.0f, s11 = 0.0f, s12 = 0.0f,
        s22 = 0.0f, nobs = 0.0f;
  int nl = 0;
  float s_lo = -inf;
  float s_hi = ncp > 0 ? r_s[0] : inf;
  Line line0 = segment_line(r_th[0], r_th[1], 0.0f, 0.0f);  // theta's
  Line lined = segment_line(r_dr[0], r_dr[1], 0.0f, 0.0f);  // d's

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
    for (int cl = lane; cl < n; cl += 32) {
      const float tv = tp[cl];
      if (!(tv > s_lo) || tv > s_hi) {
        nl = active_changepoints(tv, r_s, ncp, nl);
        s_lo = nl > 0 ? r_s[nl - 1] : -inf;
        s_hi = nl < ncp ? r_s[nl] : inf;
        line0 = segment_line(r_th[0], r_th[1], r_D0[nl], r_E0[nl]);
        lined = segment_line(r_dr[0], r_dr[1], r_Dd[nl], r_Ed[nl]);
      }
      const float g0 = linear_trend(tv, line0);
      const float gd = linear_trend(tv, lined);
      float xv[kFs];
      const float* xrow = xp + cl * Fs;
#pragma unroll
      for (int f = 0; f < kFs; f += 2) {
        const float2 v = *reinterpret_cast<const float2*>(xrow + f);
        xv[f] = v.x;
        xv[f + 1] = v.y;
      }
      const float a0s = dot4<kFs>(r_ba0, xv);
      const float ads = dot4<kFs>(r_bad, xv);
      float mu0s = 0.0f, muds = 0.0f;
      if (has_mult) {
        mu0s = dot4<kFs, true>(r_bm0, xv);
        muds = dot4<kFs, true>(r_bmd, xv);
      }
      // Regressors four at a time (zero coefficients past R).
      const float* xq = rxp + cl * R;
      float a0r = 0.0f, mu0r = 0.0f, adr = 0.0f, mudr = 0.0f;
      for (int r = 0; r < R; r += 4) {
        const float x[4] = {xq[r], xq[r + 1], xq[r + 2], xq[r + 3]};
        const float4 c0r = *reinterpret_cast<const float4*>(r_bar0 + r);
        const float4 cdr = *reinterpret_cast<const float4*>(r_bard + r);
        a0r = a0r + c0r.x * x[0];
        a0r = a0r + c0r.y * x[1];
        a0r = a0r + c0r.z * x[2];
        a0r = a0r + c0r.w * x[3];
        adr = adr + cdr.x * x[0];
        adr = adr + cdr.y * x[1];
        adr = adr + cdr.z * x[2];
        adr = adr + cdr.w * x[3];
        if (has_mult) {
          const float4 e0 = lds4_volatile(r_bmr0 + r);
          const float4 ed = lds4_volatile(r_bmrd + r);
          mu0r = mu0r + e0.x * x[0];
          mu0r = mu0r + e0.y * x[1];
          mu0r = mu0r + e0.z * x[2];
          mu0r = mu0r + e0.w * x[3];
          mudr = mudr + ed.x * x[0];
          mudr = mudr + ed.y * x[1];
          mudr = mudr + ed.z * x[2];
          mudr = mudr + ed.w * x[3];
        }
      }
      const float a0 = a0s + a0r, mu0 = mu0s + mu0r;
      const float ad = ads + adr, mud = muds + mudr;
      const float mk = mp[cl];
      const float c0v = g0 * (1.0f + mu0) + a0;
      const float c1 = gd * (1.0f + mu0) + g0 * mud + ad;
      const float c2 = gd * mud;
      const float r0 = (yp[cl] - c0v) * mk;
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
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + kStages + it % kStages);
  }

  const float sums[7] = {s00, s01, s02, s11, s12, s22, nobs};
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const float v = warp_sum(sums[j]);
    if (lane == 0) r_sums[j] = v;
  }
  const float k0 = r_th[0], m0 = r_th[1];
  const float kd = r_dr[0], md = r_dr[1];
  if (lane == 0) {
    // quad(a, b, c) = 0.5 sum (a/c)^2 + s sum a b / c^2 + 0.5 s^2 sum (b/c)^2
    // over (k, m) and over beta: the three sums of each.
    r_sums[7] = sq(k0 / k_scale) + sq(m0 / m_scale);
    r_sums[8] = k0 * kd / (k_scale * k_scale) + m0 * md / (m_scale * m_scale);
    r_sums[9] = sq(kd / k_scale) + sq(md / m_scale);
    float qa = 0.0f, qb = 0.0f, qc = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float a = r_th[3 + ncp + f], bb = r_dr[3 + ncp + f], p = r_ps[f];
      qa = qa + sq(a / p);
      qb = qb + a * bb / (p * p);
      qc = qc + sq(bb / p);
    }
    r_sums[10] = qa;
    r_sums[11] = qb;
    r_sums[12] = qc;
  }
  __syncwarp();
  const float ls0 = r_th[2], lsd = r_dr[2];
  for (int kk = lane; kk < K; kk += 32) {
    const float st = ladder[static_cast<long long>(kk) * B + b];
    const float s2 = st * st;
    const float sigma = kSigmaFloor + expf(ls0 + st * lsd);
    const float poly = r_sums[0] - 2.0f * st * r_sums[1] +
                       s2 * (r_sums[3] - 2.0f * r_sums[2]) +
                       2.0f * st * s2 * r_sums[4] + s2 * s2 * r_sums[5];
    const float ssr = poly < 0.0f ? 0.0f : poly;  // NaN stays NaN
    const float nll = 0.5f * ssr / (sigma * sigma) + r_sums[6] * logf(sigma);
    float prior =
        0.5f * r_sums[7] + st * r_sums[8] + 0.5f * st * st * r_sums[9];
    if (F > 0)
      prior = prior + (0.5f * r_sums[10] + st * r_sums[11] +
                       0.5f * st * st * r_sums[12]);
    prior = prior + 0.5f * sq(sigma / sigma_scale);
    float lap = 0.0f;
    for (int j = 0; j < ncp; ++j)
      lap = lap + smooth_abs(r_th[3 + j] + st * r_dr[3 + j]) / cp_scale;
    prior = prior + lap;
    out[static_cast<long long>(kk) * B + b] = nll + prior;
  }
}

template <int kFs>
int launch(const float* theta, const float* dir, const float* ladder,
           const float* t, const float* y, const float* mask, const float* s,
           const float* xs, long long xs_bstride, const float* xr,
           const float* ps, const float* mm, float* out, int B, int T, int P,
           int ncp, int Fs, int R, int K, float k_scale, float m_scale,
           float sigma_scale, float cp_scale, cudaStream_t st) {
  const Plan pl(kFs, P, ncp, Fs, R, xs_bstride != 0);
  const size_t bytes = sizeof(float) * static_cast<size_t>(pl.total);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fan_kernel<kFs>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int grid = (B + kRowWarps - 1) / kRowWarps;
  kernel<<<grid, kPipeThreads, bytes, st>>>(
      theta, dir, ladder, t, y, mask, s, xs, xs_bstride, xr, ps, mm, out, B,
      T, P, ncp, Fs, R, K, k_scale, m_scale, sigma_scale, cp_scale);
  return static_cast<int>(cudaGetLastError());
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
  const unsigned long long align = reinterpret_cast<unsigned long long>(t) |
      reinterpret_cast<unsigned long long>(y) |
      reinterpret_cast<unsigned long long>(mask) |
      reinterpret_cast<unsigned long long>(xs) |
      reinterpret_cast<unsigned long long>(xr);
  if (Fs % 2 != 0 || Fs > 64 || (align & 15ull) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TSSPARK_FAN(KF)                                                       \
  return launch<KF>(theta, dir, ladder, t, y, mask, s, xs, xs_bstride, xr,    \
                    ps, mm, out, B, T, P, ncp, Fs, R, K, k_scale, m_scale,    \
                    sigma_scale, cp_scale, st)
  if (Fs <= 8) TSSPARK_FAN(8);
  if (Fs <= 16) TSSPARK_FAN(16);
  if (Fs <= 24) TSSPARK_FAN(24);
  if (Fs <= 32) TSSPARK_FAN(32);
  if (Fs <= 48) TSSPARK_FAN(48);
  TSSPARK_FAN(64);
#undef TSSPARK_FAN
}
