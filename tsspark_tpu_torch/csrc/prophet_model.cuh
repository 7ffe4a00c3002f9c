// Device functions shared by the port's model kernels: K1 `forward`
// (forward.cu), K3 `loss` (loss.cu), K4 `fan` (fan.cu) and K6 `draws`
// (draws.cu).
//
// One definition of the trend, the feature totals, the noise floor and the
// priors, so the served forecast, the fit's objective and its line-search
// fan add the same terms in the same order.  A change to the model goes
// here, and all three kernels pick it up (kernels/build.py hashes this
// header into the library's name, so an edit rebuilds them).
//
// The linear trend is taken in its prefix form.  With the n = #{j: s_j < t}
// active changepoints (s ascending, as design.py builds it: quantiles of
// sorted times, or the config's sorted explicit list),
//   k t + m + sum_{j<n} delta_j (t - s_j) = (k + D_n) t + (m - E_n),
//   D_n = delta_0 + ... + delta_{n-1},  E_n = delta_0 s_0 + ... ,
// so a cell costs O(1) once n is known: K1, K3 and K4 carry it along each
// lane's ascending walk over T, K6 a sample's D_n and E_n along its row.  D and E are summed in changepoint order.
// The feature totals run in feature order, the order of the plain PyTorch
// versions (design._component): the Fs seasonal columns, then the R
// regressor columns, then the two added.
//
// The logistic trend cap * sigmoid((k + D_n) (t - (m + G_n))) takes the
// same prefix form, with n = #{j: s_j <= t} (a changepoint is active AT
// its own time, as trend.step_weighted_sum has it) and G_n the running
// sum of the offset recursion's gammas.  That recursion divides by
// k_j = k + D_{j+1} and is ill-conditioned where k_j nears 0, so its
// steps (logistic_step) round every operation on its own, without fused
// multiply-adds, in the plain version's order: K1, K2 and K3 then hold
// the plain version's D and G bits exactly, and only the sigmoid may
// differ by an ulp.
//
// This header also holds the bulk-copy (TMA) staging helpers K1, K3 and K4
// share and the fixed-order warp sums of K3 and K4.
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

// D_n and E_n of the prefix form, n = 0..ncp (D, E hold ncp + 1 floats),
// summed in changepoint order.  Sequential; one thread runs it.
// One step of the prefix sums: (d, e) = (D_j, E_j) -> (D_{j+1}, E_{j+1}).
__device__ __forceinline__ void linear_prefix_step(float& d, float& e,
                                                   float delta_j, float s_j) {
  d = d + delta_j;
  e = e + delta_j * s_j;
}

__device__ __forceinline__ void linear_prefix(const float* s,
                                              const float* delta, float* D,
                                              float* E, int ncp) {
  float d = 0.0f, e = 0.0f;
  D[0] = 0.0f;
  E[0] = 0.0f;
  for (int j = 0; j < ncp; ++j) {
    linear_prefix_step(d, e, delta[j], s[j]);
    D[j + 1] = d;
    E[j + 1] = e;
  }
}

// n = #{j : s_j < tv} for ascending s, moved from any start n; a NaN tv
// gives 0 (its trend is NaN either way).
__device__ __forceinline__ int active_changepoints(float tv, const float* s,
                                                   int ncp, int n) {
  while (n < ncp && s[n] < tv) ++n;
  while (n > 0 && !(s[n - 1] < tv)) --n;
  return n;
}

// The line of the trend between changepoints n - 1 and n:
// k*t + m + sum_j delta_j * relu(t - s_j) = slope * t + intercept there,
// slope = k + D[n], intercept = m - E[n] (the prefix form).
struct Line {
  float slope, intercept;
};

__device__ __forceinline__ Line segment_line(float k, float m, float Dn,
                                             float En) {
  return {k + Dn, m - En};
}

__device__ __forceinline__ float linear_trend(float tv, Line line) {
  return line.slope * tv + line.intercept;
}

// One step of the logistic offset recursion (trend._logistic_gamma) for
// the changepoint at s_j with rate change delta_j:
//   csum += delta_j;  k_j = k + csum;
//   gamma_j = (s_j - m - gamma_sum) * (1 - k_{j-1} / k_j);
//   gamma_sum += gamma_j;  k_prev = k_j
// every operation rounded on its own (no contraction into a fused
// multiply-add), in the plain version's order, so csum, k_j and gamma_sum
// are the plain version's bits.  Returns gamma_j.
__device__ __forceinline__ float logistic_step(float k, float m, float s_j,
                                               float delta_j, float& csum,
                                               float& k_prev,
                                               float& gamma_sum) {
  const float eps = 1e-10f;
  csum = __fadd_rn(csum, delta_j);
  const float k_next = __fadd_rn(k, csum);
  const float den = fabsf(k_next) < eps ? (k_next < 0.0f ? -eps : eps)
                                        : k_next;
  const float q = __fdiv_rn(k_prev, den);
  const float g = __fmul_rn(__fsub_rn(__fsub_rn(s_j, m), gamma_sum),
                            __fsub_rn(1.0f, q));
  gamma_sum = __fadd_rn(gamma_sum, g);
  k_prev = k_next;
  return g;
}

// gamma_j = (s_j - m - sum_{l<j} gamma_l) * (1 - k_{j-1} / k_j),
// k_j = k + (delta_0 + ... + delta_j), by logistic_step.  Sequential; one
// thread runs it.
__device__ __forceinline__ void logistic_gamma(float k, float m,
                                               const float* s,
                                               const float* delta,
                                               float* gamma, int ncp) {
  float gamma_sum = 0.0f, csum = 0.0f;
  float k_prev = k;
  for (int j = 0; j < ncp; ++j)
    gamma[j] = logistic_step(k, m, s[j], delta[j], csum, k_prev, gamma_sum);
}

// D_n (the deltas' running sum) and G_n (the gammas') of the logistic
// prefix form, n = 0..ncp (D, G hold ncp + 1 floats), by logistic_step.
// Sequential; one thread runs it.
__device__ __forceinline__ void logistic_prefix(float k, float m,
                                                const float* s,
                                                const float* delta, float* D,
                                                float* G, int ncp) {
  float gamma_sum = 0.0f, csum = 0.0f;
  float k_prev = k;
  D[0] = 0.0f;
  G[0] = 0.0f;
  for (int j = 0; j < ncp; ++j) {
    logistic_step(k, m, s[j], delta[j], csum, k_prev, gamma_sum);
    D[j + 1] = csum;
    G[j + 1] = gamma_sum;
  }
}

// n = #{j : s_j <= tv} for ascending s, moved from any start n (the
// logistic trend's count: a changepoint is active at its own time); a NaN
// tv gives 0.
__device__ __forceinline__ int active_changepoints_at(float tv,
                                                      const float* s, int ncp,
                                                      int n) {
  while (n < ncp && s[n] <= tv) ++n;
  while (n > 0 && !(s[n - 1] <= tv)) --n;
  return n;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The logistic trend from the active changepoints' sums of rate changes
// (rate = D_n) and of offsets (off = G_n):
// cap * sigmoid((k + rate) * (t - (m + off))).
__device__ __forceinline__ float logistic_at(float tv, float capv, float k,
                                             float m, float rate, float off) {
  const float x = (k + rate) * (tv - (m + off));
  return capv * sigmoid(x);
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
  return logistic_at(tv, capv, k, m, rate, off);
}

// A feature's coefficient beta split by its multiplicative mask mf into the
// additive and the multiplicative total's coefficients.
__device__ __forceinline__ void split_coefficient(float beta, float mf,
                                                  float& a, float& m) {
  a = beta * (1.0f - mf);
  m = beta * mf;
}

// Feature totals of C cells of one row at once, 32 steps apart (a lane's
// cells of a tile): cell q's seasonal row at x0 + 32 q Fs (Fs even: 8-byte
// aligned rows, read two columns at a time), its regressor row at
// r0 + 32 q R; each coefficient read once for all C cells.  Per cell, the Fs seasonal columns are summed in
// order, then the R regressor columns, then the two added: the order of
// the plain version (design._component).
template <int C>
__device__ __forceinline__ void feature_totals(const float* x0, int Fs,
                                               const float* r0, int R,
                                               const float* ba,
                                               const float* bm, float* add,
                                               float* mult) {
  float add_s[C], mult_s[C], add_r[C], mult_r[C];
#pragma unroll
  for (int q = 0; q < C; ++q)
    add_s[q] = mult_s[q] = add_r[q] = mult_r[q] = 0.0f;
  if ((Fs & 1) == 0) {
    for (int f = 0; f < Fs; f += 2) {
      const float2 a = *reinterpret_cast<const float2*>(ba + f);
      const float2 m = *reinterpret_cast<const float2*>(bm + f);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float2 x =
            *reinterpret_cast<const float2*>(x0 + 32 * q * Fs + f);
        add_s[q] = add_s[q] + a.x * x.x;
        mult_s[q] = mult_s[q] + m.x * x.x;
        add_s[q] = add_s[q] + a.y * x.y;
        mult_s[q] = mult_s[q] + m.y * x.y;
      }
    }
  } else {
    for (int f = 0; f < Fs; ++f) {
      const float a = ba[f], m = bm[f];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float x = x0[32 * q * Fs + f];
        add_s[q] = add_s[q] + a * x;
        mult_s[q] = mult_s[q] + m * x;
      }
    }
  }
  for (int r = 0; r < R; ++r) {
    const float a = ba[Fs + r], m = bm[Fs + r];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float x = r0[32 * q * R + r];
      add_r[q] = add_r[q] + a * x;
      mult_r[q] = mult_r[q] + m * x;
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q) {
    add[q] = add_s[q] + add_r[q];
    mult[q] = mult_s[q] + mult_r[q];
  }
}

// Feature totals of C consecutive cells of one row with its own
// coefficients (K6: every sample of a row has its own; C = 4, or 1 for a
// tile's last steps): coef(f, a, m) gives feature f's additive and
// multiplicative coefficients, fetched once for the C cells; xs and xr
// hold the cells' seasonal and regressor values transposed, feature f's
// C at xs + f ld (for C = 4 one 16-byte-aligned load: xs and ld multiples
// of 4 floats) and regressor r's at xr + r ld.  Per cell, the order of
// feature_totals: the Fs seasonal columns, then the R regressor columns,
// then the two added.
template <int C, class Coef>
__device__ __forceinline__ void feature_totals_steps(const float* xs, int Fs,
                                                     const float* xr, int R,
                                                     int ld, Coef coef,
                                                     float* add, float* mult) {
  static_assert(C == 1 || C == 4, "one cell or four");
  float add_s[C], mult_s[C], add_r[C], mult_r[C];
#pragma unroll
  for (int q = 0; q < C; ++q)
    add_s[q] = mult_s[q] = add_r[q] = mult_r[q] = 0.0f;
  const auto cells = [&](const float* p, float* x) {
    if constexpr (C == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = p[0];
    }
  };
  for (int f = 0; f < Fs; ++f) {
    float a, m, x[C];
    coef(f, a, m);
    cells(xs + f * ld, x);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      add_s[q] = add_s[q] + a * x[q];
      mult_s[q] = mult_s[q] + m * x[q];
    }
  }
  for (int r = 0; r < R; ++r) {
    float a, m, x[C];
    coef(Fs + r, a, m);
    cells(xr + r * ld, x);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      add_r[q] = add_r[q] + a * x[q];
      mult_r[q] = mult_r[q] + m * x[q];
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q) {
    add[q] = add_s[q] + add_r[q];
    mult[q] = mult_s[q] + mult_r[q];
  }
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

// Whether any of the F features is multiplicative: one load a lane, then
// a vote (a loop of dependent loads would stall every block's start).
__device__ __forceinline__ bool any_multiplicative(const float* mm, int F) {
  bool any = false;
  for (int f = threadIdx.x & 31; f < F; f += 32) any = any || mm[f] != 0.0f;
  return __any_sync(0xffffffffu, any);
}

// Sum of v over the 32 lanes of a warp, valid in lane 0: a fixed
// shuffle tree, so a row's sum is the same in any batch.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four floats from shared memory that the compiler may not keep in
// registers across a loop (it would hoist the per-row coefficients of a
// cell loop and run out of registers).
__device__ __forceinline__ float4 lds4_volatile(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ float2 lds2_volatile(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(smem_addr(p)));
  return v;
}

// Hopper's bulk copy engine (TMA, 1-D): a copy of whole 16-byte pieces
// from global to shared memory that reports its bytes to an mbarrier.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// Make the barriers' initialisation and earlier generic writes to shared
// memory visible to the bulk copy engine; the block synchronises after.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order this thread's earlier generic shared-memory writes before its
// later bulk copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// How one thread stages the floats [first, first + n) of an array of
// `total` floats whose base is 16-byte aligned: the 16-byte pieces that
// cover them (from a0, nbulk floats) by one bulk copy into a 16-byte-
// aligned dst; the last floats of the array past its final whole piece
// (ntail, at most 3) by plain loads.  The staged floats start at
// dst + (first & 3).
struct Staged {
  long long a0;
  int nbulk, ntail;
};

__device__ __forceinline__ Staged stage_plan(long long first, int n,
                                             long long total) {
  Staged st;
  st.a0 = first & ~3ll;
  const long long whole = total & ~3ll;
  long long a1 = (first + n + 3) & ~3ll;
  if (a1 > whole) a1 = whole;
  st.nbulk = a1 > st.a0 ? static_cast<int>(a1 - st.a0) : 0;
  const long long end = first + n;
  st.ntail = end > st.a0 + st.nbulk
                 ? static_cast<int>(end - (st.a0 + st.nbulk))
                 : 0;
  return st;
}

// The plain-load part of a staged copy (issued before the barrier's
// arrival), then the bulk part (after it).
__device__ __forceinline__ void stage_tail(float* dst, const float* base,
                                           const Staged& st) {
  for (int j = 0; j < st.ntail; ++j)
    dst[st.nbulk + j] = base[st.a0 + st.nbulk + j];
}

__device__ __forceinline__ void stage_bulk(float* dst, const float* base,
                                           const Staged& st,
                                           unsigned long long* bar) {
  if (st.nbulk > 0) bulk_copy(dst, base + st.a0, 4u * st.nbulk, bar);
}

// The row pipeline of K3 and K4 (loss.cu, fan.cu).  A block is
// kRowWarps row warps, one series row each, and one producer warp.  The
// producer keeps a kStages-deep ring of T tiles in flight through the bulk
// copy engine: lane w copies row w's t, y, mask and regressor cells, lane
// 31 the tile's shared seasonal slice once for all rows (per series, each
// row lane its own slice).  Stage s has two mbarriers: full[s] (bars[s])
// counts the producer lanes' arrivals and bytes, empty[s]
// (bars[kStages + s]) one arrival from each live row done with it.
constexpr int kRowWarps = 7;
constexpr int kPipeThreads = 32 * (kRowWarps + 1);
constexpr int kStages = 2;
constexpr int kSharedTile = 128;
constexpr int kSeriesTile = 32;
constexpr int kMaxSmemBytes = 232448;  // a block's shared memory, sm_90

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// One stage, in floats: each staged row's slot (t, y, mask, the capacity
// where the trend is logistic, and regressor cells, 8 floats of room each
// for the 16-byte pieces around them), then the seasonal slice(s) with kFs
// floats of room past the last cell's columns.  `rows` staged rows: one a
// row warp, or one for the whole block where its row warps share a data
// row (K3's trial-stack layout).
struct StageLayout {
  int tile, t, y, m, c, r, row, x0, x1, size;
  __host__ __device__ StageLayout(int kFs, int Fs, int R, bool per_series,
                                  bool cap = false, int rows = kRowWarps) {
    tile = per_series ? kSeriesTile : kSharedTile;
    t = 0;
    y = t + tile + 8;
    m = y + tile + 8;
    c = m + tile + 8;
    r = cap ? c + tile + 8 : c;
    row = r + round4(tile * R) + 8;
    x0 = rows * row;
    x1 = round4(tile * Fs) + 8 + kFs;
    size = x0 + (per_series ? rows : 1) * x1;
  }
};

// full[s] expects the producer lanes of `nstaged` staged rows (and the
// shared seasonal slice's lane), empty[s] the `nlive` row warps.
__device__ __forceinline__ void pipeline_init(unsigned long long* bars,
                                              int nlive, bool per_series,
                                              int nstaged) {
  for (int s = threadIdx.x; s < kStages; s += blockDim.x) {
    mbar_init(bars + s, per_series ? 2 * nstaged : nstaged + 1);
    mbar_init(bars + kStages + s, nlive);
  }
}

// One staged copy from one thread: the plain loads, the thread's arrival
// on `full` with the bytes it expects, the bulk copy.
__device__ __forceinline__ void stage_arrive(float* dst, const float* base,
                                             long long first, int n,
                                             long long total,
                                             unsigned long long* full) {
  const Staged p = stage_plan(first, n, total);
  stage_tail(dst, base, p);
  mbar_arrive_expect(full, 4u * p.nbulk);
  fence_proxy_async();
  stage_bulk(dst, base, p, full);
}

// The producer warp's whole walk over T for the nrows staged rows row0 ..
// row0 + nrows - 1 (slot w: data row (row0 + w) % B), every tile once its
// stage is empty; with kCap, each row's capacity cells too.
template <bool kCap = false>
__device__ __forceinline__ void produce_tiles(
    float* stages, const StageLayout& sl, unsigned long long* bars, int nrows,
    long long row0, int B, int T, int R, int Fs, const float* t,
    const float* y, const float* mask, const float* xr, const float* xs,
    long long xs_bstride, const float* cap = nullptr) {
  const int lane = threadIdx.x & 31;
  const bool per_series = xs_bstride != 0;
  const bool row_lane = lane < nrows;
  const long long b = row_lane ? (row0 + lane) % B : 0;
  const bool x_lane = per_series ? row_lane : lane == 31;
  const long long cells = static_cast<long long>(B) * T;
  const long long xs_total =
      per_series ? cells * Fs : static_cast<long long>(T) * Fs;
  const int ntiles = (T + sl.tile - 1) / sl.tile;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(bars + kStages + s, ((it / kStages) - 1) & 1);
    const int t0 = it * sl.tile;
    const int n = min(sl.tile, T - t0);
    float* stage = stages + s * sl.size;
    unsigned long long* full = bars + s;
    if (row_lane) {
      float* slot = stage + lane * sl.row;
      const long long c0 = b * T + t0;
      const Staged pt = stage_plan(c0, n, cells);
      const Staged pr = stage_plan(c0 * R, n * R, cells * R);
      stage_tail(slot + sl.t, t, pt);
      stage_tail(slot + sl.y, y, pt);
      stage_tail(slot + sl.m, mask, pt);
      if (kCap) stage_tail(slot + sl.c, cap, pt);
      stage_tail(slot + sl.r, xr, pr);
      mbar_arrive_expect(full, 4u * ((kCap ? 4 : 3) * pt.nbulk + pr.nbulk));
      fence_proxy_async();
      stage_bulk(slot + sl.t, t, pt, full);
      stage_bulk(slot + sl.y, y, pt, full);
      stage_bulk(slot + sl.m, mask, pt, full);
      if (kCap) stage_bulk(slot + sl.c, cap, pt, full);
      stage_bulk(slot + sl.r, xr, pr, full);
    }
    if (x_lane)
      stage_arrive(stage + sl.x0 + (per_series ? lane * sl.x1 : 0), xs,
                   b * xs_bstride + static_cast<long long>(t0) * Fs, n * Fs,
                   xs_total, full);
  }
}

}  // namespace tsspark
