// Device functions shared by the port's model kernels: K1 `forward`
// (forward.cu), K3 `loss` (loss.cu) and K4 `fan` (fan.cu).
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
// lane's ascending walk over T.  D and E are summed in changepoint order.
// The feature totals run in feature order, the order of the plain PyTorch
// versions (design._component): the Fs seasonal columns, then the R
// regressor columns, then the two added.
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
__device__ __forceinline__ void linear_prefix(const float* s,
                                              const float* delta, float* D,
                                              float* E, int ncp) {
  float d = 0.0f, e = 0.0f;
  D[0] = 0.0f;
  E[0] = 0.0f;
  for (int j = 0; j < ncp; ++j) {
    d = d + delta[j];
    e = e + delta[j] * s[j];
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

// One stage, in floats: each row's slot (t, y, mask and regressor cells,
// 8 floats of room each for the 16-byte pieces around them), then the
// seasonal slice(s) with kFs floats of room past the last cell's columns.
struct StageLayout {
  int tile, t, y, m, r, row, x0, x1, size;
  __host__ __device__ StageLayout(int kFs, int Fs, int R, bool per_series) {
    tile = per_series ? kSeriesTile : kSharedTile;
    t = 0;
    y = t + tile + 8;
    m = y + tile + 8;
    r = m + tile + 8;
    row = r + round4(tile * R) + 8;
    x0 = kRowWarps * row;
    x1 = round4(tile * Fs) + 8 + kFs;
    size = x0 + (per_series ? kRowWarps : 1) * x1;
  }
};

__device__ __forceinline__ void pipeline_init(unsigned long long* bars,
                                              int nlive, bool per_series) {
  for (int s = threadIdx.x; s < kStages; s += blockDim.x) {
    mbar_init(bars + s, per_series ? 2 * nlive : nlive + 1);
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

// The producer warp's whole walk over T for the rows row0 .. row0 + nlive
// (data row (row0 + w) % B), every tile once its stage is empty.
__device__ __forceinline__ void produce_tiles(
    float* stages, const StageLayout& sl, unsigned long long* bars, int nlive,
    long long row0, int B, int T, int R, int Fs, const float* t,
    const float* y, const float* mask, const float* xr, const float* xs,
    long long xs_bstride) {
  const int lane = threadIdx.x & 31;
  const bool per_series = xs_bstride != 0;
  const bool row_lane = lane < nlive;
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
      stage_tail(slot + sl.r, xr, pr);
      mbar_arrive_expect(full, 4u * (3 * pt.nbulk + pr.nbulk));
      fence_proxy_async();
      stage_bulk(slot + sl.t, t, pt, full);
      stage_bulk(slot + sl.y, y, pt, full);
      stage_bulk(slot + sl.m, mask, pt, full);
      stage_bulk(slot + sl.r, xr, pr, full);
    }
    if (x_lane)
      stage_arrive(stage + sl.x0 + (per_series ? lane * sl.x1 : 0), xs,
                   b * xs_bstride + static_cast<long long>(t0) * Fs, n * Fs,
                   xs_total, full);
  }
}

}  // namespace tsspark
