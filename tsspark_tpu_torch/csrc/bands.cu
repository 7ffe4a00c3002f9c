// K2 `bands`: predictive intervals of the MAP forecast, samples never stored.
//
// Replaces the XLA-fused sampling path of the JAX package (no Pallas
// kernel there either):
//   tsspark_tpu/models/prophet/predict.py  _simulate_trends (linear and
//     flat growth) and the noise draw + jnp.quantile of forecast
// which materializes (S, B, T) trend paths and samples in device memory
// and sorts them along S.
//
// Per series row b and sample s it walks t in order:
//   new_delta = 1[u < cp_prob] * 1[t > 1] * laplace * lam
//   c += new_delta;  d += new_delta * t
//   trend_s = det + t*c - d                 (linear; flat: trend_s = det)
//   sample  = trend_s * (1 + mult) + add + normal * exp(log_sigma)
// with cp_prob and lam computed once per row exactly as predict.py
// does (mean future spacing times n_cp, clipped to [0, 1]; mean |delta|
// floored at 1e-8), and no noise floor on sigma.  At each t the block
// sorts the S samples and the S trend values in shared memory and
// writes the lower and upper quantiles of each with jnp.quantile's
// "linear" rule (position q * (S - 1)), mapped to data units.
//
// Variates: a Philox4x32-10 counter keyed on (seed) with counter
// (t, sample, row) gives the Bernoulli uniform, the Laplace uniform and
// the two Box-Muller uniforms of each draw, so a draw depends on its
// coordinates only.  With given draws (three (S, B, T) tensors: U(0,1),
// standard Laplace, standard normal) the kernel reads them instead,
// which holds it against the plain version on the same variates.
//
// What bounds it: the function needs the simulation (~20 float operations
// per sample and step, variate generation not counted) and two order
// statistics per column, which a selection finds in O(S) work; the bytes
// moved (four (B, T) inputs, four (B, T) outputs) are small beside that.
// This design sorts instead: a bitonic sort of n values is
// (n/2) * log2(n) * (log2(n) + 1) / 2 compare-exchanges, 4,608 for
// n = 256, for each of the two columns at each (b, t), so its cost sits
// far above the function's floor; a selection is the way down.
// Design: one block per row, samples spread over at most 1024 threads
// (SPT samples per thread, S padded with +inf to a power of two n, at
// most kMaxSamples), the running sums c and d in registers, both columns
// sorted together in shared memory, and the four quantiles written by
// four threads.  Nothing of size S*B*T touches device memory unless the
// caller asks for the samples.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLinear = 0;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSamples = 16384;

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(Philox4 c, uint32_t k0,
                                                 uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = Philox4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// [0, 1) with 24 random bits.
__device__ __forceinline__ float u01(uint32_t x) {
  return static_cast<float>(x >> 8) * 5.9604644775390625e-08f;
}

// (0, 1), never 0 or 1: (k + 0.5) / 2^23.
__device__ __forceinline__ float u01_open(uint32_t x) {
  return (static_cast<float>(x >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

__device__ __forceinline__ float quantile_linear(const float* v, int S,
                                                 float q) {
  const float pos = q * static_cast<float>(S - 1);
  const float lo = floorf(pos), hi = ceilf(pos);
  const float hw = pos - lo, lw = 1.0f - hw;
  const int il = min(max(static_cast<int>(lo), 0), S - 1);
  const int ih = min(max(static_cast<int>(hi), 0), S - 1);
  return __fadd_rn(__fmul_rn(v[il], lw), __fmul_rn(v[ih], hw));
}

template <int SPT>
__global__ void __launch_bounds__(kMaxThreads) bands_kernel(
    const float* __restrict__ t,      // (B, T) scaled time
    const float* __restrict__ det,    // (B, T) deterministic trend, scaled
    const float* __restrict__ add,    // (B, T) additive total, scaled
    const float* __restrict__ mult,   // (B, T) multiplicative total
    const float* __restrict__ theta,  // (B, P)
    const float* __restrict__ y_scale, const float* __restrict__ floor_,
    const float* __restrict__ du,     // (S, B, T) or null
    const float* __restrict__ dlap,   // (S, B, T) or null
    const float* __restrict__ dz,     // (S, B, T) or null
    unsigned long long seed, float q_lo, float q_hi,
    float* __restrict__ y_lo, float* __restrict__ y_hi,
    float* __restrict__ tr_lo, float* __restrict__ tr_hi,
    float* __restrict__ samples,      // (S, B, T) or null
    int B, int T, int P, int ncp, int S, int growth) {
  extern __shared__ float sh[];
  const int nt = blockDim.x;
  const int n = nt * SPT;  // power of two >= S
  float* ys = sh;
  float* ts = sh + n;
  __shared__ float sh_cp, sh_lam, sh_sigma;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(row) * T;
  const float* th = theta + static_cast<long long>(row) * P;
  if (tid == 0) {
    float num = 0.0f, cnt = 0.0f, prev = t[base];
    for (int i = 0; i < T; ++i) {
      const float ti = t[base + i];
      const float fut = ti > 1.0f ? 1.0f : 0.0f;
      num = num + (ti - prev) * fut;
      cnt = cnt + fut;
      prev = ti;
    }
    const float mean_dt = num / fmaxf(cnt, 1.0f);
    sh_cp = fminf(fmaxf(static_cast<float>(ncp) * mean_dt, 0.0f), 1.0f);
    float lam = 0.0f;
    if (ncp > 0) {
      for (int j = 0; j < ncp; ++j) lam = lam + fabsf(th[3 + j]);
      lam = lam / static_cast<float>(ncp);
    }
    sh_lam = fmaxf(lam, 1e-8f);
    sh_sigma = expf(th[2]);
  }
  __syncthreads();
  const float cp = sh_cp, lam = sh_lam, sigma = sh_sigma;
  const float sc = y_scale[row], fl = floor_[row];
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  float c[SPT], d[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r) c[r] = d[r] = 0.0f;

  for (int i = 0; i < T; ++i) {
    const long long cell = base + i;
    const float ti = t[cell];
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int s = tid + r * nt;
      float smp = __int_as_float(0x7f800000), trs = smp;  // +inf pads
      if (s < S) {
        float u, lap, z;
        if (du != nullptr) {
          const long long di =
              (static_cast<long long>(s) * B + row) * T + i;
          u = du[di];
          lap = dlap[di];
          z = dz[di];
        } else {
          const Philox4 rn = philox4x32_10(
              Philox4{static_cast<uint32_t>(i), static_cast<uint32_t>(s),
                      static_cast<uint32_t>(row), 0u},
              k0, k1);
          u = u01(rn.x);
          const float v = u01_open(rn.y) - 0.5f;
          lap = v < 0.0f ? log1pf(2.0f * v) : -log1pf(-2.0f * v);
          z = sqrtf(-2.0f * logf(u01_open(rn.z))) * cospif(2.0f * u01(rn.w));
        }
        float tr = det[cell];
        if (growth == kLinear) {
          const float fut = ti > 1.0f ? 1.0f : 0.0f;
          const float ind = (u < cp ? 1.0f : 0.0f) * fut;
          const float nd = ind * (lap * lam);
          c[r] = c[r] + nd;
          d[r] = d[r] + nd * ti;
          tr = tr + ti * c[r] - d[r];
        }
        smp = tr * (1.0f + mult[cell]) + add[cell] + z * sigma;
        trs = tr;
        if (samples != nullptr) {
          samples[(static_cast<long long>(s) * B + row) * T + i] =
              __fadd_rn(__fmul_rn(smp, sc), fl);
        }
      }
      ys[s] = smp;
      ts[s] = trs;
    }
    __syncthreads();
    // Bitonic sort of both columns, ascending: at each stage the n/2
    // pairs (lo, lo + j), lo with bit j clear, are spread over the block.
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = tid; q < (n >> 1); q += nt) {
          const int lo = 2 * q - (q & (j - 1));
          const int hi = lo + j;
          const bool up = (lo & k) == 0;
          const float a = ys[lo], bq = ys[hi];
          if ((a > bq) == up) {
            ys[lo] = bq;
            ys[hi] = a;
          }
          const float ta = ts[lo], tb = ts[hi];
          if ((ta > tb) == up) {
            ts[lo] = tb;
            ts[hi] = ta;
          }
        }
        __syncthreads();
      }
    }
    if (tid < 4) {
      const float* col = tid < 2 ? ys : ts;
      const float q = quantile_linear(col, S, (tid & 1) ? q_hi : q_lo);
      const float out = __fadd_rn(__fmul_rn(q, sc), fl);
      float* dst =
          tid == 0 ? y_lo : (tid == 1 ? y_hi : (tid == 2 ? tr_lo : tr_hi));
      dst[cell] = out;
    }
    __syncthreads();
  }
}

template <int SPT>
cudaError_t launch_bands(int B, int nt, cudaStream_t stream,
                         const float* t, const float* det, const float* add,
                         const float* mult, const float* theta,
                         const float* y_scale, const float* floor_,
                         const float* du, const float* dlap, const float* dz,
                         unsigned long long seed, float q_lo, float q_hi,
                         float* y_lo, float* y_hi, float* tr_lo,
                         float* tr_hi, float* samples, int T, int P,
                         int ncp, int S, int growth) {
  const size_t shmem = sizeof(float) * 2 * nt * SPT;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bands_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  bands_kernel<SPT><<<B, nt, shmem, stream>>>(
      t, det, add, mult, theta, y_scale, floor_, du, dlap, dz, seed, q_lo,
      q_hi, y_lo, y_hi, tr_lo, tr_hi, samples, B, T, P, ncp, S, growth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tsspark_bands(
    const float* t, const float* det, const float* add, const float* mult,
    const float* theta, const float* y_scale, const float* floor_,
    const float* du, const float* dlap, const float* dz,
    unsigned long long seed, float q_lo, float q_hi,
    float* y_lo, float* y_hi, float* tr_lo, float* tr_hi, float* samples,
    int B, int T, int P, int ncp, int S, int growth, void* stream) {
  if (B == 0 || T == 0) return 0;
  int n = 32;
  while (n < S) n <<= 1;
  if (n > kMaxSamples) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nt = n < kMaxThreads ? n : kMaxThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TSSPARK_BANDS_LAUNCH(SPT)                                             \
  launch_bands<SPT>(B, nt, st, t, det, add, mult, theta, y_scale, floor_, du, \
                    dlap, dz, seed, q_lo, q_hi, y_lo, y_hi, tr_lo, tr_hi,     \
                    samples, T, P, ncp, S, growth)
  cudaError_t err;
  switch (n / nt) {
    case 1: err = TSSPARK_BANDS_LAUNCH(1); break;
    case 2: err = TSSPARK_BANDS_LAUNCH(2); break;
    case 4: err = TSSPARK_BANDS_LAUNCH(4); break;
    case 8: err = TSSPARK_BANDS_LAUNCH(8); break;
    default: err = TSSPARK_BANDS_LAUNCH(16); break;
  }
#undef TSSPARK_BANDS_LAUNCH
  return static_cast<int>(err);
}
