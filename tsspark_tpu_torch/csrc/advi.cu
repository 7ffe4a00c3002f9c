// K7 `advi`: the ELBO gradient's reduction over the draws and the Adam step
// of batched mean-field ADVI, one launch a step.
//
// Replaces the XLA-fused body of the JAX package's ADVI scan after the loss
// (it has no Pallas kernel; XLA fused the autodiff transpose and the Adam
// update):
//   tsspark_tpu/uncertainty/advi.py  _fit_advi's step (:87-104) with the
//     reduction of _elbo_losses (:65-72)
// Given K3's gradient g_k and loss f_k of each of the K draws
// theta_k = mu + sd * eps_k (sd = exp(rho), K3 in gradient mode on the
// (K B, P) draw stack, row k B + b scored on data row b), per (b, p):
//   g_mu   = sum_k g_k / K
//   g_rho  = (sum_k (g_k / K) eps_k) sd - 1          (the entropy's -1)
//   loss_b = (sum_k f_k,b) / K - sum_p rho_bp        (before the update)
// and Adam on mu and rho:
//   m <- b1 m + (1 - b1) g,  v <- b2 v + ((1 - b2) g) g
//   p <- p - (lr (m / c1)) / (sqrt(v / c2) + eps),  c = 1 - b^t
// with the reference's operation order; each product, sum, quotient and
// root rounded on its own (the _rn intrinsics: no contraction into FMAs).
// The sums over k of g_mu and g_rho run in ascending order; the loss's two
// sums (over the K draws' f and over the P rhos) are lane sums: lane l
// adds the terms l, l + 32, ... in ascending order from 0, then a fixed
// shuffle tree adds the 32 lanes.  So the result is the same bits as the
// plain version (kernels/advi.py `advi_plain`, which takes the same
// order).  mu, rho and the four moments are updated in place; sd comes
// from the wrapper (the same tensor the draw stack was formed with), so no
// transcendental runs here.
//
// What bounds it: bytes.  Per (b, p) the function needs 2K floats of g
// and eps and six of mu, rho and the moments read, and six written,
// against ~4K + 20 float operations: at the M5 fleet's 30,490 x 54 with
// K = 4 that is 132 MB, ~40 us at 3.35 TB/s, against K3's milliseconds on
// the same stack (this kernel also reads sd, one float more).  So the
// design is one pass over memory in wide pieces.  A block takes 32 whole
// series: first each warp takes four of them, one at a time, the lanes
// sharing its two sums (the rhos are read before any is written: a block
// barrier follows); then the block's threads walk the series' (b, p)
// cells as one flat run, kVec floats a load (16-byte pieces where every
// array's base and B P allow, else 8-byte, else single floats; P = 54
// rows are 216 bytes, but 32 of them are whole 16-byte pieces).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSeries = 32;  // series a block

// Sum of v over the 32 lanes, valid in lane 0, each add rounded alone.
__device__ __forceinline__ float lane_tree_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int kVec>
__device__ __forceinline__ void load(const float* p, float* x) {
  using T = typename Vec<kVec>::T;
  const T v = *reinterpret_cast<const T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = f[j];
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float* x) {
  using T = typename Vec<kVec>::T;
  T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) f[j] = x[j];
  *reinterpret_cast<T*>(p) = v;
}

// Adam on one parameter array's kVec cells: moments m, v and the
// parameter x updated from the gradient gr.
template <int kVec>
__device__ __forceinline__ void adam(float* x, float* m, float* v,
                                     const float* gr, float b1, float omb1,
                                     float b2, float omb2, float c1, float c2,
                                     float lr, float adam_eps) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float gj = gr[j];
    m[j] = __fadd_rn(__fmul_rn(b1, m[j]), __fmul_rn(omb1, gj));
    v[j] = __fadd_rn(__fmul_rn(b2, v[j]),
                     __fmul_rn(__fmul_rn(omb2, gj), gj));
    const float num = __fmul_rn(lr, __fdiv_rn(m[j], c1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], c2)), adam_eps);
    x[j] = __fsub_rn(x[j], __fdiv_rn(num, den));
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    advi_kernel(const float* __restrict__ g, const float* __restrict__ f,
                const float* __restrict__ eps, const float* __restrict__ sd,
                float* mu, float* rho, float* m_mu, float* v_mu, float* m_rho,
                float* v_rho, float* __restrict__ loss, int K, int B, int P,
                float inv_k, float b1, float omb1, float b2, float omb2,
                float c1, float c2, float lr, float adam_eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kSeries;
  const long long b1s = min(b0 + kSeries, static_cast<long long>(B));
  // The block's losses, a warp a series at a time.
  for (long long b = b0 + warp; b < b1s; b += kWarps) {
    float sf = 0.0f;
    for (int k = lane; k < K; k += 32)
      sf = __fadd_rn(sf, f[static_cast<long long>(k) * B + b]);
    float sr = 0.0f;
    for (int p = lane; p < P; p += 32) sr = __fadd_rn(sr, rho[b * P + p]);
    sf = lane_tree_sum(sf);
    sr = lane_tree_sum(sr);
    if (lane == 0)
      loss[b] = __fsub_rn(__fdiv_rn(sf, static_cast<float>(K)), sr);
  }
  __syncthreads();
  // The block's (b, p) cells [e0, e1) as one flat run, kVec a thread.
  const long long draw = static_cast<long long>(B) * P;
  const long long e1 = b1s * P;
  for (long long e = b0 * P + static_cast<long long>(threadIdx.x) * kVec;
       e < e1; e += static_cast<long long>(kThreads) * kVec) {
    float gs[kVec], gm[kVec], ge[kVec], ep[kVec], s[kVec];
    load<kVec>(g + e, gs);
    load<kVec>(eps + e, ep);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      gs[j] = __fmul_rn(gs[j], inv_k);
      gm[j] = gs[j];
      ge[j] = __fmul_rn(gs[j], ep[j]);
    }
    for (int k = 1; k < K; ++k) {
      load<kVec>(g + k * draw + e, gs);
      load<kVec>(eps + k * draw + e, ep);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        gs[j] = __fmul_rn(gs[j], inv_k);
        gm[j] = __fadd_rn(gm[j], gs[j]);
        ge[j] = __fadd_rn(ge[j], __fmul_rn(gs[j], ep[j]));
      }
    }
    load<kVec>(sd + e, s);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      ge[j] = __fsub_rn(__fmul_rn(ge[j], s[j]), 1.0f);
    float x[kVec], m[kVec], v[kVec];
    load<kVec>(mu + e, x);
    load<kVec>(m_mu + e, m);
    load<kVec>(v_mu + e, v);
    adam<kVec>(x, m, v, gm, b1, omb1, b2, omb2, c1, c2, lr, adam_eps);
    store<kVec>(m_mu + e, m);
    store<kVec>(v_mu + e, v);
    store<kVec>(mu + e, x);
    load<kVec>(rho + e, x);
    load<kVec>(m_rho + e, m);
    load<kVec>(v_rho + e, v);
    adam<kVec>(x, m, v, ge, b1, omb1, b2, omb2, c1, c2, lr, adam_eps);
    store<kVec>(m_rho + e, m);
    store<kVec>(v_rho + e, v);
    store<kVec>(rho + e, x);
  }
}

}  // namespace

// g (K B, P), f (K B,), eps (K, B, P): K3's gradient and loss on the draw
// stack and the draws; sd (B, P) = exp(rho).  mu, rho, m_mu, v_mu, m_rho,
// v_rho (B, P) are updated in place; loss (B,) is written.
extern "C" int tsspark_advi(const float* g, const float* f, const float* eps,
                            const float* sd, float* mu, float* rho,
                            float* m_mu, float* v_mu, float* m_rho,
                            float* v_rho, float* loss, int K, int B, int P,
                            float inv_k, float b1, float omb1, float b2,
                            float omb2, float c1, float c2, float lr,
                            float adam_eps, void* stream) {
  if (B == 0) return 0;
  if (K < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(g) |
      reinterpret_cast<unsigned long long>(eps) |
      reinterpret_cast<unsigned long long>(sd) |
      reinterpret_cast<unsigned long long>(mu) |
      reinterpret_cast<unsigned long long>(rho) |
      reinterpret_cast<unsigned long long>(m_mu) |
      reinterpret_cast<unsigned long long>(v_mu) |
      reinterpret_cast<unsigned long long>(m_rho) |
      reinterpret_cast<unsigned long long>(v_rho);
  // A block's run starts at a multiple of 32 P floats; each draw's slice
  // at a multiple of B P.
  const long long bp = static_cast<long long>(B) * P;
  const dim3 grid((B + kSeries - 1) / kSeries);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TSSPARK_ADVI(V)                                                      \
  advi_kernel<V><<<grid, kThreads, 0, st>>>(                                 \
      g, f, eps, sd, mu, rho, m_mu, v_mu, m_rho, v_rho, loss, K, B, P,       \
      inv_k, b1, omb1, b2, omb2, c1, c2, lr, adam_eps)
  if ((align & 15ull) == 0 && bp % 4 == 0)
    TSSPARK_ADVI(4);
  else if ((align & 7ull) == 0 && bp % 2 == 0)
    TSSPARK_ADVI(2);
  else
    TSSPARK_ADVI(1);
#undef TSSPARK_ADVI
  return static_cast<int>(cudaGetLastError());
}
