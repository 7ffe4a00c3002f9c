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
// root rounded on its own (the _rn intrinsics: no contraction into FMAs),
// and the sums over k and over p taken in ascending order, so the result
// is the same bits as the plain version (kernels/advi.py `advi_plain`).
// mu, rho and the four moments are updated in place; sd comes from the
// wrapper (the same tensor the draw stack was formed with), so no
// transcendental runs here.
//
// What bounds it: bytes.  Per (b, p) the function needs 2K floats of g
// and eps and six of mu, rho and the moments read, and six written,
// against ~4K + 20 float operations: at the M5 fleet's 30,490 x 54 with
// K = 4 that is 132 MB, ~40 us at 3.35 TB/s, against K3's several ms on
// the same stack (this kernel also reads sd, one float more).  So
// the design is one plain pass: a warp a series, lanes over the
// parameters (a warp's loads of one draw's row coalesced), no shared
// memory; lane 0 takes the series' two sequential sums before any lane
// writes its rho.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    advi_kernel(const float* __restrict__ g, const float* __restrict__ f,
                const float* __restrict__ eps, const float* __restrict__ sd,
                float* mu, float* rho, float* m_mu, float* v_mu, float* m_rho,
                float* v_rho, float* __restrict__ loss, int K, int B, int P,
                float inv_k, float b1, float omb1, float b2, float omb2,
                float c1, float c2, float lr, float adam_eps) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long row = static_cast<long long>(b) * P;
  const long long draw = static_cast<long long>(B) * P;
  if (lane == 0) {
    float sf = f[b];
    for (int k = 1; k < K; ++k) sf = __fadd_rn(sf, f[k * B + b]);
    float sr = rho[row];
    for (int p = 1; p < P; ++p) sr = __fadd_rn(sr, rho[row + p]);
    loss[b] = __fsub_rn(__fdiv_rn(sf, static_cast<float>(K)), sr);
  }
  __syncwarp();
  for (int p = lane; p < P; p += 32) {
    const long long i = row + p;
    float gs = __fmul_rn(g[i], inv_k);
    float gm = gs;
    float ge = __fmul_rn(gs, eps[i]);
    for (int k = 1; k < K; ++k) {
      gs = __fmul_rn(g[k * draw + i], inv_k);
      gm = __fadd_rn(gm, gs);
      ge = __fadd_rn(ge, __fmul_rn(gs, eps[k * draw + i]));
    }
    const float gr = __fsub_rn(__fmul_rn(ge, sd[i]), 1.0f);
    const float grads[2] = {gm, gr};
    float* params[2] = {mu, rho};
    float* ms[2] = {m_mu, m_rho};
    float* vs[2] = {v_mu, v_rho};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float gj = grads[j];
      const float m = __fadd_rn(__fmul_rn(b1, ms[j][i]), __fmul_rn(omb1, gj));
      const float v = __fadd_rn(__fmul_rn(b2, vs[j][i]),
                                __fmul_rn(__fmul_rn(omb2, gj), gj));
      const float num = __fmul_rn(lr, __fdiv_rn(m, c1));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), adam_eps);
      ms[j][i] = m;
      vs[j][i] = v;
      params[j][i] = __fsub_rn(params[j][i], __fdiv_rn(num, den));
    }
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
  const dim3 grid((B + kWarps - 1) / kWarps);
  advi_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      g, f, eps, sd, mu, rho, m_mu, v_mu, m_rho, v_rho, loss, K, B, P, inv_k,
      b1, omb1, b2, omb2, c1, c2, lr, adam_eps);
  return static_cast<int>(cudaGetLastError());
}
