// K3's draw-stack layout for linear and flat growth (loss_draws.cuh; the design
// is in loss.cu's header).  Its own source, so nvcc builds it beside
// loss.cu.

#include "loss_draws.cuh"

int tsspark::draw_stack(TSSPARK_DRAW_STACK_ARGS) {
  return draw_stack_bucket<false>(kFs, theta, t, y, mask, cap, s, xs,
                                  xs_bstride, xr, ps, mm, f_out, g_out, N, B,
                                  T, P, ncp, Fs, R, growth, k_scale, m_scale,
                                  sigma_scale, cp_scale, st);
}
