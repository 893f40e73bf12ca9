// The per-column pieces of one fused dycore step of the whole-state kernel
// (dycore_fused.cu). The k-step kernel (dycore_kstep.cu) runs the same
// operations in the same order on its register-resident columns, so the two
// agree bit for bit in fp32. Operation order follows `_window_step` in the
// JAX package's src/repro/kernels/dycore_fused/fused.py.
#pragma once

#include "common.cuh"

namespace nero {

// Forward sweep of the Thomas solve down one column. `f(k)` and `w(k)` read
// the field and the staggered velocity sum at level k; `rhs(k, fk)` is the
// right-hand side at level k. The sweep's coefficients for levels [0, nz-1)
// go to cc[k * stride] and dc[k * stride]. Returns the solution at the last
// level, where the backward sweep starts; `f_last` gets f(nz-1).
template <typename F, typename W, typename R>
__device__ __forceinline__ float thomas_forward(F f, W wk, R rhs, float* cc,
                                                float* dc, int64_t stride,
                                                int nz, float& f_last) {
  // ---- k = 0 ----
  float f0 = f(0), f1 = f(1), w1 = wk(1);
  float gcv = 0.25f * w1;
  float cs = gcv * kBetM;
  float ck = gcv * kBetP;
  float corr = -cs * (f1 - f0);
  float divided = 1.0f / (kDtrStage - ck);
  float cprev = ck * divided;
  float dprev = (rhs(0, f0) + corr) * divided;
  cc[0] = cprev;
  dc[0] = dprev;

  // ---- 0 < k < nz-1 ----
  for (int k = 1; k < nz - 1; ++k) {
    const float gav = -0.25f * w1;
    w1 = wk(k + 1);
    gcv = 0.25f * w1;
    const float as = gav * kBetM;
    cs = gcv * kBetM;
    const float acol = gav * kBetP;
    ck = gcv * kBetP;
    const float bcol = (kDtrStage - acol) - ck;
    const float fm = f0;
    f0 = f1;
    f1 = f(k + 1);
    corr = -as * (fm - f0) - cs * (f1 - f0);
    divided = 1.0f / (bcol - cprev * acol);
    cprev = ck * divided;
    dprev = ((rhs(k, f0) + corr) - dprev * acol) * divided;
    cc[static_cast<int64_t>(k) * stride] = cprev;
    dc[static_cast<int64_t>(k) * stride] = dprev;
  }

  // ---- k = nz-1 ----
  const int kl = nz - 1;
  const float gav = -0.25f * w1;
  const float as = gav * kBetM;
  const float acol = gav * kBetP;
  corr = -as * (f0 - f1);
  divided = 1.0f / ((kDtrStage - acol) - cprev * acol);
  f_last = f1;
  return ((rhs(kl, f1) + corr) - dprev * acol) * divided;
}

// One level k of the backward sweep for one column: `x` steps from level
// k+1 to level k (at the last level, kl, it already holds the forward
// sweep's result), the stage tendency follows, and the point-wise update
// f + dt * stage goes to `plane[c]`, where hdiff_point reads it once the
// block has synchronised. Returns the stage.
__device__ __forceinline__ float thomas_back_level(float& x, int k, int kl,
                                                   const float* cc,
                                                   const float* dc,
                                                   int64_t stride, float fk,
                                                   float dt, float* plane,
                                                   int c) {
  if (k < kl)
    x = dc[static_cast<int64_t>(k) * stride] -
        cc[static_cast<int64_t>(k) * stride] * x;
  const float stage = kDtrStage * (x - fk);
  plane[c] = fk + dt * stage;
  return stage;
}

}  // namespace nero
