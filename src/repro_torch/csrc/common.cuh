// Shared helpers of the NERO stencil kernels for Hopper (sm_90a).
//
// Every kernel keeps its working values in fp32 and stores either fp32 or
// bf16 (round to nearest even, as `astype` / `.to` do). The library is built
// with -fmad=false so each kernel rounds after every operation in the order
// its plain PyTorch version and the JAX reference write them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nero {

constexpr float kDtrStage = 3.0f / 20.0f;  // DTR_STAGE
constexpr float kBetM = 0.5f;              // 0.5 * (1 - BETA_V), BETA_V = 0
constexpr float kBetP = 0.5f;              // 0.5 * (1 + BETA_V)

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// An mbarrier in shared memory (a 32-bit shared address) that completes a
// phase after `count` arrivals, and one test of whether the phase of the
// given parity has completed.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Compound horizontal diffusion of the point at `c` of a row-major tile of
// row stride `w` (laplace -> flux -> COSMO limiter -> output). The caller
// guarantees a 2-deep neighbourhood around `c` inside the tile.
__device__ __forceinline__ float hdiff_point(const float* t, int c, int w,
                                             float coeff) {
  auto s = [&](int dj, int di) { return t[c + dj * w + di]; };
  auto lap = [&](int dj, int di) {
    return (((s(dj, di - 1) + s(dj, di + 1)) + s(dj - 1, di)) + s(dj + 1, di)) -
           4.0f * s(dj, di);
  };
  const float lap_c = lap(0, 0);
  float flx = lap(0, 1) - lap_c;
  float flx_m = lap_c - lap(0, -1);
  float fly = lap(1, 0) - lap_c;
  float fly_m = lap_c - lap(-1, 0);
  if (flx * (s(0, 1) - s(0, 0)) > 0.0f) flx = 0.0f;
  if (flx_m * (s(0, 0) - s(0, -1)) > 0.0f) flx_m = 0.0f;
  if (fly * (s(1, 0) - s(0, 0)) > 0.0f) fly = 0.0f;
  if (fly_m * (s(0, 0) - s(-1, 0)) > 0.0f) fly_m = 0.0f;
  return s(0, 0) - coeff * ((flx - flx_m) + (fly - fly_m));
}

}  // namespace nero
