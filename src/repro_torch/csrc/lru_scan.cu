// First-order linear recurrence h_t = a_t·h_{t-1} + b_t, h_{-1} = 0 (the
// RG-LRU sweep of Griffin / RecurrentGemma), fp32 carry, float32 or
// bfloat16 in and out. With `reverse` the sweep runs from t = T-1 down to 0,
// h_t = a_t·h_{t+1} + b_t, h_T = 0: the backward of the forward sweep is
// such a reverse sweep over (a shifted one step, dh).
//
// Replaces the TPU kernel `lru_scan_pallas`
// (src/repro/kernels/lru_scan/lru_scan.py, body `_lru_kernel`).
//
// Bound: device-memory bytes. Each element of a and b is read once and each
// h written once, with two flops per element.
//
// Design: the TPU kernel sweeps (tt, tc) tiles with the carry in VMEM
// scratch across its sequential time axis. Here the time axis is a loop
// inside one thread per channel: channels are contiguous, so a warp's loads
// and stores at each step are coalesced, and the carry lives in a register
// for the whole sweep. Each thread loads kUnroll steps of a and b before it
// uses them, so that many loads are in flight. It takes a batch of
// independent (T, C) sweeps (the model's (B, T, W) layout); one block of
// 64 channels of one batch row keeps enough blocks for the SMs at the
// serving path's B = 4, C = 4096. Multiply and add round separately (the
// library is built with -fmad=false), as `a * h + b` does in PyTorch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

template <typename T, bool kReverse>
__global__ void __launch_bounds__(kThreads)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ h, int steps, int channels) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const long long base =
      static_cast<long long>(blockIdx.y) * steps * channels + c;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  // the u-th step of the sweep sits at time u (forward) or T-1-u (reverse)
  auto at = [&](int u) {
    return static_cast<long long>(kReverse ? steps - 1 - u : u) * channels;
  };
  float carry = 0.0f;
  int t = 0;
  for (; t + kUnroll <= steps; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = at(t + u);
      av[u] = nero::ld(ap, i);
      bv[u] = nero::ld(bp, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = av[u] * carry + bv[u];
      nero::st(hp, at(t + u), carry);
    }
  }
  for (; t < steps; ++t) {
    const long long i = at(t);
    carry = nero::ld(ap, i) * carry + nero::ld(bp, i);
    nero::st(hp, i, carry);
  }
}

template <typename T>
void launch(const void* a, const void* b, void* h, int steps, int channels,
            int reverse, dim3 grid, cudaStream_t st) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* th = static_cast<T*>(h);
  if (reverse)
    lru_scan_kernel<T, true><<<grid, kThreads, 0, st>>>(ta, tb, th, steps,
                                                        channels);
  else
    lru_scan_kernel<T, false><<<grid, kThreads, 0, st>>>(ta, tb, th, steps,
                                                         channels);
}

}  // namespace

// a, b, h: (batch, steps, channels), contiguous; `bf16` selects bfloat16
// over float32; `reverse` sweeps from the last step to the first.
extern "C" int nero_lru_scan(const void* a, const void* b, void* h, int bf16,
                             int batch, int steps, int channels, int reverse,
                             void* stream) {
  if (batch <= 0 || steps <= 0 || channels <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((channels + kThreads - 1) / kThreads, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(a, b, h, steps, channels, reverse, grid, st);
  else
    launch<float>(a, b, h, steps, channels, reverse, grid, st);
  return static_cast<int>(cudaGetLastError());
}
