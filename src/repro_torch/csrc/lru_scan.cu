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
// inside one thread per channel, the carry in a register for the whole
// sweep; channels are contiguous, so a warp's loads and stores at each step
// are coalesced. Multiply and add round separately (the library is built
// with -fmad=false), as `a * h + b` does in PyTorch, so the result does not
// depend on how the loads are staged.
//
// The sweep is sequential, so the (B, T, C) problem has only B·C threads
// (16,384 at the serving shape, ~4 warps an SM): a kernel that loads a few
// steps ahead in registers keeps ~8 KB in flight an SM, a third of what the
// card's memory latency needs. So a block of one warp (32 channels of one
// batch row) streams its (T, 32) slabs of a and b through a ring of
// kStages shared-memory stages of kT steps each, filled by `cp.async.bulk`
// copies (one row of 32 channels each; the warp's lanes issue a stage's
// rows together) that complete on an mbarrier per stage. kStages - 1 stages
// are in flight while the warp sweeps the last: 24 KB a block, ~4 blocks an
// SM at the serving shape. h is stored straight from registers. Bulk copies
// need 16-byte aligned rows; where the rows are not (C·size not a multiple
// of 16, or a base address off 16 bytes) each lane fills the ring with
// plain loads of its own channel, the only one it reads, and the same sweep
// runs over it.
//
// Measured (`chip_smoke.py --kernel-times`, one NVIDIA H100 80GB HBM3 at a
// 700 W power limit; PERF.md): forward fp32 (4, 1024, 4096) 0.075 ms
// queued against a 0.060 ms bound, reverse fp32 (4, 2048, 4096) 0.145 ms
// against 0.120; the register kernel before it took 0.140 and 0.289 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // channels (threads) a block
constexpr int kStages = 4;   // ring stages

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One bulk copy of `bytes` (a multiple of 16) from global memory into this
// block's shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T, bool kReverse>
__global__ void __launch_bounds__(kLanes)
    lru_scan_ring(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int steps, int channels, bool bulk) {
  constexpr int kT = 128 / sizeof(T);  // steps a stage: 8 KB of a and b
  __shared__ alignas(128) T ring_a[kStages][kT][kLanes];
  __shared__ alignas(128) T ring_b[kStages][kT][kLanes];
  __shared__ alignas(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kLanes;
  const int nch = min(kLanes, channels - c0);
  const uint32_t row = nch * sizeof(T);
  const long long base = static_cast<long long>(blockIdx.y) * steps * channels;
  const int groups = (steps + kT - 1) / kT;
  const uint32_t bar0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(&full[0]));
  // the u-th step of the sweep sits at time u (forward) or T-1-u (reverse)
  auto at = [&](int u) {
    return base + static_cast<long long>(kReverse ? steps - 1 - u : u) *
                      channels + c0;
  };
  // Stage g % kStages takes the steps g*kT ... of the sweep. Bulk: lane 0
  // arms its barrier with the stage's bytes, then every lane copies its
  // rows. Otherwise every lane loads its own channel of each step and lane 0
  // arrives on the barrier.
  auto fill = [&](int g) {
    const int s = g % kStages;
    const int n = min(kT, steps - g * kT);
    const uint32_t bar = bar0 + 8u * s;
    if (bulk) {
      if (lane == 0) mbar_expect(bar, 2u * row * n);
      __syncwarp();
      for (int u = lane; u < n; u += kLanes) {
        const long long src = at(g * kT + u);
        bulk_load(
            static_cast<uint32_t>(__cvta_generic_to_shared(ring_a[s][u])),
            a + src, row, bar);
        bulk_load(
            static_cast<uint32_t>(__cvta_generic_to_shared(ring_b[s][u])),
            b + src, row, bar);
      }
    } else {
      if (lane < nch) {
#pragma unroll 8
        for (int u = 0; u < n; ++u) {
          const long long src = at(g * kT + u) + lane;
          ring_a[s][u][lane] = a[src];
          ring_b[s][u][lane] = b[src];
        }
      }
      if (lane == 0) mbar_arrive(bar);
    }
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) nero::mbar_init(bar0 + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int g = 0; g < min(kStages, groups); ++g) fill(g);

  float carry = 0.0f;
  T* hp = h + lane;
  for (int g = 0; g < groups; ++g) {
    const int s = g % kStages;
    const int n = min(kT, steps - g * kT);
    const uint32_t bar = bar0 + 8u * s;
    while (!nero::mbar_try_wait(bar, (g / kStages) & 1)) {
    }
    if (lane < nch) {
      if (n == kT) {
#pragma unroll 8
        for (int u = 0; u < kT; ++u) {
          carry = nero::ld(&ring_a[s][u][lane], 0) * carry +
                  nero::ld(&ring_b[s][u][lane], 0);
          nero::st(hp, at(g * kT + u), carry);
        }
      } else {
        for (int u = 0; u < n; ++u) {
          carry = nero::ld(&ring_a[s][u][lane], 0) * carry +
                  nero::ld(&ring_b[s][u][lane], 0);
          nero::st(hp, at(g * kT + u), carry);
        }
      }
    }
    // Every lane has read stage s before the async proxy refills it.
    __syncwarp();
    if (g + kStages < groups) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill(g + kStages);
    }
  }
}

template <typename T, bool kReverse>
void launch(const T* a, const T* b, T* h, int batch, int steps, int channels,
            bool bulk, cudaStream_t st) {
  lru_scan_ring<T, kReverse>
      <<<dim3((channels + kLanes - 1) / kLanes, batch), kLanes, 0, st>>>(
          a, b, h, steps, channels, bulk);
}

template <typename T>
void launch(const void* a, const void* b, void* h, int batch, int steps,
            int channels, int reverse, cudaStream_t st) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* th = static_cast<T*>(h);
  // every row of a block's slab 16-byte aligned: bulk copies fill the ring
  const bool bulk = (static_cast<size_t>(channels) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (reverse)
    launch<T, true>(ta, tb, th, batch, steps, channels, bulk, st);
  else
    launch<T, false>(ta, tb, th, batch, steps, channels, bulk, st);
}

}  // namespace

// a, b, h: (batch, steps, channels), contiguous; `bf16` selects bfloat16
// over float32; `reverse` sweeps from the last step to the first.
extern "C" int nero_lru_scan(const void* a, const void* b, void* h, int bf16,
                             int batch, int steps, int channels, int reverse,
                             void* stream) {
  if (batch <= 0 || steps <= 0 || channels <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(a, b, h, batch, steps, channels, reverse, st);
  else
    launch<float>(a, b, h, batch, steps, channels, reverse, st);
  return static_cast<int>(cudaGetLastError());
}
