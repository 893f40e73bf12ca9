// Identity copy of a contiguous buffer of any dtype: the COSMO copy stencil
// (NERO paper Fig. 2b), the probe for the memory rate the card sustains.
//
// Replaces the TPU kernel `copy_pallas`
// (src/repro/kernels/copy_stencil/copy_stencil.py, body `_copy_kernel`).
//
// Bound: device-memory bytes. Each byte is read once and written once, with
// no arithmetic.
//
// Design: the TPU kernel streams (tr, cols) row blocks through VMEM; a
// Hopper SM needs no staging for a copy, only enough loads in flight and
// long runs of neighbouring addresses. One block of 256 threads per
// contiguous 16 KB tile: each thread loads four 16-byte vectors 4 KB apart
// before it stores them. The loads and stores take the default cache policy:
// with streaming hints (evict first) the copy of an L2-resident buffer ran
// a third slower and a 268 MB one 1% slower. A persistent grid and a ring
// of bulk asynchronous copies (`cp.async.bulk` through shared memory) were
// tried too and moved 268 MB no faster than these short blocks (PERF.md).
// The bytes past the last whole vector go one byte per thread; when either
// address is not 16-byte aligned all of them do (right, not fast). It
// copies bytes, so it serves every dtype and keeps every bit (-0.0, NaN
// payloads).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTile = kThreads * kUnroll;   // 16-byte vectors a block

__global__ void copy_kernel(const uint4* __restrict__ src,
                            uint4* __restrict__ dst, long long n16,
                            const unsigned char* __restrict__ src_b,
                            unsigned char* __restrict__ dst_b, long long head,
                            long long nbytes) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (base + u * kThreads < n16) v[u] = src[base + u * kThreads];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (base + u * kThreads < n16) dst[base + u * kThreads] = v[u];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j =
           head + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < nbytes; j += stride)
    dst_b[j] = src_b[j];
}

}  // namespace

extern "C" int nero_copy(const void* src, void* dst, long long nbytes,
                         void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const long long n16 = aligned ? nbytes / 16 : 0;
  const long long head = n16 * 16;
  // One tile of vectors a block; unaligned, as many blocks as the vectors
  // the bytes would fill, each thread then striding over bytes.
  const long long units = aligned ? n16 : (nbytes + 15) / 16;
  const long long blocks = units > 0 ? (units + kTile - 1) / kTile : 1;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), head, nbytes);
  return static_cast<int>(cudaGetLastError());
}
