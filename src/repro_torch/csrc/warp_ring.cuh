// A warp's ring of row segments in shared memory, filled by `cp.async`.
//
// The vadvc and hadv kernels stream segments of rows (a few hundred bytes of
// one row of one plane) from device memory into a ring of slots in the
// shared memory of one warp. A segment may start at any element of any row
// stride, so it is copied in 16-byte chunks from the aligned chunk that holds
// its first byte: chunk q goes to byte 16q of its region, element e of the
// segment lies at byte (a % 16) + e * sizeof(T), a the segment's address.
// Bytes past the segment's end are zero-filled and bytes before its start
// are those of the row before it; no reader uses either. An aligned chunk
// never leaves the page that holds the segment's first byte.
//
// Each lane commits one copy group a ring slot, copies or not, so every
// lane's groups stay in step; `cp_async_wait<N>` then a `__syncwarp` makes
// the oldest slots visible to the whole warp, and a `__syncwarp` after the
// warp has read a slot lets its lanes refill it. No block barrier is used.
#pragma once

#include <cstdint>

namespace nero {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first `bytes` (1 to 16) of the 16 global bytes at `src` into the 16
// shared bytes at `dst` (both 16-byte aligned), the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this lane's latest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk q of the `span`-byte segment at global address `a` into byte 16q of
// the shared region at `dst`; nothing when the chunk lies past the segment.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const void* a,
                                           int span, int q) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a);
  const uintptr_t c = (p & ~static_cast<uintptr_t>(15)) + 16u * q;
  const long long left = static_cast<long long>(p + span - c);
  if (left > 0)
    cp_async16(dst + 16u * q, reinterpret_cast<const void*>(c),
               static_cast<uint32_t>(left < 16 ? left : 16));
}

// Bytes of a region that holds a segment of `n` elements of `sz` bytes at
// any alignment: its chunks, and one more for the misalignment.
__host__ __device__ __forceinline__ int ring_region(int n, int sz) {
  return 16 * ((n * sz + 15) / 16 + 1);
}

}  // namespace nero
