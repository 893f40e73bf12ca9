// First-order upwind horizontal advection on a stack of (ny, nx) planes:
// f - cfl * ((f - f[j-1]) + (f - f[i-1])), in one of two boundary modes:
// passthrough, where row 0 and column 0 pass through (the low-side ring, as
// the TPU kernel does), or periodic, where row -1 is row ny - 1 and column
// -1 is column nx - 1 and every point is updated.
//
// Replaces the TPU kernel `hadv_pallas` (src/repro/kernels/hadv/hadv.py,
// body `_hadv_kernel`).
//
// Bound: device-memory bytes. Each point is read once and written once, for
// 5 fp32 operations: 0.160 ms in fp32 and 0.080 ms in bf16 for the
// (1024, 256, 256) stack of one whole-state step at the H100's 3.35 TB/s.
//
// Design: the TPU kernel streams row windows of a whole-x plane with a
// one-row low-side halo from the previous window. Here a block holds kWarps
// independent warps, and a warp streams one y-segment of one x-strip of a
// plane, a row at a time, top to bottom, starting one row above the segment
// (row ny - 1 for the first segment in periodic mode; none in passthrough):
// * Each row's strip, from one column left of it, comes into a ring of kRing
//   rows in the warp's shared memory by 16-byte `cp.async` copies of the
//   aligned chunks that hold it (warp_ring.cuh), kRing - 1 rows ahead; in
//   periodic mode the warp of a row's first strip also copies the chunk that
//   holds column nx - 1. Any row stride and alignment takes the same path.
// * A lane holds kCols columns 32 apart (4 in fp32, 8 in bf16, so a warp
//   covers 16 bytes a lane of a row): reads from the ring and stores to
//   device memory are a warp's consecutive elements. The row above is the
//   lane's registers of the step before; the left neighbour comes from the
//   ring.
// * No thread divides per point. Strips and segments are balanced
//   (`tiling.hadv_tile`), so no warp is mostly idle at 256 or 257 columns.
// * Computes in fp32 and rounds once to the storage dtype. The periodic mode
//   gives the bits of padding the low sides by one row and column, the
//   passthrough mode, and a crop.
#include <climits>

#include "common.cuh"
#include "warp_ring.cuh"

namespace {

constexpr int kRing = 8;   // rows a warp's ring holds (tiling.HADV_RING)
constexpr int kWarps = 4;  // warps a block (tiling.HADV_WARPS)

// Shared bytes of a block whose strips are at most `tx` columns wide
// (tiling.hadv_smem): a ring region of the strip and its left neighbour,
// and 16 bytes for the chunk that holds column nx - 1, a row and warp.
size_t block_smem(int tx, int sz) {
  return static_cast<size_t>(kWarps) * kRing *
         (nero::ring_region(tx + 1, sz) + 16);
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    hadv_stream(const T* __restrict__ src, T* __restrict__ out,
                long long items, int ny, int nx, int segs, int strips, int tx,
                int periodic, float cfl) {
  constexpr int sz = sizeof(T);
  constexpr int kCols = 16 / sz;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= items) return;
  const int region = nero::ring_region(tx + 1, sz);
  const int slot_bytes = region + 16;
  unsigned char* ringp = smem + warp * kRing * slot_bytes;
  const uint32_t ring = nero::smem_addr(ringp);

  const int sx = static_cast<int>(item % strips);
  item /= strips;
  const int sy = static_cast<int>(item % segs);
  const long long plane = item / segs;
  const int x0 = static_cast<int>(static_cast<long long>(sx) * nx / strips);
  const int x1 = static_cast<int>(static_cast<long long>(sx + 1) * nx / strips);
  const int y0 = static_cast<int>(static_cast<long long>(sy) * ny / segs);
  const int y1 = static_cast<int>(static_cast<long long>(sy + 1) * ny / segs);
  const int xs = x0 > 0 ? x0 - 1 : 0;  // the ring's first column
  const bool wrap_x = periodic && x0 == 0;
  const int halo = periodic || y0 > 0;  // rows streamed above the segment
  const int rows = y1 - y0 + halo;
  const int span = (x1 - xs) * sz;
  const T* pbase = src + plane * ny * nx;
  // stream row r is plane row y0 - halo + r, wrapped
  auto row_of = [&](int r) {
    const int y = y0 - halo + r;
    return y < 0 ? y + ny : y;
  };
  auto row_ptr = [&](int r) {
    return reinterpret_cast<const unsigned char*>(
        pbase + static_cast<long long>(row_of(r)) * nx);
  };
  auto issue = [&](int r) {
    if (r < rows) {
      const uint32_t slot = ring + (r % kRing) * slot_bytes;
      const unsigned char* p = row_ptr(r);
      for (int q = lane; q < region / 16; q += 32)
        nero::copy_chunk(slot, p + xs * sz, span, q);
      if (wrap_x && lane == 31)
        nero::copy_chunk(slot + region, p + (nx - 1) * sz, sz, 0);
    }
    nero::cp_async_commit();
  };
  for (int r = 0; r < kRing; ++r) issue(r);

  float above[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) above[e] = 0.0f;
  T* dst = out + (plane * ny + y0) * nx + x0 + lane;
  for (int r = 0; r < rows; ++r) {
    nero::cp_async_wait<kRing - 1>();
    __syncwarp();
    const unsigned char* p = row_ptr(r);
    const T* row = reinterpret_cast<const T*>(
        ringp + (r % kRing) * slot_bytes +
        (reinterpret_cast<uintptr_t>(p + xs * sz) & 15));
    float cur[kCols], left[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int c = x0 + lane + 32 * e - xs;  // ring column
      const bool in = x0 + lane + 32 * e < x1;
      cur[e] = in ? f32(row[c]) : 0.0f;
      left[e] = in && c > 0 ? f32(row[c - 1]) : 0.0f;
    }
    if (wrap_x && lane == 0)
      left[0] = f32(*reinterpret_cast<const T*>(
          ringp + (r % kRing) * slot_bytes + region +
          (reinterpret_cast<uintptr_t>(p + (nx - 1) * sz) & 15)));
    __syncwarp();
    issue(r + kRing);
    if (r < halo) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) above[e] = cur[e];
      continue;
    }
    const bool row_in = periodic || y0 + r - halo > 0;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int i = x0 + lane + 32 * e;
      if (i < x1) {
        float v = cur[e];
        if (row_in && (periodic || i > 0))
          v = v - cfl * ((v - above[e]) + (v - left[e]));
        nero::st(dst, 32 * e, v);
      }
      above[e] = cur[e];
    }
    dst += nx;
  }
}

template <typename T>
int launch(const void* src, void* out, long long items, int ny, int nx,
           int segs, int strips, int tx, int periodic, float cfl,
           cudaStream_t st) {
  const size_t smem = block_smem(tx, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hadv_stream<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  hadv_stream<T><<<static_cast<unsigned>(blocks), kWarps * 32, smem, st>>>(
      static_cast<const T*>(src), static_cast<T*>(out), items, ny, nx, segs,
      strips, tx, periodic, cfl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Upwind advection of `planes` (ny, nx) planes, in balanced segments of at
// most ty rows and strips of at most tx columns (at most 16 bytes a lane of
// a warp: 128 fp32 or 256 bf16 columns); periodic 0 passes row 0 and
// column 0 through, 1 wraps them.
extern "C" int nero_hadv(const void* src, void* out, long long planes, int ny,
                         int nx, float cfl, int ty, int tx, int periodic,
                         int bf16, void* stream) {
  const int sz = bf16 ? 2 : 4;
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 ||
      tx > 32 * (16 / sz) || (periodic != 0 && periodic != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int segs = (ny + ty - 1) / ty, strips = (nx + tx - 1) / tx;
  const long long items = planes * segs * strips;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(src, out, items, ny, nx, segs, strips, tx,
                                 periodic, cfl, st);
  return launch<float>(src, out, items, ny, nx, segs, strips, tx, periodic,
                       cfl, st);
}
