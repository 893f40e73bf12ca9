// First-order upwind horizontal advection on a stack of (ny, nx) planes:
// f - cfl * ((f - f[j-1]) + (f - f[i-1])), with row 0 and column 0 passing
// through (the low-side ring).
//
// Replaces the TPU kernel `hadv_pallas` (src/repro/kernels/hadv/hadv.py,
// body `_hadv_kernel`).
//
// Bound: device-memory bytes. Each point is read once and written once, for
// 5 fp32 operations.
//
// Design: one block per (plane, y-tile, x-tile), one thread per point,
// neighbouring threads on neighbouring x so loads and stores coalesce. The
// two upwind neighbours are read straight from device memory; the block's
// rows overlap by one, so they come from L1/L2. Computes in fp32 and rounds
// once to the storage dtype. Ragged edge tiles are masked.
#include <climits>

#include "common.cuh"

namespace {

template <typename T>
__global__ void hadv_kernel(const T* __restrict__ src, T* __restrict__ out,
                            int ny, int nx, int tiles_y, int tiles_x,
                            float cfl) {
  int64_t b = blockIdx.x;
  const int i = static_cast<int>(b % tiles_x) * blockDim.x + threadIdx.x;
  b /= tiles_x;
  const int j = static_cast<int>(b % tiles_y) * blockDim.y + threadIdx.y;
  if (j >= ny || i >= nx) return;
  const int64_t o = (b / tiles_y) * ny * nx + static_cast<int64_t>(j) * nx + i;
  float c = nero::ld(src, o);
  if (j >= 1 && i >= 1) {
    const float ym = nero::ld(src, o - nx), xm = nero::ld(src, o - 1);
    c = c - cfl * ((c - ym) + (c - xm));
  }
  nero::st(out, o, c);
}

}  // namespace

extern "C" int nero_hadv(const void* src, void* out, long long planes, int ny,
                         int nx, float cfl, int ty, int tx, int bf16,
                         void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 || ty * tx > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = planes * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 block(tx, ty);
  auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  if (bf16)
    hadv_kernel<<<nb, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<__nv_bfloat16*>(out), ny, nx, static_cast<int>(tiles_y),
        static_cast<int>(tiles_x), cfl);
  else
    hadv_kernel<<<nb, block, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(out), ny, nx,
        static_cast<int>(tiles_y), static_cast<int>(tiles_x), cfl);
  return static_cast<int>(cudaGetLastError());
}
