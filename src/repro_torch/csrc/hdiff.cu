// COSMO compound horizontal diffusion on a stack of (ny, nx) planes.
//
// Replaces the TPU kernel `hdiff_pallas` (src/repro/kernels/hdiff/hdiff.py,
// body `_hdiff_kernel`).
//
// Bound: device-memory bytes. Each point is read once and written once and
// costs about 21 fp32 operations, far below the ~20 operations per byte at
// which the H100's fp32 rate would become the limit.
//
// Design: one block per (plane, y-tile, x-tile), one thread per output point.
// The tile and its 2-deep halo are staged once in shared memory, so every
// input element is read from device memory about (ty+4)(tx+4)/(ty*tx) times;
// neighbouring threads read neighbouring x, so loads and stores coalesce.
// Rows and columns outside [2, n-2) are the global ring and pass through
// unchanged. The kernel masks its own ragged edge tiles, so neither ny nor
// nx has to divide by the tile. The block index runs in gridDim.x (planes
// times tiles can pass 65535).
#include <climits>

#include "common.cuh"

namespace {

template <typename T>
__global__ void hdiff_kernel(const T* __restrict__ src, T* __restrict__ out,
                             int ny, int nx, int tiles_y, int tiles_x,
                             float coeff) {
  extern __shared__ float tile[];
  const int tx = blockDim.x, ty = blockDim.y;
  const int w = tx + 4, h = ty + 4;
  int64_t b = blockIdx.x;
  const int i0 = static_cast<int>(b % tiles_x) * tx;
  b /= tiles_x;
  const int j0 = static_cast<int>(b % tiles_y) * ty;
  const int64_t plane = b / tiles_y;
  const int64_t base = plane * ny * nx;

  for (int idx = threadIdx.y * tx + threadIdx.x; idx < h * w; idx += tx * ty) {
    const int j = j0 - 2 + idx / w, i = i0 - 2 + idx % w;
    // Outside the plane nothing interior ever reads the value.
    tile[idx] = (j >= 0 && j < ny && i >= 0 && i < nx)
                    ? nero::ld(src, base + static_cast<int64_t>(j) * nx + i)
                    : 0.0f;
  }
  __syncthreads();

  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  if (j >= ny || i >= nx) return;
  const int c = (threadIdx.y + 2) * w + threadIdx.x + 2;
  float res = tile[c];
  if (j >= 2 && j < ny - 2 && i >= 2 && i < nx - 2)
    res = nero::hdiff_point(tile, c, w, coeff);
  nero::st(out, base + static_cast<int64_t>(j) * nx + i, res);
}

}  // namespace

extern "C" int nero_hdiff(const void* src, void* out, long long planes, int ny,
                          int nx, float coeff, int ty, int tx, int bf16,
                          void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 || ty * tx > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = planes * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 block(tx, ty);
  const size_t smem = sizeof(float) * (ty + 4) * (tx + 4);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    hdiff_kernel<<<static_cast<unsigned>(blocks), block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(out),
        ny, nx, static_cast<int>(tiles_y), static_cast<int>(tiles_x), coeff);
  else
    hdiff_kernel<<<static_cast<unsigned>(blocks), block, smem, s>>>(
        static_cast<const float*>(src), static_cast<float*>(out), ny, nx,
        static_cast<int>(tiles_y), static_cast<int>(tiles_x), coeff);
  return static_cast<int>(cudaGetLastError());
}
