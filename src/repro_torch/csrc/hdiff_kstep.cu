// k steps of COSMO compound horizontal diffusion in one launch, on a stack of
// (ny, nx) planes whose 2-wide ring passes through on every step.
//
// Replaces the TPU kernel `hdiff_kstep_pallas`
// (src/repro/kernels/hdiff/hdiff.py, body `_hdiff_kstep_kernel`).
//
// Bound: device-memory bytes. The round reads each point once and writes it
// once, for about 21 fp32 operations per point and step.
//
// Design: one block per (plane, y-tile, x-tile). The block stages its tile
// with a 2k-deep halo, (ty+4k) x (tx+4k) points, in shared memory, zero
// outside the plane as in hdiff.cu (no point of the plane's interior ever
// reads there). The k steps ping-pong between two shared buffers through
// `nero::hdiff_point`; points outside [2, ny-2) x [2, nx-2), and those
// within 2 of the tile edge, pass through. Step s leaves the points at least
// 2s from the tile edge exact, so after k steps the ty x tx centre is, and
// only it is written. Every step rounds through the storage dtype, as a
// separate launch's store and load would, so the result is bit-equal to k
// `hdiff.cu` launches in fp32 and in bf16. Threads loop over the tile's
// points; ragged edge tiles are masked.
#include <climits>

#include "common.cuh"

namespace {

__device__ __forceinline__ float round_trip(float v, float*) { return v; }
__device__ __forceinline__ float round_trip(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void hdiff_kstep_kernel(const T* __restrict__ src,
                                   T* __restrict__ out, int ny, int nx, int ty,
                                   int tx, int k_steps, int tiles_y,
                                   int tiles_x, float coeff) {
  extern __shared__ float tiles[];  // two (ty+4k) x (tx+4k) buffers
  const int hl = 2 * k_steps;
  const int w = tx + 2 * hl, h = ty + 2 * hl, n = w * h;
  int64_t b = blockIdx.x;
  const int i0 = static_cast<int>(b % tiles_x) * tx;
  b /= tiles_x;
  const int j0 = static_cast<int>(b % tiles_y) * ty;
  const int64_t base = (b / tiles_y) * ny * nx;

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = j0 - hl + idx / w, i = i0 - hl + idx % w;
    tiles[idx] = (j >= 0 && j < ny && i >= 0 && i < nx)
                     ? nero::ld(src, base + static_cast<int64_t>(j) * nx + i)
                     : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < k_steps; ++s) {
    const float* a = tiles + (s & 1) * n;
    float* z = tiles + ((s + 1) & 1) * n;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int r = idx / w, q = idx % w;
      const int j = j0 - hl + r, i = i0 - hl + q;
      float v = a[idx];
      if (r >= 2 && r < h - 2 && q >= 2 && q < w - 2 && j >= 2 &&
          j < ny - 2 && i >= 2 && i < nx - 2)
        v = round_trip(nero::hdiff_point(a, idx, w, coeff),
                       static_cast<T*>(nullptr));
      z[idx] = v;
    }
    __syncthreads();
  }

  const float* fin = tiles + (k_steps & 1) * n;
  for (int idx = threadIdx.x; idx < ty * tx; idx += blockDim.x) {
    const int r = idx / tx, q = idx % tx;
    const int j = j0 + r, i = i0 + q;
    if (j < ny && i < nx)
      nero::st(out, base + static_cast<int64_t>(j) * nx + i,
               fin[(r + hl) * w + q + hl]);
  }
}

template <typename T>
int launch(const void* src, void* out, unsigned blocks, int threads,
           size_t smem, cudaStream_t s, int ny, int nx, int ty, int tx,
           int k_steps, int tiles_y, int tiles_x, float coeff) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hdiff_kstep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hdiff_kstep_kernel<T><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(src), static_cast<T*>(out), ny, nx, ty, tx,
      k_steps, tiles_y, tiles_x, coeff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nero_hdiff_kstep(const void* src, void* out, long long planes,
                                int ny, int nx, float coeff, int ty, int tx,
                                int k_steps, int threads, int bf16,
                                void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 || k_steps < 1 ||
      threads < 1 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = planes * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 2 * sizeof(float) *
                      static_cast<size_t>(ty + 4 * k_steps) * (tx + 4 * k_steps);
  auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const int ty_ = static_cast<int>(tiles_y), tx_ = static_cast<int>(tiles_x);
  if (bf16)
    return launch<__nv_bfloat16>(src, out, nb, threads, smem, s, ny, nx, ty,
                                 tx, k_steps, ty_, tx_, coeff);
  return launch<float>(src, out, nb, threads, smem, s, ny, nx, ty, tx,
                       k_steps, ty_, tx_, coeff);
}
