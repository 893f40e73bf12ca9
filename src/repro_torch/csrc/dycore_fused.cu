// One fused dycore step for every prognostic field: Thomas solve along z ->
// point-wise update f += dt * stage -> periodic compound hdiff. Writes
// (f_new, stage).
//
// Replaces the TPU kernels `fused_dycore_whole_state_pallas` and
// `fused_dycore_pallas` (src/repro/kernels/dycore_fused/fused.py, bodies
// `_fused_kernel` and `_window_step`); the per-field kernel is this one at
// nf = 1.
//
// Bound: device-memory bytes. Per field a step reads f, utens, utens_stage
// and the shared w once and writes f_new and stage once, at about 61 fp32
// operations per point.
//
// Design: one block per (member, y-tile, x-tile, field), the field index
// fastest so the blocks that share a w tile run together and w comes from
// device memory about once. One thread per column of the haloed tile
// (ty+4) x (tx+4). The TPU kernel keeps x whole and rolls it; here x is tiled
// too, and both halos come from periodic indexing ((j+ny)%ny, (i+nx)%nx).
// Each thread runs the forward sweep of its column (`nero::thomas_forward`,
// dycore_column.cuh; the k-step kernel repeats its operations in their
// order, so the two agree bit for bit); halo columns are solved
// redundantly, as the TPU kernel solves its halo rows. The sweep's (ccol,
// dcol) are nz deep per column and live in an fp32 global scratch the
// wrapper allocates, laid out (block, k, column) so every level coalesces.
// The backward sweep walks k from nz-1 down; at each level it writes the
// tile's updated field into one of two shared-memory planes, synchronises
// once, and the interior threads apply hdiff at that level. hdiff is 2-D per
// level, so one level of the tile is all shared memory holds. The right-hand
// side and the limiter follow `_fused_kernel` / `_window_step` operation by
// operation. Ragged edge tiles are masked, so no tile has to divide the grid.
#include <climits>

#include "dycore_column.cuh"

namespace {

template <typename T>
__global__ void dycore_fused_kernel(
    const T* __restrict__ fs, const T* __restrict__ w,
    const T* __restrict__ utens, const T* __restrict__ ustage,
    T* __restrict__ fout, T* __restrict__ sout, float* __restrict__ ccol,
    float* __restrict__ dcol, int nf, int nz, int ny, int nx, int ty, int tx,
    int tiles_y, int tiles_x, float dt, float coeff) {
  using nero::kDtrStage;
  extern __shared__ float lvl[];  // two (ty+4) x (tx+4) planes
  const int tw = tx + 4;
  const int ncol = (ty + 4) * tw;
  const int c = threadIdx.x;  // blockDim.x == ncol: no thread is idle

  int64_t b = blockIdx.x;
  const int field = static_cast<int>(b % nf);
  b /= nf;
  const int i0 = static_cast<int>(b % tiles_x) * tx;
  b /= tiles_x;
  const int j0 = static_cast<int>(b % tiles_y) * ty;
  const int64_t member = b / tiles_y;

  const int r = c / tw, q = c % tw;
  const int jr = j0 - 2 + r, ir = i0 - 2 + q;  // unwrapped global position
  const int j = ((jr % ny) + ny) % ny, i = ((ir % nx) + nx) % nx;
  const bool interior = r >= 2 && r < ty + 2 && q >= 2 && q < tx + 2 &&
                        jr < ny && ir < nx;

  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t vol = plane * nz;
  const int64_t col = static_cast<int64_t>(j) * nx + i;
  const int64_t fbase = (member * nf + field) * vol + col;
  const int64_t wbase = member * vol + col;
  auto f = [&](int k) { return nero::ld(fs, fbase + k * plane); };
  auto wk = [&](int k) { return nero::ld(w, wbase + k * plane); };
  auto rhs = [&](int k, float fk) {
    return (kDtrStage * fk + nero::ld(utens, fbase + k * plane)) +
           nero::ld(ustage, fbase + k * plane);
  };
  float* cc = ccol + static_cast<int64_t>(blockIdx.x) * nz * ncol + c;
  float* dc = dcol + static_cast<int64_t>(blockIdx.x) * nz * ncol + c;

  const int kl = nz - 1;
  float f_last;
  float datac = nero::thomas_forward(f, wk, rhs, cc, dc, ncol, nz, f_last);

  // ---- backward sweep + update + hdiff, one level at a time ----
  for (int k = kl; k >= 0; --k) {
    const float fk = (k == kl) ? f_last : f(k);
    float* buf = lvl + (k & 1) * ncol;
    const float stage =
        nero::thomas_back_level(datac, k, kl, cc, dc, ncol, fk, dt, buf, c);
    const int64_t o = fbase + k * plane;
    if (interior) nero::st(sout, o, stage);
    __syncthreads();
    if (interior) nero::st(fout, o, nero::hdiff_point(buf, c, tw, coeff));
  }
}

}  // namespace

extern "C" int nero_dycore_fused(const void* fs, const void* w,
                                 const void* utens, const void* ustage,
                                 void* fout, void* sout, void* ccol, void* dcol,
                                 long long batch, int nf, int nz, int ny,
                                 int nx, float dt, float coeff, int ty, int tx,
                                 int bf16, void* stream) {
  if (batch < 1 || nf < 1 || nz < 2 || ny < 1 || nx < 1 || ty < 1 || tx < 1 ||
      (ty + 4) * (tx + 4) > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = batch * nf * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ncol = (ty + 4) * (tx + 4);
  const size_t smem = 2 * sizeof(float) * ncol;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(ccol);
  auto d = static_cast<float*>(dcol);
  const auto nb = static_cast<unsigned>(blocks);
  if (bf16) {
    using T = __nv_bfloat16;
    dycore_fused_kernel<<<nb, ncol, smem, s>>>(
        static_cast<const T*>(fs), static_cast<const T*>(w),
        static_cast<const T*>(utens), static_cast<const T*>(ustage),
        static_cast<T*>(fout), static_cast<T*>(sout), c, d, nf, nz, ny, nx, ty,
        tx, static_cast<int>(tiles_y), static_cast<int>(tiles_x), dt, coeff);
  } else {
    dycore_fused_kernel<<<nb, ncol, smem, s>>>(
        static_cast<const float*>(fs), static_cast<const float*>(w),
        static_cast<const float*>(utens), static_cast<const float*>(ustage),
        static_cast<float*>(fout), static_cast<float*>(sout), c, d, nf, nz, ny,
        nx, ty, tx, static_cast<int>(tiles_y), static_cast<int>(tiles_x), dt,
        coeff);
  }
  return static_cast<int>(cudaGetLastError());
}
