// k fused dycore steps in one launch: k times (Thomas solve along z ->
// point-wise update f += dt * stage -> periodic compound hdiff), the field
// and the stage tendency carried in fp32 between the steps. Writes the state
// after k steps and the last step's stage.
//
// Replaces the TPU kernel `fused_dycore_kstep_pallas`
// (src/repro/kernels/dycore_fused/fused.py, bodies `_kstep_body`,
// `_kstep_kernel_windows` and `_kstep_kernel_prefetch`; the last two differ
// only in how the TPU fetches w and are bit-identical, so one kernel ports
// both).
//
// Bound: device-memory bytes. The round must read f, utens, utens_stage and
// the shared w once and write f_new and stage once, the bytes of one
// whole-state step, for k times the 61 fp32 operations per point of one step.
//
// Design: one block per (member, y-tile, x-tile, field), the field index
// fastest, as in dycore_fused.cu. The block owns the haloed tile of
// (ty+4k) x (tx+4k) columns, taken by periodic index, so no padded copy is
// made. Step s leaves only the columns at least 2s from the tile edge exact:
// hdiff reaches 2 columns, and the columns within 2 of the edge keep
// f + dt * stage in place of the hdiff value, garbage that never reaches the
// centre (`_window_step`'s docstring). After k steps the ty x tx centre is
// exact and is written out. Each step runs the column pieces the whole-state
// kernel runs (dycore_column.cuh), with the right-hand side rebuilt as
// (kDtrStage * f + utens) + stage_prev, so in fp32 the result is bit-equal to
// k whole-state launches. The field and the stage of every column at every
// level stay in fp32 between steps (bf16 is rounded once, at the output), in
// a per-block fp32 device scratch laid out (block, level, column) like the
// Thomas coefficients, so every level coalesces. Keeping that state in
// shared memory is later work. At each level the backward sweep reads the
// column's own field before hdiff overwrites it, and hdiff reads only the
// shared plane, so the field is updated in place. Threads loop over the
// tile's columns, so a tile may hold more columns than a block has threads.
#include <climits>

#include "dycore_column.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) dycore_kstep_kernel(
    const T* __restrict__ fs, const T* __restrict__ w,
    const T* __restrict__ utens, const T* __restrict__ ustage,
    T* __restrict__ fout, T* __restrict__ sout, float* __restrict__ fwork,
    float* __restrict__ swork, float* __restrict__ ccol,
    float* __restrict__ dcol, int nf, int nz, int ny, int nx, int ty, int tx,
    int k_steps, int tiles_y, int tiles_x, float dt, float coeff) {
  using nero::kDtrStage;
  extern __shared__ float smem[];  // two level planes + x of every column
  const int hl = 2 * k_steps;      // the round's halo
  const int tw = tx + 2 * hl, th = ty + 2 * hl;
  const int ncol = th * tw;
  float* xcol = smem + 2 * ncol;

  int64_t b = blockIdx.x;
  const int field = static_cast<int>(b % nf);
  b /= nf;
  const int i0 = static_cast<int>(b % tiles_x) * tx;
  b /= tiles_x;
  const int j0 = static_cast<int>(b % tiles_y) * ty;
  const int64_t member = b / tiles_y;

  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t vol = plane * nz;
  const int64_t fbase = (member * nf + field) * vol;
  const int64_t wbase = member * vol;
  const int64_t sbase = static_cast<int64_t>(blockIdx.x) * nz * ncol;
  float* F = fwork + sbase;
  float* S = swork + sbase;
  float* C = ccol + sbase;
  float* D = dcol + sbase;

  // The global column under tile column c (periodic), and where c sits.
  auto column = [&](int c) {
    const int jr = j0 - hl + c / tw, ir = i0 - hl + c % tw;
    const int j = ((jr % ny) + ny) % ny, i = ((ir % nx) + nx) % nx;
    return static_cast<int64_t>(j) * nx + i;
  };
  auto centre = [&](int c) {
    const int r = c / tw, q = c % tw;
    return r >= hl && r < hl + ty && q >= hl && q < hl + tx &&
           j0 - hl + r < ny && i0 - hl + q < nx;
  };
  auto inner = [&](int c) {  // hdiff's 2-deep neighbourhood lies in the tile
    const int r = c / tw, q = c % tw;
    return r >= 2 && r < th - 2 && q >= 2 && q < tw - 2;
  };

  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const int64_t col = fbase + column(c);
    for (int k = 0; k < nz; ++k) {
      F[static_cast<int64_t>(k) * ncol + c] = nero::ld(fs, col + k * plane);
      S[static_cast<int64_t>(k) * ncol + c] =
          nero::ld(ustage, col + k * plane);
    }
  }

  const int kl = nz - 1;
  for (int s = 0; s < k_steps; ++s) {
    const bool last = s == k_steps - 1;
    // ---- forward sweep of every column ----
    for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
      const int64_t gcol = column(c);
      auto f = [&](int k) { return F[static_cast<int64_t>(k) * ncol + c]; };
      auto wk = [&](int k) { return nero::ld(w, wbase + gcol + k * plane); };
      auto rhs = [&](int k, float fk) {
        return (kDtrStage * fk + nero::ld(utens, fbase + gcol + k * plane)) +
               S[static_cast<int64_t>(k) * ncol + c];
      };
      float f_last;
      xcol[c] = nero::thomas_forward(f, wk, rhs, C + c, D + c, ncol, nz,
                                     f_last);
    }
    // ---- backward sweep + update + hdiff, one level at a time ----
    for (int k = kl; k >= 0; --k) {
      float* buf = smem + (k & 1) * ncol;
      const int64_t lk = static_cast<int64_t>(k) * ncol;
      for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
        float x = xcol[c];
        const float stage = nero::thomas_back_level(x, k, kl, C + c, D + c,
                                                    ncol, F[lk + c], dt, buf,
                                                    c);
        xcol[c] = x;
        if (!last)
          S[lk + c] = stage;
        else if (centre(c))
          nero::st(sout, fbase + column(c) + k * plane, stage);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
        if (!last)
          F[lk + c] = inner(c) ? nero::hdiff_point(buf, c, tw, coeff) : buf[c];
        else if (centre(c))
          nero::st(fout, fbase + column(c) + k * plane,
                   nero::hdiff_point(buf, c, tw, coeff));
      }
    }
    __syncthreads();  // the next step's first level reuses a plane
  }
}

template <typename T>
int launch(const void* fs, const void* w, const void* utens,
           const void* ustage, void* fout, void* sout, float* fwork,
           float* swork, float* ccol, float* dcol, unsigned blocks,
           int threads, size_t smem, cudaStream_t s, int nf, int nz, int ny,
           int nx, int ty, int tx, int k_steps, int tiles_y, int tiles_x,
           float dt, float coeff) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dycore_kstep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dycore_kstep_kernel<T><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(fs), static_cast<const T*>(w),
      static_cast<const T*>(utens), static_cast<const T*>(ustage),
      static_cast<T*>(fout), static_cast<T*>(sout), fwork, swork, ccol, dcol,
      nf, nz, ny, nx, ty, tx, k_steps, tiles_y, tiles_x, dt, coeff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nero_dycore_kstep(const void* fs, const void* w,
                                 const void* utens, const void* ustage,
                                 void* fout, void* sout, void* fwork,
                                 void* swork, void* ccol, void* dcol,
                                 long long batch, int nf, int nz, int ny,
                                 int nx, float dt, float coeff, int ty, int tx,
                                 int k_steps, int threads, int bf16,
                                 void* stream) {
  if (batch < 1 || nf < 1 || nz < 2 || ny < 1 || nx < 1 || ty < 1 || tx < 1 ||
      k_steps < 1 || threads < 1 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = batch * nf * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ncol =
      static_cast<long long>(ty + 4 * k_steps) * (tx + 4 * k_steps);
  const size_t smem = 3 * sizeof(float) * ncol;
  auto s = static_cast<cudaStream_t>(stream);
  auto F = static_cast<float*>(fwork);
  auto S = static_cast<float*>(swork);
  auto C = static_cast<float*>(ccol);
  auto D = static_cast<float*>(dcol);
  const auto nb = static_cast<unsigned>(blocks);
  const int ty_ = static_cast<int>(tiles_y), tx_ = static_cast<int>(tiles_x);
  if (bf16)
    return launch<__nv_bfloat16>(fs, w, utens, ustage, fout, sout, F, S, C, D,
                                 nb, threads, smem, s, nf, nz, ny, nx, ty, tx,
                                 k_steps, ty_, tx_, dt, coeff);
  return launch<float>(fs, w, utens, ustage, fout, sout, F, S, C, D, nb,
                       threads, smem, s, nf, nz, ny, nx, ty, tx, k_steps, ty_,
                       tx_, dt, coeff);
}
