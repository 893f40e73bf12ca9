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
// operations per point: 0.421 ms in fp32 and 0.210 ms in bf16 for the main
// path's (4, 4, 64, 256, 256) state at the H100's 3.35 TB/s.
//
// Design: one block per (member, y-tile, x-tile, field), one thread per
// column of the haloed tile (ty+4) x (tx+4); halo columns are solved
// redundantly, as the TPU kernel solves its halo rows. The TPU kernel keeps x
// whole and rolls it; here x is tiled too, and both halos come from periodic
// indexing. Ragged edge tiles are masked, so no tile has to divide the grid.
//
// * The forward sweep walks the column a level at a time and keeps the
//   backward sweep's coefficient cprev_k and D_k of every level below the
//   last in an fp32 device-memory scratch, laid out (level, column) so that
//   every level coalesces. The backward sweep rereads f, writes each level's
//   updated field into one of two shared-memory planes, synchronises once,
//   and the interior threads apply hdiff there. The arithmetic is the column
//   routine of dycore_column.cuh (`w_level`, `forward_chunk`,
//   `backward_chunk`), which the k-step kernel runs too, in `_window_step`'s
//   operation order; bf16 operands are computed in fp32 and each output is
//   rounded once.
// * cprev_k depends on w alone, which every field shares. So the blocks of
//   a tile's fields run as a thread block cluster (field index fastest, a
//   cluster of `cl` fields, cl the largest divisor of nf up to 8), and the
//   cluster keeps one copy of the coefficients: every block computes cprev_k
//   in registers, as its own D recurrence needs it, and stores the levels k
//   with k % cl == its rank into the cluster's scratch; after a cluster
//   barrier (release, then acquire) each block reads all levels back. D
//   stays a block's own. At nf = 4 this cuts the scratch the step writes
//   from 2 nf to nf + 1 planes of a level, and the cluster's blocks read
//   each coefficient at about the same time, so L2 can serve all but the
//   first read. At cl = 1 the kernel is the same with the barrier left out.
// * The sweeps wait on device memory at every level, so how many loads are
//   in flight sets the time: the launch bounds hold a thread to 32
//   registers (ptxas spills a few bytes), so that two blocks of up to 1024
//   threads share an SM; the forward sweep's middle levels run in a loop
//   with unconditional loads, unrolled twice, that loads f, utens and
//   utens_stage a level before it needs them; the backward sweep loads each
//   level's coefficient, D and f one level ahead. The tile is tall
//   (tiling.dycore_tile: 24 x 32 for several fields, 1.35x the columns of
//   a 256 x 256 grid where 8 x 32 computes 1.69x; 16 x 32 for one field),
//   so the halo adds less to the scratch and the reads. L2 prefetches of
//   later levels, loads two levels ahead and a deeper unroll were slower
//   on the H100 (PERF.md).
//
// Measured (`chip_smoke.py --kernel-times`, one NVIDIA H100 80GB HBM3 at a
// 700 W power limit; PERF.md): the main path's whole state 1.387 ms queued
// in fp32 and 1.093 ms in bf16, one field 0.386 and 0.328 ms, where the
// kernel before this design (an 8 x 32 tile, a scratch copy of the
// coefficients a block) took 2.005, 1.469, 0.510 and 0.397 ms.
#include <climits>

#include "dycore_column.cuh"

namespace {

constexpr int kRec = 2;         // record floats a level: as, divided
constexpr int kMaxCluster = 8;  // the portable cluster size

template <typename T>
__global__ void __launch_bounds__(1024, 2) dycore_fused_kernel(
    const T* __restrict__ fs, const T* __restrict__ w,
    const T* __restrict__ utens, const T* __restrict__ ustage,
    T* __restrict__ fout, T* __restrict__ sout, float* __restrict__ ccol,
    float* __restrict__ dcol, int nf, int cl, int nz, int ny, int nx, int ty,
    int tx, int tiles_y, int tiles_x, float dt, float coeff) {
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
  const int kl = nz - 1;
  // the cluster's coefficients and this block's D, kl levels each
  float* cc = ccol + static_cast<int64_t>(blockIdx.x / cl) * kl * ncol + c;
  float* dc = dcol + static_cast<int64_t>(blockIdx.x) * kl * ncol + c;
  int own = field % cl;  // the next level whose coefficient this block keeps

  // ---- forward sweep, a level at a time ----
  // rk holds the record of levels k and k+1, fw (in the loop fm, f0, f1)
  // the field at k-1, k and k+1, wn w_{k+1}. The middle levels run in a loop
  // of their own whose loads are unconditional and whose body has no branch
  // but the store of an owned coefficient; levels 0, kl-1 and kl are peeled.
  float rk[2 * kRec];
  float fw[3];
  float cprev = 0.0f, dprev = 0.0f, x = 0.0f, d = 0.0f;
  float wn = nero::ld(w, wbase + plane);
  const float w2 = kl >= 2 ? nero::ld(w, wbase + 2 * plane) : 0.0f;
  nero::w_level(0, kl, 0.0f, wn, cprev, rk);
  nero::w_level(1, kl, wn, w2, cprev, rk + kRec);
  fw[0] = 0.0f;
  fw[1] = nero::ld(fs, fbase);
  fw[2] = nero::ld(fs, fbase + plane);
  // the right-hand side at a level from f, utens and utens_stage there
  auto rhs = [](float f0, float u, float s) {
    return (kDtrStage * f0 + u) + s;
  };
  auto keep = [&](int k, float c_k) {  // level k's coefficient and D
    if (k == own) {
      cc[static_cast<int64_t>(k) * ncol] = c_k;
      own += cl;
    }
    dc[static_cast<int64_t>(k) * ncol] = d;
  };
  auto roll = [&](float f_next, float w_next) {
    fw[0] = fw[1];
    fw[1] = fw[2];
    fw[2] = f_next;
    rk[0] = rk[kRec];
    rk[1] = rk[kRec + 1];
    wn = w_next;
  };
  nero::forward_chunk<1, kRec>(
      0, kl, rk, [&](int rr) -> float& { return fw[rr + 1]; },
      [&](int) -> float& { return d; },
      [&](int, float f0) {
        return rhs(f0, nero::ld(utens, fbase), nero::ld(ustage, fbase));
      },
      dprev, x);
  keep(0, nero::c_coef<kRec>(rk));
  roll(kl >= 2 ? nero::ld(fs, fbase + 2 * plane) : 0.0f, w2);
  // levels 1 .. kl-2: level k+1 is a middle level too. u0, s0 hold utens
  // and utens_stage at level k, loaded a level ahead (level 1 exists at
  // every nz >= 2).
  float u0 = nero::ld(utens, fbase + plane);
  float s0 = nero::ld(ustage, fbase + plane);
  {
    float fm = fw[0], f0 = fw[1], f1 = fw[2];
#pragma unroll 2
    for (int k = 1; k + 1 < kl; ++k) {
      const int64_t o = fbase + k * plane;
      const float w_next = nero::ld(w, wbase + (k + 2) * plane);
      const float u1 = nero::ld(utens, o + plane);
      const float s1 = nero::ld(ustage, o + plane);
      const float c_k = cprev;  // c_coef at level k, exactly
      nero::w_level_mid(wn, w_next, cprev, rk + kRec);
      d = nero::forward_mid<kRec>(rk, fm, f0, f1, rhs(f0, u0, s0), d);
      keep(k, c_k);
      fm = f0;
      f0 = f1;
      f1 = nero::ld(fs, o + 2 * plane);
      u0 = u1;
      s0 = s1;
      rk[0] = rk[kRec];
      rk[1] = rk[kRec + 1];
      wn = w_next;
    }
    fw[0] = fm;
    fw[1] = f0;
    fw[2] = f1;
  }
  if (kl >= 2) {  // level kl-1, whose next level is the last
    nero::w_level(kl, kl, wn, 0.0f, cprev, rk + kRec);
    d = nero::forward_mid<kRec>(rk, fw[0], fw[1], fw[2], rhs(fw[1], u0, s0),
                                d);
    keep(kl - 1, nero::c_coef<kRec>(rk));
    roll(0.0f, 0.0f);
  }
  dprev = d;
  nero::forward_chunk<1, kRec>(
      kl, kl, rk, [&](int rr) -> float& { return fw[rr + 1]; },
      [&](int) -> float& { return d; },
      [&](int, float f0) {
        const int64_t o = fbase + kl * plane;
        return rhs(f0, nero::ld(utens, o), nero::ld(ustage, o));
      },
      dprev, x);
  const float f_last = fw[1];
  // The cluster's coefficients are complete once every block has arrived;
  // level kl needs none of them, so it runs before the wait.
  if (cl > 1) nero::cluster_arrive();

  // ---- backward sweep + update + hdiff, a level at a time ----
  // level k from f_k and accessors of its coefficient and D (at kl, unread)
  auto level = [&](int k, float fk, auto cco, auto dco) {
    const int64_t o = fbase + k * plane;
    float* buf = lvl + (k & 1) * ncol;
    nero::backward_chunk<1>(
        k, kl, cco, [&](int) { return fk; }, dco, dt, x,
        [&](int, int, float v, float stage) {
          buf[c] = v;
          if (interior) nero::st(sout, o, stage);
        });
    __syncthreads();
    if (interior) nero::st(fout, o, nero::hdiff_point(buf, c, tw, coeff));
  };
  level(kl, f_last, [](int) { return 0.0f; }, [](int) { return 0.0f; });
  if (cl > 1) nero::cluster_wait();
  // levels kl-1 .. 0, each one's coefficient, D and f loaded a level ahead;
  // the coefficients were written by other blocks' SMs: read them from L2
  float cv = __ldcg(cc + (kl - 1) * static_cast<int64_t>(ncol));
  float dv = dc[(kl - 1) * static_cast<int64_t>(ncol)];
  float fv = nero::ld(fs, fbase + (kl - 1) * plane);
  for (int k = kl - 1; k >= 0; --k) {
    const int kn = k > 0 ? k - 1 : 0;
    const int64_t at = static_cast<int64_t>(kn) * ncol;
    const float cn = __ldcg(cc + at), dn = dc[at];
    const float fn = nero::ld(fs, fbase + kn * plane);
    level(k, fv, [&](int) { return cv; }, [&](int) { return dv; });
    cv = cn;
    dv = dn;
    fv = fn;
  }
}

template <typename T>
int launch(const void* fs, const void* w, const void* utens,
           const void* ustage, void* fout, void* sout, void* ccol, void* dcol,
           unsigned blocks, int ncol, int cl, cudaStream_t s, int nf, int nz,
           int ny, int nx, int ty, int tx, int tiles_y, int tiles_x,
           float dt, float coeff) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(ncol);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * ncol;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, dycore_fused_kernel<T>, static_cast<const T*>(fs),
      static_cast<const T*>(w), static_cast<const T*>(utens),
      static_cast<const T*>(ustage), static_cast<T*>(fout),
      static_cast<T*>(sout), static_cast<float*>(ccol),
      static_cast<float*>(dcol), nf, cl, nz, ny, nx, ty, tx, tiles_y, tiles_x,
      dt, coeff);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fs, utens, ustage, fout, sout: (batch, nf, nz, ny, nx); w: (batch, nz, ny,
// nx); all contiguous, float32 or (`bf16`) bfloat16. ccol: fp32 scratch of
// (batch * tiles * nf / cl, nz - 1, (ty+4) * (tx+4)), one a cluster of `cl`
// field blocks (cl divides nf, at most 8); dcol: fp32 scratch of (batch *
// tiles * nf, nz - 1, (ty+4) * (tx+4)), one a block. One block of
// (ty+4) x (tx+4) threads per tile and field.
extern "C" int nero_dycore_fused(const void* fs, const void* w,
                                 const void* utens, const void* ustage,
                                 void* fout, void* sout, void* ccol, void* dcol,
                                 long long batch, int nf, int cl, int nz,
                                 int ny, int nx, float dt, float coeff, int ty,
                                 int tx, int bf16, void* stream) {
  if (batch < 1 || nf < 1 || cl < 1 || cl > kMaxCluster || nf % cl ||
      nz < 2 || ny < 1 || nx < 1 || ty < 1 || tx < 1 ||
      (ty + 4) * (tx + 4) > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = batch * nf * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ncol = (ty + 4) * (tx + 4);
  auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const int ty_ = static_cast<int>(tiles_y), tx_ = static_cast<int>(tiles_x);
  if (bf16)
    return launch<__nv_bfloat16>(fs, w, utens, ustage, fout, sout, ccol, dcol,
                                 nb, ncol, cl, s, nf, nz, ny, nx, ty, tx, ty_,
                                 tx_, dt, coeff);
  return launch<float>(fs, w, utens, ustage, fout, sout, ccol, dcol, nb, ncol,
                       cl, s, nf, nz, ny, nx, ty, tx, ty_, tx_, dt, coeff);
}
