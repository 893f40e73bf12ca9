// COSMO vertical advection: a Thomas tridiagonal solve along z per column.
//
// Replaces the TPU kernel `vadvc_pallas` (src/repro/kernels/vadvc/vadvc.py,
// body `_vadvc_kernel`), in its operation order.
//
// Bound: device-memory bytes. A column reads three fields (u_pos is u_stage
// in every caller) and its wcon and writes one, about 38 fp32 operations
// per point, so the fields' bytes set the time.
//
// Design: a batch of `batch` (nz, ny, nx) fields; each run of `group`
// consecutive fields shares one staggered wcon (the fields of one ensemble
// member), so wcon is never copied per field. One block per (member, y-tile,
// x-tile, field of the group), the field fastest, so the blocks that share a
// wcon tile run together and wcon comes from device memory about once. One
// thread per (y, x) column, threads of a block along x, so every level's
// loads and stores coalesce; z is never split (the solve is sequential in
// z). The forward sweep keeps the running (ccol, dcol) in registers and
// spills each level to an fp32 scratch of the fields' shape that the wrapper
// allocates; back substitution reads it back in reverse. The staggered
// velocity is read straight from `wcon` (nz, ny, nx + 1) at columns i and
// i + 1, each widened to fp32 before the sum, as the TPU kernel does with its
// wl / wr slices.
#include <climits>

#include "common.cuh"

namespace {

template <typename T>
__global__ void vadvc_kernel(const T* __restrict__ ustage,
                             const T* __restrict__ wcon,
                             const T* __restrict__ upos,
                             const T* __restrict__ utens,
                             const T* __restrict__ ustagetens,
                             T* __restrict__ out, float* __restrict__ ccol,
                             float* __restrict__ dcol, int group, int nz,
                             int ny, int nx, int tiles_y, int tiles_x) {
  using nero::kBetM;
  using nero::kBetP;
  using nero::kDtrStage;
  int64_t b = blockIdx.x;
  const int g = static_cast<int>(b % group);
  b /= group;
  const int i = static_cast<int>(b % tiles_x) * blockDim.x + threadIdx.x;
  b /= tiles_x;
  const int j = static_cast<int>(b % tiles_y) * blockDim.y + threadIdx.y;
  const int64_t member = b / tiles_y;
  if (i >= nx || j >= ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t wplane = static_cast<int64_t>(ny) * (nx + 1);
  const int64_t col = (member * group + g) * nz * plane +
                      static_cast<int64_t>(j) * nx + i;
  const int64_t wcol = member * nz * wplane + static_cast<int64_t>(j) * (nx + 1) + i;
  auto wsum = [&](int k) {
    return nero::ld(wcon, k * wplane + wcol) + nero::ld(wcon, k * wplane + wcol + 1);
  };
  auto u = [&](const T* a, int k) { return nero::ld(a, k * plane + col); };
  auto rhs = [&](int k) {
    return (kDtrStage * u(upos, k) + u(utens, k)) + u(ustagetens, k);
  };

  // ---- forward sweep, k = 0 ----
  float w1 = wsum(1);
  float gcv = 0.25f * w1;
  float cs = gcv * kBetM;
  float cc = gcv * kBetP;
  float u0 = u(ustage, 0), u1 = u(ustage, 1);
  float corr = -cs * (u1 - u0);
  float divided = 1.0f / (kDtrStage - cc);
  float cprev = cc * divided;
  float dprev = (rhs(0) + corr) * divided;
  ccol[col] = cprev;
  dcol[col] = dprev;

  // ---- forward sweep, 0 < k < nz-1 ----
  for (int k = 1; k < nz - 1; ++k) {
    const float wk = w1;
    w1 = wsum(k + 1);
    const float gav = -0.25f * wk;
    gcv = 0.25f * w1;
    const float as = gav * kBetM;
    cs = gcv * kBetM;
    const float acol = gav * kBetP;
    cc = gcv * kBetP;
    const float bcol = (kDtrStage - acol) - cc;
    const float um = u0;
    u0 = u1;
    u1 = u(ustage, k + 1);
    corr = -as * (um - u0) - cs * (u1 - u0);
    const float dk = rhs(k) + corr;
    divided = 1.0f / (bcol - cprev * acol);
    cprev = cc * divided;
    dprev = (dk - dprev * acol) * divided;
    ccol[k * plane + col] = cprev;
    dcol[k * plane + col] = dprev;
  }

  // ---- forward sweep, k = nz-1 ----
  const int kl = nz - 1;
  const float gav = -0.25f * w1;
  const float as = gav * kBetM;
  const float acol = gav * kBetP;
  corr = -as * (u0 - u1);
  divided = 1.0f / ((kDtrStage - acol) - cprev * acol);
  float datac = ((rhs(kl) + corr) - dprev * acol) * divided;

  // ---- backward substitution ----
  nero::st(out, kl * plane + col, kDtrStage * (datac - u(upos, kl)));
  for (int k = nz - 2; k >= 0; --k) {
    datac = dcol[k * plane + col] - ccol[k * plane + col] * datac;
    nero::st(out, k * plane + col, kDtrStage * (datac - u(upos, k)));
  }
}

}  // namespace

extern "C" int nero_vadvc(const void* ustage, const void* wcon,
                          const void* upos, const void* utens,
                          const void* ustagetens, void* out, void* ccol,
                          void* dcol, long long batch, int group, int nz,
                          int ny, int nx, int tj, int ti, int bf16,
                          void* stream) {
  if (batch < 1 || group < 1 || batch % group || nz < 2 || ny < 1 || nx < 1 ||
      tj < 1 || ti < 1 || tj * ti > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_x = (nx + ti - 1) / ti, tiles_y = (ny + tj - 1) / tj;
  const long long blocks = batch * tiles_y * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 block(ti, tj);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(ccol);
  auto d = static_cast<float*>(dcol);
  const auto nb = static_cast<unsigned>(blocks);
  const int ty = static_cast<int>(tiles_y), tx = static_cast<int>(tiles_x);
  if (bf16) {
    using T = __nv_bfloat16;
    vadvc_kernel<<<nb, block, 0, s>>>(
        static_cast<const T*>(ustage), static_cast<const T*>(wcon),
        static_cast<const T*>(upos), static_cast<const T*>(utens),
        static_cast<const T*>(ustagetens), static_cast<T*>(out), c, d, group,
        nz, ny, nx, ty, tx);
  } else {
    vadvc_kernel<<<nb, block, 0, s>>>(
        static_cast<const float*>(ustage), static_cast<const float*>(wcon),
        static_cast<const float*>(upos), static_cast<const float*>(utens),
        static_cast<const float*>(ustagetens), static_cast<float*>(out), c, d,
        group, nz, ny, nx, ty, tx);
  }
  return static_cast<int>(cudaGetLastError());
}
