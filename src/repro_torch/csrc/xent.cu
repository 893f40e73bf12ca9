// Fused LM-head cross-entropy for Hopper, the fp32 route: per-row
// next-token NLL and log-normaliser, a streaming logsumexp over vocabulary
// tiles, fp32 throughout, no logit ever written to device memory. bf16
// operands take the tensor-core route, xent_tc.cu; both end in this file's
// `nero_xent_combine`.
//
// Replaces the TPU kernel `xent_pallas`
// (src/repro/kernels/xent/xent.py, body `_xent_kernel`).
//
// Bound: operations. Each row needs 2·D·Vp flops for its logits against
// the bytes of hidden (N, D), head (D, Vp) and the per-row outputs; at the
// training path's shapes (N ~ 8k, D 2048-4096, Vp 32k-256k) that is
// thousands of flops a byte. fp32 operands need the fp32 product (TF32
// would not hold the fp32 gates), so this kernel runs on the fp32 cores: a
// register-tiled product, 128 rows by 128 columns a block, 8 x 8 outputs a
// thread.
//
// Design. A block owns a tile of BN rows and streams vocabulary tiles of
// BV columns; for each it runs the product over D in stages of BK, with the
// rows' hidden slice and the head tile staged in shared memory,
// then folds the tile into each row's running max, running sum and gold
// logit (fp32, as the TPU kernel's VMEM scratch), which live in shared
// memory across tiles. Where the TPU walks the vocabulary axis in order on
// one core, here the vocabulary of a row tile may be split over a few
// blocks (grid.y) so that enough blocks fill the 132 SMs when N is small;
// each split writes its (max, sum, gold) per row, and a second small kernel
// merges the splits into the NLL and the log-normaliser (the backward's
// `lse`). Columns at or past `vocab` (physical vocab padding) take the TPU
// kernel's finite -1e30, which adds exactly nothing once a real column has
// set the max; rows past N and columns past Vp are never stored. The head
// is read through strides: (D, Vp) contiguous along V (untied head) or
// along D (`embed.T`, tied), each with its own load order, so neither
// layout is copied. Built with -fmad=true: the product is held to its
// plain version within a tolerance, not bit for bit.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int BN = 128;              // rows a block
constexpr int BV = 128;              // vocabulary columns a tile
constexpr int BK = 16;               // depth a stage
constexpr int TM = BN / 16;          // rows a thread: ty + 16 i
constexpr int TN = BV / 16;          // columns a thread: tx + 16 j
constexpr int kPad = 4;              // shared rows padded: fewer conflicts
constexpr float kMask = -1e30f;      // the TPU kernel's NEG_INF

struct Args {
  int n, d, vp, vocab;        // vocab: columns >= vocab are masked
  long long h_sn;             // hidden row stride; D is contiguous
  long long w_sd, w_sv;       // head strides (one of them is 1)
  float softcap;              // 0: none
  int tiles_per_split;        // vocabulary tiles each grid.y covers
};

template <bool kVContig>
__global__ void __launch_bounds__(kThreads, 2)
    xent_partial(const float* __restrict__ h, const float* __restrict__ w,
                 const int* __restrict__ tgt, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ pg, Args a) {
  __shared__ float hs[BK][BN + kPad];   // hidden slice, depth-major
  __shared__ float ws[BK][BV + kPad];   // head tile
  __shared__ float row_m[BN], row_l[BN], row_g[BN];
  __shared__ int row_t[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BN;
  const int nvt = (a.vp + BV - 1) / BV;
  const int vt0 = blockIdx.y * a.tiles_per_split;
  const int vt1 = min(nvt, vt0 + a.tiles_per_split);

  for (int r = tid; r < BN; r += kThreads) {
    row_m[r] = kMask;
    row_l[r] = 0.0f;
    row_g[r] = 0.0f;
    row_t[r] = row0 + r < a.n ? tgt[row0 + r] : -1;
  }
  __syncthreads();

  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * BV;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < a.d; k0 += BK) {
      // hidden slice: a row's BK depths are contiguous
#pragma unroll
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int kk = e % BK, r = e / BK;
        const int row = row0 + r, k = k0 + kk;
        hs[kk][r] = (row < a.n && k < a.d)
                        ? h[static_cast<long long>(row) * a.h_sn + k]
                        : 0.0f;
      }
      // head tile: walk the contiguous axis with neighbouring threads
#pragma unroll
      for (int e = tid; e < BK * BV; e += kThreads) {
        const int kk = kVContig ? e / BV : e % BK;
        const int c = kVContig ? e % BV : e / BK;
        const int col = col0 + c, k = k0 + kk;
        ws[kk][c] = (col < a.vp && k < a.d)
                        ? w[static_cast<long long>(k) * a.w_sd +
                            static_cast<long long>(col) * a.w_sv]
                        : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float hv[TM], wv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) hv[i] = hs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += hv[i] * wv[j];
      }
      __syncthreads();
    }

    // Fold the tile into each row's running state. The 16 threads of a
    // row (one tx each) are 16 lanes of one warp: xor shuffles over lane
    // bits 0-3 reduce across them.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      const int t = row_t[r];
      const float m_prev = row_m[r];
      float mt = kMask, gold = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + 16 * j;
        float z = acc[i][j];
        if (a.softcap != 0.0f) z = tanhf(z / a.softcap) * a.softcap;
        if (col >= a.vocab) z = kMask;
        if (col == t) gold += z;
        acc[i][j] = z;
        mt = fmaxf(mt, z);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_prev, mt);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s += expf(acc[i][j] - m_new);
#pragma unroll
      for (int off = 8; off; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        gold += __shfl_xor_sync(0xffffffffu, gold, off);
      }
      __syncwarp();
      if (tx == 0) {
        row_l[r] = row_l[r] * expf(m_prev - m_new) + s;
        row_m[r] = m_new;
        row_g[r] += gold;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < BN; r += kThreads) {
    const int row = row0 + r;
    if (row >= a.n) continue;
    const long long o = static_cast<long long>(blockIdx.y) * a.n + row;
    pm[o] = row_m[r];
    pl[o] = row_l[r];
    pg[o] = row_g[r];
  }
}

// Merge the splits of each row: lse = M + log(sum_s l_s exp(m_s - M)),
// nll = (lse - gold) * valid.
__global__ void xent_combine(const float* __restrict__ pm,
                             const float* __restrict__ pl,
                             const float* __restrict__ pg,
                             const float* __restrict__ valid,
                             float* __restrict__ nll, float* __restrict__ lse,
                             int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float m = kMask;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, pm[static_cast<long long>(s) * n + row]);
  float l = 0.0f, g = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const long long o = static_cast<long long>(s) * n + row;
    l += pl[o] * expf(pm[o] - m);
    g += pg[o];
  }
  const float z = m + logf(fmaxf(l, 1e-37f));
  lse[row] = z;
  nll[row] = (z - g) * valid[row];
}

template <bool kVContig>
cudaError_t launch_partial(const void* h, const void* w, const int* tgt,
                           float* pm, float* pl, float* pg, const Args& a,
                           int splits, cudaStream_t st) {
  const dim3 grid((a.n + BN - 1) / BN, splits);
  xent_partial<kVContig><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), tgt, pm,
      pl, pg, a);
  return cudaGetLastError();
}

}  // namespace

// Merge the `splits` partial (max, sum, gold) of each of n rows (float32
// (splits, n) each) into nll and lse, float32 (n,); both routes end here.
extern "C" int nero_xent_combine(const void* pm, const void* pl,
                                 const void* pg, const void* valid, void* nll,
                                 void* lse, int n, int splits, void* stream) {
  xent_combine<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pg), static_cast<const float*>(valid),
      static_cast<float*>(nll), static_cast<float*>(lse), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// hidden (n, d) float32 with row stride h_sn; head (d, vp) float32 with
// strides (w_sd, w_sv), one of which is 1; targets int32 (n,); valid
// float32 (n,); scratch pm, pl, pg float32 (splits, n); out nll, lse
// float32 (n,).
extern "C" int nero_xent(const void* h, const void* w, const void* tgt,
                         const void* valid, void* pm, void* pl, void* pg,
                         void* nll, void* lse, int n, int d, int vp,
                         int vocab, long long h_sn, long long w_sd,
                         long long w_sv, float softcap, int splits,
                         int tiles_per_split, void* stream) {
  const int nvt = (vp + BV - 1) / BV;
  if (n <= 0 || d <= 0 || vp <= 0 || vocab <= 0 || vocab > vp ||
      splits <= 0 || tiles_per_split <= 0 ||
      static_cast<long long>(splits) * tiles_per_split < nvt ||
      (w_sv != 1 && w_sd != 1) || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{n, d, vp, vocab, h_sn, w_sd, w_sv, softcap, tiles_per_split};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tgt);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* g = static_cast<float*>(pg);
  const cudaError_t err =
      w_sv == 1 ? launch_partial<true>(h, w, t, m, l, g, a, splits, st)
                : launch_partial<false>(h, w, t, m, l, g, a, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nero_xent_combine(pm, pl, pg, valid, nll, lse, n, splits, stream);
}
