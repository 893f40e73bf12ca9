// Fused LM-head cross-entropy for Hopper, the bf16 route: the logits'
// product on the tensor cores (wgmma, bf16 x bf16 -> fp32), the streaming
// logsumexp in fp32 registers, no logit ever written to device memory. The
// fp32 route, and the kernel that merges the vocabulary splits of both, is
// xent.cu.
//
// Replaces the TPU kernel `xent_pallas` (src/repro/kernels/xent/xent.py,
// body `_xent_kernel`), whose product casts to fp32 first: a product of
// two bf16 values is exact in fp32, so a tensor-core product with fp32
// accumulation computes the same logits up to the order of the sums.
//
// Bound: operations. 2·D·Vp flops a row on the bf16 tensor cores against
// the bytes of hidden (N, D), head (D, Vp) and the per-row outputs: at the
// training path's shapes (N ~ 8k, D 2048-4096, Vp 32k-256k) thousands of
// flops a byte.
//
// Design. A block of two consumer warpgroups owns BN = 128 rows (64 each)
// and streams vocabulary tiles of BV = 256 columns; each tile's product
// runs over D in stages of BK = 64 (one 128-byte swizzled row of bf16)
// through a ring of four shared-memory stages filled by cp.async (16-byte
// copies, each thread at fixed offsets; rows that are not 16-byte aligned
// take a scalar copy). The ring
// runs on across tiles, so the next tile's first stages load during this
// tile's epilogue; two stages load ahead while one stage's wgmma is in
// flight. Per stage each warpgroup issues four m64n256k16 wgmma with the
// hidden slice (K-major) and the head tile from shared memory, read in its
// own layout without a copy: `embed.T` (contiguous along D) K-major, the
// untied (D, Vp) head (contiguous along V) MN-major. After a tile's last
// stage the epilogue folds the accumulator in registers into each row's
// running max, sum and gold logit (softcap, the `vocab` mask at the TPU
// kernel's finite -1e30, the gold pick), as xent.cu does in shared memory:
// a row lives in the four lanes of a quad, whose max is two shuffles, and
// the sums stay per lane until the end. As in xent.cu the vocabulary of a
// row tile may be split over a few blocks (grid.y) to fill the 132 SMs;
// `nero_xent_combine` merges the splits into the NLL and the
// log-normaliser. N, Vp and D need not divide by the tiles: rows past N
// and columns past Vp load zeros and are never stored (the columns take
// -1e30 with the padding), depth past D loads zeros. Built with -fmad=true.
#include "tc_bf16.cuh"

#include <cmath>
#include <cstdint>

extern "C" int nero_xent_combine(const void* pm, const void* pl,
                                 const void* pg, const void* valid, void* nll,
                                 void* lse, int n, int splits, void* stream);

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;        // two consumer warpgroups
constexpr int BN = 128;              // rows a block, 64 a warpgroup
constexpr int BV = 256;              // vocabulary columns a tile
constexpr int BK = 64;               // depth a stage: one 128-byte row
constexpr int kStages = 4;           // the ring
constexpr int kAhead = kStages - 2;  // stages loading while one computes
constexpr int kA = BN * BK * 2;      // bytes of a stage's hidden slice
constexpr int kB = BV * BK * 2;      // bytes of a stage's head tile
constexpr size_t kSmem = kStages * (kA + kB) + 1024;   // + alignment
constexpr float kMask = -1e30f;      // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  int n, d, vp, vocab;        // vocab: columns >= vocab are masked
  long long h_sn;             // hidden row stride; D is contiguous
  long long w_sd, w_sv;       // head strides (one of them is 1)
  float softcap;              // 0: none
  int tiles_per_split;        // vocabulary tiles each grid.y covers
  int h_aligned, w_aligned;   // rows readable by 16-byte copies
};

__device__ __forceinline__ int clamp8(int x) { return max(0, min(8, x)); }

// One stage by scalar loads, for rows that are not 16-byte aligned: the
// hidden slice (BN rows x 8 chunks of 8 depths) and the head tile, untied
// (BK depth rows of BV columns in slabs of 64 columns, MN-major) or
// embed.T (BV vocabulary rows x 8 chunks of 8 depths, K-major).
template <bool kVContig>
__device__ __forceinline__ void load_scalar(uint32_t dA, uint32_t dB,
                                         const bf16* h, const bf16* w,
                                         const Args& a, int row0, int col0,
                                         int k0, int tid) {
  for (int c = tid; c < BN * 8; c += kThreads) {
    const int r = c / 8, k = k0 + (c % 8) * 8, row = row0 + r;
    const int cnt = row < a.n ? clamp8(a.d - k) : 0;
    tc::copy_scalar(dA + tc::swz<128>(r * 128 + (c % 8) * 16),
                    h + (cnt ? static_cast<long long>(row) * a.h_sn + k : 0),
                    cnt);
  }
  if constexpr (kVContig) {
    for (int c = tid; c < BK * (BV / 8); c += kThreads) {
      const int kr = c / (BV / 8), cc = c % (BV / 8);
      const int k = k0 + kr, col = col0 + cc * 8;
      const int cnt = k < a.d ? clamp8(a.vp - col) : 0;
      tc::copy_scalar(
          dB + tc::swz<128>((cc / 8) * (BK * 128) + kr * 128 + (cc % 8) * 16),
          w + (cnt ? static_cast<long long>(k) * a.w_sd + col : 0), cnt);
    }
  } else {
    for (int c = tid; c < BV * 8; c += kThreads) {
      const int j = c / 8, k = k0 + (c % 8) * 8, col = col0 + j;
      const int cnt = col < a.vp ? clamp8(a.d - k) : 0;
      tc::copy_scalar(dB + tc::swz<128>(j * 128 + (c % 8) * 16),
                      w + (cnt ? static_cast<long long>(col) * a.w_sv + k : 0),
                      cnt);
    }
  }
}

template <bool kVContig>
__global__ void __launch_bounds__(kThreads, 1)
    xent_partial_tc(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ tgt, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pg, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sA = (tc::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sB = sA + kStages * kA;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BN;
  const int nvt = (a.vp + BV - 1) / BV;
  const int vt0 = blockIdx.y * a.tiles_per_split;
  const int vt1 = min(nvt, vt0 + a.tiles_per_split);
  const int nk = (a.d + BK - 1) / BK;
  const int nf = max(0, vt1 - vt0) * nk;   // (tile, depth stage) pairs

  // Stage f of the ring: tile vt0 + f / nk, depth (f % nk)·BK. With
  // 16-byte aligned rows each thread keeps one chunk column and walks rows
  // 32 apart (hidden, embed.T) or 8 apart (the untied head), multiples of
  // the swizzle's 8-row period, so its shared offsets step by a constant.
  const bool aligned = a.h_aligned && a.w_aligned;
  const int ca = tid % 8, ra = tid / 8;                 // hidden, embed.T
  const int cb = tid % (BV / 8), rb = tid / (BV / 8);   // untied head
  const uint32_t dA0 = tc::swz<128>(ra * 128 + ca * 16);
  const uint32_t dB0 =
      kVContig ? tc::swz<128>((cb / 8) * (BK * 128) + rb * 128 + (cb % 8) * 16)
               : dA0;
  auto load = [&](int f) {
    const int st = f % kStages;
    const int col0 = (vt0 + f / nk) * BV, k0 = (f % nk) * BK;
    const uint32_t dA = sA + st * kA, dB = sB + st * kB;
    if (!aligned) {
      load_scalar<kVContig>(dA, dB, h, w, a, row0, col0, k0, tid);
      return;
    }
    const int ka = k0 + ca * 8, na = clamp8(a.d - ka);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int row = row0 + ra + 32 * j;
      const int cnt = row < a.n ? na : 0;
      tc::cp_async16(dA + dA0 + j * 32 * 128,
                     cnt ? h + static_cast<long long>(row) * a.h_sn + ka : h,
                     2 * cnt);
    }
    if constexpr (kVContig) {
      const int col = col0 + cb * 8, nb = clamp8(a.vp - col);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int k = k0 + rb + 8 * j;
        const int cnt = k < a.d ? nb : 0;
        tc::cp_async16(dB + dB0 + j * 8 * 128,
                       cnt ? w + static_cast<long long>(k) * a.w_sd + col : w,
                       2 * cnt);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) {
        const int col = col0 + ra + 32 * j;
        const int cnt = col < a.vp ? na : 0;
        tc::cp_async16(dB + dB0 + j * 32 * 128,
                       cnt ? w + static_cast<long long>(col) * a.w_sv + ka : w,
                       2 * cnt);
      }
    }
  };

#pragma unroll
  for (int f = 0; f < kAhead; ++f) {
    if (f < nf) load(f);
    tc::cp_async_commit();
  }

  const tc::Frag fr(warp, lane);
  int rows[2], gold_col[2];
  float m[2], l[2], g[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = row0 + 64 * wg + fr.row0 + 8 * r;
    gold_col[r] = rows[r] < a.n ? tgt[rows[r]] : -1;
    m[r] = kMask;
    l[r] = 0.0f;
    g[r] = 0.0f;
  }
  float acc[BV / 2];
#pragma unroll
  for (int i = 0; i < BV / 2; ++i) acc[i] = 0.0f;

  int f = 0;   // the ring's position
  for (int vt = vt0; vt < vt1; ++vt) {
    tc::fence_regs(acc);   // the last epilogue's writes come first
    for (int kd = 0; kd < nk; ++kd, ++f) {
      tc::cp_async_wait<kAhead - 1>();   // stage f has landed
      tc::fence_proxy_async();
      __syncthreads();   // ... for every thread; stage f - 2's wgmma are done
      if (f + kAhead < nf) load(f + kAhead);   // into stage f - 2's slot
      tc::cp_async_commit();

      const int st = f % kStages;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = tc::desc<128>(sA + st * kA + 64 * wg * 128 +
                                              kk * 32, 16, 1024);
        if constexpr (kVContig) {
          const uint64_t db = tc::desc<128>(sB + st * kB + kk * 16 * 128,
                                            BK * 128, 1024);
          tc::Mma<BV>::ss<0, 1>(acc, da, db, kd > 0 || kk > 0);
        } else {
          const uint64_t db = tc::desc<128>(sB + st * kB + kk * 32, 16,
                                            1024);
          tc::Mma<BV>::ss<0, 0>(acc, da, db, kd > 0 || kk > 0);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();   // the last stage's product is done
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);

    // Fold the tile into each row's running state; the uniform branches
    // stay outside the element loops.
    const int col0 = vt * BV;
    if (a.softcap != 0.0f) {
      const float in = 1.0f / a.softcap;
#pragma unroll
      for (int i = 0; i < BV / 2; ++i) acc[i] = tanhf(acc[i] * in) * a.softcap;
    }
    if (col0 + BV > a.vocab) {
#pragma unroll
      for (int i = 0; i < BV / 2; ++i)
        if (col0 + fr.col(i) >= a.vocab) acc[i] = kMask;
    }
    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int i = 0; i < BV / 2; ++i) {
      const int r = tc::Frag::half(i);
      if (col0 + fr.col(i) == gold_col[r]) g[r] += acc[i];
      mx[r] = fmaxf(mx[r], acc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tc::quad_max(mx[r]));
      l[r] *= exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BV / 2; ++i) {
      const int r = tc::Frag::half(i);
      l[r] += exp2f((acc[i] - m[r]) * kLog2e);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = tc::quad_sum(l[r]), gs = tc::quad_sum(g[r]);
    if (lane % 4 == 0 && rows[r] < a.n) {
      const long long o = static_cast<long long>(blockIdx.y) * a.n + rows[r];
      pm[o] = m[r];
      pl[o] = ls;
      pg[o] = gs;
    }
  }
}

template <bool kVContig>
int launch_partial(const void* h, const void* w, const void* tgt, void* pm,
                   void* pl, void* pg, const Args& a, int splits,
                   cudaStream_t st) {
  auto kern = xent_partial_tc<kVContig>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n + BN - 1) / BN, splits);
  kern<<<grid, kThreads, kSmem, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(tgt), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pg), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hidden (n, d) bfloat16 with row stride h_sn; head (d, vp) bfloat16 with
// strides (w_sd, w_sv), one of which is 1; targets int32 (n,); valid
// float32 (n,); scratch pm, pl, pg float32 (splits, n); out nll, lse
// float32 (n,). `tiles_per_split` counts tiles of BV columns.
extern "C" int nero_xent_tc(const void* h, const void* w, const void* tgt,
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
  const bool vcontig = w_sv == 1;
  const Args a{n, d, vp, vocab, h_sn, w_sd, w_sv, softcap, tiles_per_split,
               tc::rows_aligned(h, h_sn),
               tc::rows_aligned(w, vcontig ? w_sd : w_sv)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      vcontig ? launch_partial<true>(h, w, tgt, pm, pl, pg, a, splits, st)
              : launch_partial<false>(h, w, tgt, pm, pl, pg, a, splits, st);
  if (err) return err;
  return nero_xent_combine(pm, pl, pg, valid, nll, lse, n, splits, stream);
}
