// Flash attention forward for Hopper, the fp32 route: GQA, causal /
// sliding window / tanh softcap, online softmax, fp32 throughout. bf16
// operands take the tensor-core route, flash_attn_tc.cu.
//
// Replaces the TPU kernel `flash_mha_pallas`
// (src/repro/kernels/flash_attention/flash.py, body `_flash_kernel`).
//
// Bound: at the serving path's prefill shapes (T = S = 1024, hd 64 or 256)
// operations: 4·hd flops for every (query, key) pair the mask keeps, against
// the bytes of q, k, v and o read or written once. fp32 operands need
// the fp32 product (TF32 would not hold the fp32 gates), so this kernel
// runs its products on the fp32 cores.
//
// Design. One block of 256 threads per (q-block, head, batch), as the TPU
// grid's (B, H, nq) axes; the TPU's sequential kv axis becomes a loop inside
// the block. Head h reads kv head h / (H / KH), as the TPU index map does,
// so KV is never replicated. q, k, v and o are read and written in their
// (B, T, H, hd) layout through strides: nothing is transposed. Per kv block
// the K and V tiles are staged in shared memory (K, like Q, with a
// padded row so the score loop is free of bank conflicts); each thread owns
// a (BQ/16) x (BK/16) patch of the score tile and a (BQ/16) x (hd/16)
// patch of the accumulator. Scores, running max, running sum and the
// accumulator stay fp32; q is scaled in fp32 as the TPU kernel scales it.
//
// Masking keeps the TPU kernel's finite -1e30 sentinel (a row whose first
// kv block is fully masked gets p = 1 there, which the later
// corr = exp(-1e30 - m) wipes out exactly; -inf would give NaN). T and S
// need not divide by the blocks: a ragged last q block stores only its
// real rows, and keys past S score -inf, so they add exactly nothing. Kv
// blocks that the mask hides from every row of a q block are skipped (the
// causal future, keys older than the window) whenever every row of the
// block keeps at least one key: their terms are then exactly zero, so
// skipping changes no bit. Blocks (BQ, BK) = (64, 64) or (32, 32);
// `kernels/flash_attention/ops.py::auto_blocks` picks the larger that fits
// the shared memory a block opts into (227 KB).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kMask = -1e30f;   // the TPU kernel's NEG_INF

struct Args {
  int T, S, H, KH;
  long long q_sb, q_st, q_sh;   // strides in elements; hd is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int causal, window;
  float softcap, scale;
};

template <int HD, int BQ, int BK>
struct Smem {
  static constexpr int kQS = HD + 1;   // padded rows: conflict-free scores
  static constexpr int kKS = HD + 1;
  static constexpr int kSS = BK + 1;
  static constexpr int kFloats =
      BQ * kQS + BK * kKS + BK * HD + BQ * kSS + 3 * BQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Args a) {
  using SM = Smem<HD, BQ, BK>;
  constexpr int RI = BQ / 16;            // rows a thread owns
  constexpr int RJ = BK / 16;            // score columns a thread owns
  constexpr int RD = HD / 16;            // accumulator columns a thread owns
  constexpr int TPR = kThreads / BQ;     // threads per row in the softmax
  constexpr int QS = SM::kQS, KS = SM::kKS, SS = SM::kSS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * HD;
  float* m_s = Ss + BQ * SS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long kh = h / (a.H / a.KH);
  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + kh * a.k_sh;
  const float* vb = v + b * a.v_sb + kh * a.v_sh;
  float* ob = o + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int t = q0 + r;
    Qs[r * QS + d] =
        t < a.T ? qb[static_cast<long long>(t) * a.q_st + d] * a.scale
                : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = kMask;
    l_s[tid] = 0.0f;
  }

  // The kv blocks this q block must visit (see the header).
  const int qe = min(q0 + BQ, a.T) - 1;
  int lo = 0, hi = a.S;
  if (!a.window || qe - a.window + 1 <= a.S - 1) {
    if (a.causal) hi = min(a.S, qe + 1);
    if (a.window) lo = max(0, q0 - a.window + 1);
  }
  const int kb_lo = lo / BK, kb_hi = (hi + BK - 1) / BK;

  float acc[RI][RD];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[r][c] = 0.0f;

  for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();   // the last block's readers of Ks, Vs, Ss are done
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (s < a.S) {
        kv = kb[static_cast<long long>(s) * a.k_ss + d];
        vv = vb[static_cast<long long>(s) * a.v_ss + d];
      }
      Ks[r * KS + d] = kv;
      Vs[r * HD + d] = vv;
    }
    __syncthreads();

    // Scores of this thread's patch: rows ti + 16r, columns tj + 16c.
    float sc[RI][RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) sc[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int r = 0; r < RI; ++r) qv[r] = Qs[(ti + 16 * r) * QS + d];
#pragma unroll
      for (int c = 0; c < RJ; ++c) kv[c] = Ks[(tj + 16 * c) * KS + d];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c)
          sc[r][c] = __fmaf_rn(qv[r], kv[c], sc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = ti + 16 * r;
      const int qpos = q0 + i;
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        const int j = tj + 16 * c;
        const int kpos = k0 + j;
        float s = sc[r][c];
        if (kpos >= a.S) {
          s = -INFINITY;               // past the end: no term at all
        } else {
          if (a.softcap > 0.0f) s = tanhf(s / a.softcap) * a.softcap;
          const bool keep = (!a.causal || kpos <= qpos) &&
                            (!a.window || qpos - kpos < a.window);
          if (!keep) s = kMask;
        }
        Ss[i * SS + j] = s;
      }
    }
    __syncthreads();

    // Online softmax: TPR neighbouring lanes share a row.
    {
      const int row = tid / TPR, part = tid % TPR;
      float mx = -INFINITY;
      for (int j = part; j < BK; j += TPR) mx = fmaxf(mx, Ss[row * SS + j]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = part; j < BK; j += TPR) {
        const float p = expf(Ss[row * SS + j] - m_new);
        Ss[row * SS + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·corr + P·V on this thread's patch: rows ti + 16r,
    // columns tj + 16c.
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const float corr = c_s[ti + 16 * r];
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[r][c] *= corr;
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pr[RI], vr[RD];
#pragma unroll
      for (int r = 0; r < RI; ++r) pr[r] = Ss[(ti + 16 * r) * SS + j];
#pragma unroll
      for (int c = 0; c < RD; ++c) vr[c] = Vs[j * HD + tj + 16 * c];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RD; ++c)
          acc[r][c] = __fmaf_rn(pr[r], vr[c], acc[r][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = ti + 16 * r;
    const int t = q0 + i;
    if (t >= a.T) continue;
    const float l = fmaxf(l_s[i], 1e-30f);
    float* orow = ob + static_cast<long long>(t) * a.o_st;
#pragma unroll
    for (int c = 0; c < RD; ++c) orow[tj + 16 * c] = acc[r][c] / l;
  }
}

template <int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Args& a, cudaStream_t stream) {
  auto kern = flash_fwd<HD, BQ, BK>;
  constexpr size_t bytes = Smem<HD, BQ, BK>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK>
int by_head_dim(int hd, const void* q, const void* k, const void* v, void* o,
                int B, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, BQ, BK>(q, k, v, o, B, a, stream);
    case 32: return launch<32, BQ, BK>(q, k, v, o, B, a, stream);
    case 64: return launch<64, BQ, BK>(q, k, v, o, B, a, stream);
    case 128: return launch<128, BQ, BK>(q, k, v, o, B, a, stream);
    case 256: return launch<256, BQ, BK>(q, k, v, o, B, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int by_blocks(int bq, int bk, int hd, const void* q, const void* k,
              const void* v, void* o, int B, const Args& a,
              cudaStream_t stream) {
  if (bq == 64 && bk == 64)
    return by_head_dim<64, 64>(hd, q, k, v, o, B, a, stream);
  if (bq == 32 && bk == 32)
    return by_head_dim<32, 32>(hd, q, k, v, o, B, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, T, H, hd), k and v (B, S, KH, hd), o (B, T, H, hd), float32, with
// the given element strides (hd contiguous).
extern "C" int nero_flash_attn(
    const void* q, const void* k, const void* v, void* o, int B,
    int T, int S, int H, int KH, int hd, int bq, int bk, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int causal, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KH <= 0 || H % KH || B > 65535 ||
      H > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{T,    S,    H,    KH,   q_sb,   q_st,   q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
               o_st, o_sh, causal, window, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_blocks(bq, bk, hd, q, k, v, o, B, a, st);
}
