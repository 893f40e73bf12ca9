// Flash attention forward for Hopper, the bf16 route: q·kᵀ and p·v on the
// tensor cores (wgmma, bf16 x bf16 -> fp32), the online softmax in fp32
// registers, output in bf16. The fp32 route is flash_attn.cu.
//
// Replaces the TPU kernel `flash_mha_pallas`
// (src/repro/kernels/flash_attention/flash.py, body `_flash_kernel`), whose
// products cast to fp32 first: a product of two bf16 values is exact in
// fp32, so a tensor-core product with fp32 accumulation computes the same
// function up to the order of the sums.
//
// Bound: operations at the serving and training paths' shapes (T = S =
// 1024-2048, hd 64 or 256): 4·hd flops for every (query, key) pair the mask
// keeps, on the bf16 tensor cores, against the bytes of q, k, v and o.
//
// Design. A block holds BQ/64 consumer warpgroups (BQ = 128: two), each
// owning 64 query rows of one (batch, head); the TPU grid's sequential kv
// axis becomes a loop over kv blocks of BK keys that streams K and V
// through a ring of two shared-memory stages (cp.async, 16-byte copies at
// fixed per-thread offsets: block j+1 loads while block j computes). Per
// kv block each warpgroup runs S = Q·Kᵀ as hd/16 wgmma with Q and K from
// shared memory (both K-major), scales S in fp32 (hd^-0.5 is not a bf16
// for every hd), masks it only where the block is partly masked, and runs
// the online softmax on the accumulator in registers: each row lives in
// the four lanes of a quad, whose max and sum are two shuffles. Then
// O += P·V as BK/16 wgmma pairs with P from registers (the accumulator's
// fragment is the A operand's) and V from shared memory read MN-major
// (wgmma transposes 16-bit operands). P is not rounded to one bf16:
// p_hi = bf16(p) and p_lo = bf16(p - p_hi) go through two products, so
// each term keeps ~16 bits (a single bf16 would put 2^-9·|p v| on each
// term, more than the output's own rounding where the output is near 0).
// Tiles live in shared memory in the 128-, 64- or 32-byte swizzle
// (`tc_bf16.cuh`), so head dims 16 and 32 take the narrower swizzles.
//
// It keeps what the fp32 route guarantees (flash_attn.cu): the finite
// -1e30 sentinel and -inf past S; ragged T and S (rows past T load zeros
// and are not stored, keys past S load zeros and score -inf); GQA by
// h / (H / KH) with no replication; q, k, v and o in their (B, T, H, hd)
// layout through strides (rows that are not 16-byte aligned take a scalar
// copy); and exact skipping of kv blocks the mask hides from every row of
// a warpgroup, whenever each of its rows keeps a key.
#include "tc_bf16.cuh"

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kMask = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  int T, S, H, KH;
  long long q_sb, q_st, q_sh;   // strides in elements; hd is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int causal, window;
  float softcap, scale;
  int q_aligned, kv_aligned;    // rows readable by 16-byte copies
};

// Shared memory of one block: Q (BQ x HD), then two stages of K and two of
// V (BK x HD each), bf16, each cut into HD·2/RB slabs of RB-byte rows.
template <int HD, int BQ, int BK>
struct Tiles {
  static constexpr int RB = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kQ = BQ * HD * 2;
  static constexpr int kKV = BK * HD * 2;
  static constexpr int kStages = 2;
  static constexpr size_t kBytes = kQ + 2 * kStages * kKV + 1024;  // + align
};

// Copy rows [r0, r0 + ROWS) of a (rows, HD) bf16 operand with row stride
// `stride` into a tile at `dst`; rows at or past `nrows` are zero. With
// 16-byte aligned rows each thread keeps one chunk column and walks rows
// NT / (HD / 8) apart, a multiple of the swizzle's 8-row period, so its
// shared offsets step by a constant; other rows take the scalar copy.
template <int HD, int RB, int ROWS, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          long long stride, int r0,
                                          int nrows, bool aligned, int tid) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks a row
  constexpr int kPerSlab = RB / 16;        // chunks a slab row
  if (aligned) {
    constexpr int kStep = NT / kChunks;    // rows between a thread's chunks
    static_assert(NT % kChunks == 0 && kStep % 8 == 0, "chunk walk");
    const int ch = tid % kChunks, r = tid / kChunks;
    const uint32_t d0 = dst + tc::swz<RB>((ch / kPerSlab) * ROWS * RB +
                                          r * RB + (ch % kPerSlab) * 16);
    const bf16* s0 = src + ch * 8;
#pragma unroll
    for (int j = 0; j < (ROWS + kStep - 1) / kStep; ++j) {
      const int row = r + j * kStep;
      if (ROWS % kStep != 0 && row >= ROWS) break;
      const bool ok = r0 + row < nrows;
      tc::cp_async16(d0 + j * kStep * RB,
                     ok ? s0 + static_cast<long long>(r0 + row) * stride : src,
                     ok ? 16 : 0);
    }
    return;
  }
  for (int c = tid; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks, ch = c % kChunks;
    const int slab = ch / kPerSlab, cs = ch % kPerSlab;
    const bool ok = r0 + r < nrows;
    const bf16* p = src + (ok ? static_cast<long long>(r0 + r) * stride : 0) +
                    ch * 8;
    tc::copy_scalar(dst + tc::swz<RB>(slab * ROWS * RB + r * RB + cs * 16),
                    p, ok ? 8 : 0);
  }
}

// The kv range [lo, hi) that rows [qa, qe] must visit (see the header).
__device__ __forceinline__ void kv_range(const Args& a, int qa, int qe,
                                         int& lo, int& hi) {
  lo = 0;
  hi = a.S;
  if (!a.window || qe - a.window + 1 <= a.S - 1) {
    if (a.causal) hi = min(a.S, qe + 1);
    if (a.window) lo = max(0, qa - a.window + 1);
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 64 * 128, 1)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Args a) {
  using L = Tiles<HD, BQ, BK>;
  constexpr int RB = L::RB;
  constexpr int NT = BQ / 64 * 128;
  constexpr int kSlabK = RB / 32;          // k16 steps in one slab row
  using MmaS = tc::Mma<BK>;
  using MmaO = tc::Mma<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (tc::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + L::kQ;
  const uint32_t sV = sK + L::kStages * L::kKV;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long kh = h / (a.H / a.KH);
  const bf16* qb = q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = k + b * a.k_sb + kh * a.k_sh;
  const bf16* vb = v + b * a.v_sb + kh * a.v_sh;
  bf16* ob = o + b * a.o_sb + h * a.o_sh;

  // This warpgroup's rows and kv blocks, and the block's (their union).
  const int qa = q0 + 64 * wg;
  const bool has_rows = qa < a.T;
  int lo, hi;
  kv_range(a, qa, min(qa + 64, a.T) - 1, lo, hi);
  const int my_lo = lo / BK, my_hi = has_rows ? (hi + BK - 1) / BK : 0;
  kv_range(a, q0, min(q0 + BQ, a.T) - 1, lo, hi);
  const int kb_lo = lo / BK, nkv = (hi + BK - 1) / BK - kb_lo;

  auto load_kv = [&](int kbi, int st) {
    load_rows<HD, RB, BK, NT>(sK + st * L::kKV, kb, a.k_ss, kbi * BK, a.S,
                              a.kv_aligned, tid);
    load_rows<HD, RB, BK, NT>(sV + st * L::kKV, vb, a.v_ss, kbi * BK, a.S,
                              a.kv_aligned, tid);
  };
  load_rows<HD, RB, BQ, NT>(sQ, qb, a.q_st, q0, a.T, a.q_aligned, tid);
  load_kv(kb_lo, 0);
  tc::cp_async_commit();

  const tc::Frag fr(warp, lane);
  const int qpos[2] = {qa + fr.row0, qa + fr.row0 + 8};
  float m[2] = {kMask, kMask}, l[2] = {0.0f, 0.0f}, corr[2];
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
  uint32_t phi[BK / 16][4], plo[BK / 16][4];   // P, for P·V

  float s[BK / 2];
  // S = Q·Kᵀ of the block in K stage `st`: A = Q (this warpgroup's 64
  // rows), B = K, both K-major.
  auto issue_s = [&](int st) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    tc::fence_regs(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % kSlabK) * 32;
      const uint64_t da = tc::desc<RB>(
          sQ + (kk / kSlabK) * (BQ * RB) + 64 * wg * RB + off, 16, 8 * RB);
      const uint64_t db = tc::desc<RB>(
          sK + st * L::kKV + (kk / kSlabK) * (BK * RB) + off, 16, 8 * RB);
      MmaS::template ss<0, 0>(s, da, db, kk > 0);
    }
    tc::wgmma_commit();
  };
  // O += P·V of the block in stage `st`: A = P from registers, B = V read
  // MN-major.
  auto issue_pv = [&](int st) {
    tc::fence_regs(oacc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = tc::desc<RB>(sV + st * L::kKV + kk * 16 * RB,
                                       BK * RB, 8 * RB);
      MmaO::template rs<1>(oacc, phi[kk], db, 1);
      MmaO::template rs<1>(oacc, plo[kk], db, 1);
    }
    tc::wgmma_commit();
  };
  // The online softmax of the block at key k0 on S, in place: s becomes
  // p, with the rows' running max, sum and correction updated.
  auto softmax = [&](int k0) {
    tc::fence_regs(s);
    // Scores in base 2: p = exp2(z·log2 e - m). A block that some row
    // of this warpgroup sees only in part (keys past S, the causal future,
    // keys older than the window) or a softcap scales first (sc = 1
    // after); a full block keeps the raw product and folds the scale into
    // the exponent's FMA. The branches are uniform, outside the loops.
    const bool masked = k0 + BK > a.S || (a.causal && k0 + BK - 1 > qa) ||
                        (a.window && qa + 63 - k0 >= a.window);
    float sc = 1.0f;
    if (a.softcap > 0.0f) {
      const float in = a.scale / a.softcap, out = a.softcap * kLog2e;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = tanhf(s[i] * in) * out;
    } else if (masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= a.scale * kLog2e;
    } else {
      sc = a.scale * kLog2e;
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k0 + fr.col(i);
        const int qp = qpos[tc::Frag::half(i)];
        const bool keep = (!a.causal || kpos <= qp) &&
                          (!a.window || qp - kpos < a.window);
        if (kpos >= a.S)
          s[i] = -INFINITY;          // past the end: no term at all
        else if (!keep)
          s[i] = kMask;
      }
    }
    // The rows' running max (sc > 0 commutes with max). z - m is exact
    // where both are the -1e30 sentinel (sc = 1 there), so a row whose
    // keys are all masked so far gets p = 1.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[tc::Frag::half(i)] = fmaxf(mx[tc::Frag::half(i)], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tc::quad_max(mx[r]) * sc);
      corr[r] = tc::exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // p = exp2(z - m) in fp32, in place, and the rows' sums
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = tc::exp2_approx(fmaf(s[i], sc, -m[tc::Frag::half(i)]));
      l[tc::Frag::half(i)] += s[i];
    }
  };
  // Rescale O where a row's max moved (a warp's own 16 rows), then P as
  // p_hi + p_lo: floats i, i+1 of chunk i/4 are register (i % 8)/2 of
  // k-step i/8.
  auto rescale_and_pack = [&]() {
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[tc::Frag::half(i)];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const uint32_t hi = tc::pack_bf16(s[i], s[i + 1]);
      phi[i / 8][(i % 8) / 2] = hi;
      plo[i / 8][(i % 8) / 2] =
          tc::pack_bf16(s[i] - __uint_as_float(hi << 16),
                        s[i + 1] - __uint_as_float(hi & 0xffff0000u));
    }
  };

  // One barrier a block: after it, block kbi has landed and every reader
  // of block kbi - 1's stage is done, so block kbi + 1 loads into it
  // (behind this block's S when this warpgroup computes).
  for (int it = 0; it < nkv; ++it) {
    const int kbi = kb_lo + it, st = it & 1;
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    if (kbi >= my_lo && kbi < my_hi) {
      issue_s(st);
      if (it + 1 < nkv) load_kv(kbi + 1, st ^ 1);
      tc::cp_async_commit();
      tc::wgmma_wait<0>();
      softmax(kbi * BK);
      rescale_and_pack();
      issue_pv(st);
      tc::wgmma_wait<0>();
      tc::fence_regs(oacc);
    } else {
      if (it + 1 < nkv) load_kv(kbi + 1, st ^ 1);
      tc::cp_async_commit();
    }
  }
  tc::cp_async_wait<0>();
  if (!has_rows) return;

  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = fmaxf(tc::quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = tc::Frag::half(i);
    const int t = qpos[r];
    if (t >= a.T) continue;
    const __nv_bfloat162 val =
        __floats2bfloat162_rn(oacc[i] / lsum[r], oacc[i + 1] / lsum[r]);
    *reinterpret_cast<__nv_bfloat162*>(
        ob + static_cast<long long>(t) * a.o_st + fr.col(i)) = val;
  }
}

template <int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Args& a, cudaStream_t stream) {
  auto kern = flash_fwd_tc<HD, BQ, BK>;
  constexpr size_t bytes = Tiles<HD, BQ, BK>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, B);
  kern<<<grid, BQ / 64 * 128, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

// The tiles `kernels/flash_attention/flash.py::TC_BLOCKS` names: (128, 128)
// for hd <= 128 and (128, 64) for any hd; hd 256 at (128, 128) would need
// more than a block's 227 KB.
template <int HD>
int by_blocks(int bq, int bk, const void* q, const void* k, const void* v,
              void* o, int B, const Args& a, cudaStream_t stream) {
  if (bq == 128 && bk == 64)
    return launch<HD, 128, 64>(q, k, v, o, B, a, stream);
  if constexpr (HD <= 128) {
    if (bq == 128 && bk == 128)
      return launch<HD, 128, 128>(q, k, v, o, B, a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, T, H, hd), k and v (B, S, KH, hd), o (B, T, H, hd), bfloat16, with
// the given element strides (hd contiguous; o 4-byte aligned rows).
extern "C" int nero_flash_attn_tc(
    const void* q, const void* k, const void* v, void* o, int B, int T,
    int S, int H, int KH, int hd, int bq, int bk, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int causal, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KH <= 0 || H % KH || B > 65535 ||
      H > 65535 || window < 0 || o_st % 2 || o_sh % 2 || o_sb % 2 ||
      reinterpret_cast<uintptr_t>(o) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // every row of q (and of k, v) must be 16-byte aligned for cp.async
  const bool q_al = tc::rows_aligned(q, q_st) && q_sh % 8 == 0 &&
                    q_sb % 8 == 0;
  const bool kv_al = tc::rows_aligned(k, k_ss) && k_sh % 8 == 0 &&
                     k_sb % 8 == 0 && tc::rows_aligned(v, v_ss) &&
                     v_sh % 8 == 0 && v_sb % 8 == 0;
  const Args a{T,    S,    H,    KH,   q_sb,   q_st,   q_sh,   k_sb,
               k_ss, k_sh, v_sb, v_ss, v_sh,   o_sb,   o_st,   o_sh,
               causal, window, softcap, scale, q_al, kv_al};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return by_blocks<16>(bq, bk, q, k, v, o, B, a, st);
    case 32: return by_blocks<32>(bq, bk, q, k, v, o, B, a, st);
    case 64: return by_blocks<64>(bq, bk, q, k, v, o, B, a, st);
    case 128: return by_blocks<128>(bq, bk, q, k, v, o, B, a, st);
    case 256: return by_blocks<256>(bq, bk, q, k, v, o, B, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
