// COSMO vertical advection: a Thomas tridiagonal solve along z per column.
//
// Replaces the TPU kernel `vadvc_pallas` (src/repro/kernels/vadvc/vadvc.py,
// body `_vadvc_kernel`), in its operation order.
//
// Bound: device-memory bytes. A column reads three fields (u_pos is u_stage
// in every caller) and its wcon and writes one, about 38 fp32 operations
// per point: 0.341 ms in fp32 and 0.170 ms in bf16 for the (4, 4, 64, 256,
// 256) field-stacked state at the H100's 3.35 TB/s.
//
// Design: the TPU kernel stages whole z-columns of a window in VMEM and keeps
// the forward sweep's (c, d) in a VMEM scratch, never in HBM. Here a block is
// one warp, and it owns a segment of up to `cols` (at most 32) adjacent
// columns of one row of one field, one column a lane, for the whole column:
// * The inputs of the levels ahead stream into a ring of kRing levels in the
//   warp's shared memory: each lane copies the 4-byte word that holds its
//   element of each stream by `cp.async`, coalesced across the warp (two
//   bf16 lanes share a word), one copy group a level (warp_ring.cuh). The
//   warp reads kChunk levels at a time, refills their slots, then runs
//   their forward steps from registers. The ring is short because the
//   column store below sets the warps an SM holds (8 in fp32 and 10 in
//   bf16 at nz = 64): on the H100 deeper rings, 16-byte chunk copies, loads
//   waiting in registers, blocks of several warps and other segment orders
//   all timed level or slower, and bf16 runs as fast as fp32 (PERF.md).
// * The forward sweep writes each level's (c, d) and the level's u_pos to
//   the warp's shared memory (nz * cols * (8 + sizeof(T)) bytes), and back
//   substitution reads them in reverse: nothing of the sweep goes to device
//   memory, and u_pos is read from it once (not at all when it is u_stage:
//   the ring's u_stage is read for it). A tall column takes fewer columns a
//   warp (`tiling.vadvc_tile`), one build for every nz >= 2.
// * wcon is staggered, (..., nz, ny, nx + 1), or periodic, (..., nz, ny, nx),
//   where column nx is column 0: the wrapper passes its row width, and lane
//   0 copies the word of the wcon element right of the segment (column 0
//   at a periodic row's end) beside the segment. Each staggered value is
//   widened to fp32 before the sum, as the TPU kernel does with its wl / wr
//   slices.
// * Each run of `group` consecutive fields shares one wcon (the fields of
//   one ensemble member). Warps take segments field fastest, so the warps
//   that read one wcon segment run together and wcon comes from device
//   memory about once. Warps are persistent (as many as fit the card), and
//   a warp copies its next segment's first levels while it substitutes back.
#include "common.cuh"
#include "warp_ring.cuh"

namespace {

// Levels the ring holds (tiling.VADVC_RING), read and computed kChunk at a
// time: kRing - kChunk levels are in flight while a chunk computes.
constexpr int kRing = 4;
constexpr int kChunk = 2;
// A ring slot holds a level: a region for each of u_stage, u_pos, utens,
// utens_stage and wcon, the 4-byte words that hold a segment of 32 elements
// (kRegion bytes), then the word of the wcon element right of the segment
// (column 0 of a periodic row), rounded to 16 bytes.
constexpr int kStreams = 5;
__host__ __device__ constexpr int region_bytes(int sz) { return 32 * sz + 4; }
__host__ __device__ constexpr int slot_bytes(int sz) {
  return (kStreams * region_bytes(sz) + 4 + 15) / 16 * 16;
}

// Shared bytes of a warp of `cols` columns at nz levels (tiling.vadvc_smem):
// the ring, then c and d in fp32 and u_pos in T, [level][column] each.
size_t warp_smem(int nz, int cols, int sz) {
  return kRing * slot_bytes(sz) + static_cast<size_t>(nz) * cols * (8 + sz);
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 4 global bytes at `src` (4-byte aligned) into the 4 shared bytes at
// `dst`, through L1.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// The 4-byte aligned word that holds the element at p.
__device__ __forceinline__ const unsigned char* word_of(const void* p) {
  return reinterpret_cast<const unsigned char*>(
      reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(3));
}
__device__ __forceinline__ uint32_t low_bits(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}

template <typename T>
__global__ void __launch_bounds__(32)
    vadvc_stream(const T* __restrict__ ustage, const T* __restrict__ wcon,
                 const T* __restrict__ upos, const T* __restrict__ utens,
                 const T* __restrict__ ustagetens, T* __restrict__ out,
                 long long segments, int group, int nz, int ny, int nx,
                 int wcon_w, int segs, int cols) {
  using nero::kBetM;
  using nero::kBetP;
  using nero::kDtrStage;
  constexpr int sz = sizeof(T);
  constexpr int kRegion = region_bytes(sz), kSlot = slot_bytes(sz);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const uint32_t ring = nero::smem_addr(smem);
  float* ccol = reinterpret_cast<float*>(smem + kRing * kSlot);
  float* dcol = ccol + nz * cols;
  T* ucol = reinterpret_cast<T*>(dcol + nz * cols);
  const bool alias = upos == ustage;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long wplane = static_cast<long long>(ny) * wcon_w;
  const long long fstep = plane * sz, wstep = wplane * sz;  // bytes a level

  // The segment, set by `begin`: its columns, out's level 0 element of lane
  // 0, and the lane's element of each stream at level 0 (the wcon element
  // right of the segment in the last). A stream's words go to its region
  // from the word that holds lane 0's element, so lane l's element sits at
  // byte (lane 0's address) % 4 + l * sizeof(T) of the region; two lanes
  // of a bf16 word copy the same bytes to the same place.
  int n = 0;
  long long obase = 0;
  const unsigned char* elem[kStreams + 1];
  auto begin = [&](long long s) {
    long long b = s;
    const int g = static_cast<int>(b % group);
    b /= group;
    const int sx = static_cast<int>(b % segs);
    b /= segs;
    const int j = static_cast<int>(b % ny);
    const long long member = b / ny;
    const int x0 = static_cast<int>(static_cast<long long>(sx) * nx / segs);
    n = static_cast<int>(static_cast<long long>(sx + 1) * nx / segs) - x0;
    obase = (member * group + g) * nz * plane +
            static_cast<long long>(j) * nx + x0;
    const int lc = lane < n ? lane : 0;
    elem[0] = reinterpret_cast<const unsigned char*>(ustage + obase + lc);
    elem[1] = reinterpret_cast<const unsigned char*>(upos + obase + lc);
    elem[2] = reinterpret_cast<const unsigned char*>(utens + obase + lc);
    elem[3] = reinterpret_cast<const unsigned char*>(ustagetens + obase + lc);
    const long long w0 =
        member * nz * wplane + static_cast<long long>(j) * wcon_w;
    const bool wrap = x0 + n + 1 > wcon_w;  // right of the row: column 0
    elem[4] = reinterpret_cast<const unsigned char*>(wcon + w0 + x0 + lc);
    elem[5] = reinterpret_cast<const unsigned char*>(
        wcon + w0 + (wrap ? 0 : x0 + n));
  };
  // each stream's source at the next level `issue` copies
  const unsigned char* nxt[kStreams + 1];
  // lane 0's element's address modulo 4 at level 0, a stream (a bf16
  // stream's moves by fstep or wstep a level; an fp32 stream's is 0)
  uint32_t lo0[kStreams + 1];
  // stream r's lane 0 offset in its region at the level whose byte offsets
  // from level 0 are kf (fields) and kw (wcon), low 32 bits
  auto lo_at = [&](int r, uint32_t kf, uint32_t kw) {
    return sz == 4 ? 0u : (lo0[r] + (r >= 4 ? kw : kf)) & 3u;
  };
  auto offsets = [&](int k, uint32_t& kf, uint32_t& kw) {
    kf = static_cast<uint32_t>(k) * static_cast<uint32_t>(fstep);
    kw = static_cast<uint32_t>(k) * static_cast<uint32_t>(wstep);
  };
  // The copies of level k into its ring slot (each live lane its words,
  // lane 0 the extra one), then one commit; `k` counts up from 0 in a
  // segment, so each stream's source advances a level a call.
  auto issue = [&](int k) {
    if (k < nz) {
      const uint32_t slot = ring + (k & (kRing - 1)) * kSlot;
      uint32_t kf, kw;
      offsets(k, kf, kw);
      if (lane < n) {
#pragma unroll
        for (int r = 0; r < kStreams; ++r) {
          if (r == 1 && alias) continue;
          const uint32_t at = (lo_at(r, kf, kw) + lane * sz) & ~3u;
          cp_async4(slot + r * kRegion + at,
                    sz == 4 ? nxt[r] : word_of(nxt[r]));
        }
      }
      if (lane == 0)
        cp_async4(slot + kStreams * kRegion, word_of(nxt[kStreams]));
    }
#pragma unroll
    for (int r = 0; r < kStreams + 1; ++r)
      nxt[r] += r >= 4 ? wstep : fstep;
    nero::cp_async_commit();
  };
  auto start = [&](long long s) {
    begin(s);
#pragma unroll
    for (int r = 0; r < kStreams + 1; ++r) nxt[r] = elem[r];
#pragma unroll
    for (int r = 0; r < kStreams + 1; ++r)
      lo0[r] = (low_bits(elem[r]) -
                (r < kStreams && lane < n ? lane * sz : 0)) & 3u;
    for (int k = 0; k < kRing; ++k) issue(k);
  };

  long long s = blockIdx.x;
  if (s >= segments) return;
  start(s);
  while (true) {
    const bool live = lane < n;
    const int lc = live ? lane : 0;

    // The sweep's running values: the parent kernel's w1, u0, u1, rhs(k),
    // cprev and dprev.
    float w1 = 0.0f, u0 = 0.0f, u1 = 0.0f, rhs_k = 0.0f, cprev = 0.0f,
          dprev = 0.0f;
    // Forward step k, 0 < k < nz-1, from level k + 1's staggered sum,
    // u_stage and right-hand side.
    auto mid = [&](int k, float ws_n, float us_n, float rhs_n) {
      const float wk = w1;
      w1 = ws_n;
      const float gav = -0.25f * wk;
      const float gcv = 0.25f * w1;
      const float as = gav * kBetM;
      const float cs_ = gcv * kBetM;
      const float acol = gav * kBetP;
      const float cc = gcv * kBetP;
      const float bcol = (kDtrStage - acol) - cc;
      const float um = u0;
      u0 = u1;
      u1 = us_n;
      const float corr = -as * (um - u0) - cs_ * (u1 - u0);
      const float dk = rhs_k + corr;
      const float divided = 1.0f / (bcol - cprev * acol);
      cprev = cc * divided;
      dprev = (dk - dprev * acol) * divided;
      if (live) {
        ccol[k * cols + lane] = cprev;
        dcol[k * cols + lane] = dprev;
      }
      rhs_k = rhs_n;
    };

    // ---- forward sweep, kChunk levels a step ----
    int slot = 0;  // ring slot of the chunk's first level
    for (int c0 = 0; c0 < nz; c0 += kChunk) {
      nero::cp_async_wait<kRing - kChunk>();
      __syncwarp();
      // level c0 + i of this lane's column: u_stage, the right-hand side
      // and the staggered sum; u_pos is kept for back substitution
      float us[kChunk], rh[kChunk], ws[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int t = c0 + i;
        us[i] = rh[i] = ws[i] = 0.0f;
        if (t >= nz) continue;
        const unsigned char* sb = smem + (slot + i) * kSlot;
        uint32_t kf, kw;
        offsets(t, kf, kw);
        // element e of stream r (e = lane, lane + 1, or 0 of the extra)
        auto el = [&](int r, int e) {
          return *reinterpret_cast<const T*>(
              sb + r * kRegion + lo_at(r, kf, kw) + e * sz);
        };
        const T u = el(0, lc);
        const T up = alias ? u : el(1, lc);
        us[i] = f32(u);
        rh[i] = (kDtrStage * f32(up) + f32(el(2, lc))) + f32(el(3, lc));
        const float wr =
            lc == n - 1 ? f32(el(kStreams, 0)) : f32(el(4, lc + 1));
        ws[i] = f32(el(4, lc)) + wr;
        if (live) ucol[t * cols + lane] = up;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kChunk; ++i) issue(c0 + i + kRing);
      slot = slot + kChunk == kRing ? 0 : slot + kChunk;

      if (c0 > 0 && c0 + kChunk <= nz) {  // every level a middle step
#pragma unroll
        for (int i = 0; i < kChunk; ++i) mid(c0 + i - 1, ws[i], us[i], rh[i]);
        continue;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int t = c0 + i;
        if (t >= nz) break;
        if (t == 0) {
          u1 = us[i];
          rhs_k = rh[i];
        } else if (t == 1) {
          // ---- forward sweep, k = 0 ----
          w1 = ws[i];
          const float gcv = 0.25f * w1;
          const float cs_ = gcv * kBetM;
          const float cc = gcv * kBetP;
          u0 = u1;
          u1 = us[i];
          const float corr = -cs_ * (u1 - u0);
          const float divided = 1.0f / (kDtrStage - cc);
          cprev = cc * divided;
          dprev = (rhs_k + corr) * divided;
          if (live) {
            ccol[lane] = cprev;
            dcol[lane] = dprev;
          }
          rhs_k = rh[i];
        } else {
          mid(t - 1, ws[i], us[i], rh[i]);
        }
      }
    }

    // ---- forward sweep, k = nz-1 ----
    const int kl = nz - 1;
    const float gav = -0.25f * w1;
    const float as = gav * kBetM;
    const float acol = gav * kBetP;
    const float corr = -as * (u0 - u1);
    const float divided = 1.0f / ((kDtrStage - acol) - cprev * acol);
    float datac = ((rhs_k + corr) - dprev * acol) * divided;

    // the next segment's first levels stream in during back substitution
    T* o = out + obase + lane;
    s += gridDim.x;
    const bool more = s < segments;
    if (more) start(s);

    // ---- backward substitution ----
    if (live) {
      nero::st(o, kl * plane,
               kDtrStage * (datac - f32(ucol[kl * cols + lane])));
#pragma unroll 4
      for (int k = nz - 2; k >= 0; --k) {
        datac = dcol[k * cols + lane] - ccol[k * cols + lane] * datac;
        nero::st(o, k * plane,
                 kDtrStage * (datac - f32(ucol[k * cols + lane])));
      }
    }
    if (!more) break;
  }
}

template <typename T>
int launch(const void* ustage, const void* wcon, const void* upos,
           const void* utens, const void* ustagetens, void* out,
           long long segments, int group, int nz, int ny, int nx, int wcon_w,
           int segs, int cols, cudaStream_t st) {
  const size_t smem = warp_smem(nz, cols, sizeof(T));
  static int sms = 0;
  cudaError_t e = cudaSuccess;
  if (!sms) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(vadvc_stream<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vadvc_stream<T>,
                                                    32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const auto blocks = static_cast<unsigned>(segments < resident ? segments
                                                                : resident);
  vadvc_stream<T><<<blocks, 32, smem, st>>>(
      static_cast<const T*>(ustage), static_cast<const T*>(wcon),
      static_cast<const T*>(upos), static_cast<const T*>(utens),
      static_cast<const T*>(ustagetens), static_cast<T*>(out), segments, group,
      nz, ny, nx, wcon_w, segs, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A batch of `batch` (nz, ny, nx) fields, each run of `group` sharing one
// wcon of rows `wcon_w` wide (nx + 1 staggered, nx periodic); rows split in
// segments of at most `cols` columns (1 to 32), balanced.
extern "C" int nero_vadvc(const void* ustage, const void* wcon,
                          const void* upos, const void* utens,
                          const void* ustagetens, void* out, long long batch,
                          int group, int nz, int ny, int nx, int wcon_w,
                          int cols, int bf16, void* stream) {
  if (batch < 1 || group < 1 || batch % group || nz < 2 || ny < 1 || nx < 1 ||
      (wcon_w != nx && wcon_w != nx + 1) || cols < 1 || cols > 32 ||
      warp_smem(nz, cols, bf16 ? 2 : 4) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int segs = (nx + cols - 1) / cols;
  const long long segments = batch * ny * segs;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(ustage, wcon, upos, utens, ustagetens, out,
                                 segments, group, nz, ny, nx, wcon_w, segs,
                                 cols, st);
  return launch<float>(ustage, wcon, upos, utens, ustagetens, out, segments,
                       group, nz, ny, nx, wcon_w, segs, cols, st);
}
