// COSMO compound horizontal diffusion on a stack of (ny, nx) planes, one
// step (`nero_hdiff`) or k steps in one pass (`nero_hdiff_kstep`); the
// 2-wide ring of every plane passes through on every step.
//
// Replaces the TPU kernels `hdiff_pallas` and `hdiff_kstep_pallas`
// (src/repro/kernels/hdiff/hdiff.py, bodies `_hdiff_kernel` and
// `_hdiff_kstep_kernel`).
//
// Bound: device-memory bytes. A launch reads each point once and writes it
// once, for about 21 fp32 operations a point and step: 0.165 ms in fp32 and
// 0.083 ms in bf16 for the (1024, 260, 260) stack of one whole-state step
// at the H100's 3.35 TB/s.
//
// Design: the TPU kernel keeps x whole and walks y in windows, so each
// input row comes from device memory about once (NERO's line buffers:
// laplace -> flux -> output). Here one routine streams rows the same way,
// for k = 1 and for every k of a round:
// * A block owns one plane, one x-strip of its columns and one y-segment of
//   its rows (`tiling.hdiff_tile`: balanced strips and segments, never a
//   sliver). It walks the segment's rows, and 2k rows above and below it
//   inside the plane, top to bottom, one row a step.
// * Input rows, the strip and 2k columns either side, enter a ring of
//   kRing shared-memory rows kRing - 3 rows ahead of use, by `cp.async`
//   copies, one aligned chunk of kChunk bytes a thread, that complete on
//   an mbarrier a ring row. A row is copied from the chunk that holds its
//   first byte, so one mechanism takes every row stride (bf16 rows of 520
//   bytes are not 16-byte multiples); bytes past the row's end are
//   zero-filled, and columns outside the plane are never copied: they read
//   as zero, or as bytes of the row before. No plane-interior point reads
//   them.
// * A thread owns kCols adjacent columns of the window for the whole walk.
//   Stage s (1..k) keeps their last three input rows and two laplacian rows
//   in registers, and the rows the neighbouring threads need in shared
//   memory: a step computes the laplacian of one row (once a point) and the
//   output of the row above it, in `nero::hdiff_point`'s fp32 operation
//   order, so the bits are those of the one-step kernel. Stage s's output
//   row, rounded through the storage dtype when s < k as a store and load
//   would round it, is stage s+1's newest input row. Stage k's row goes to
//   device memory, coalesced, without the 2k columns either side of the
//   strip, which are not exact. Rows j < 2 and j >= ny-2 and columns i < 2
//   and i >= nx-2 pass through.
// * One __syncthreads a step; every index is fixed per thread or per step,
//   so no thread divides per element. A launch reads (W + 4k) / W of each
//   row (W the strip's width) and (H + 4k) / H rows (H the segment's), and
//   writes each point once, at any k.
//
// What bounds it on the H100 is instructions, not bytes: about 30 fp32
// instructions a point and stage (the 21 operations, the limiter's
// compares and selects), which may not fuse (-fmad=false keeps the plain
// version's rounding), and four shared-memory reads, so bf16 takes as
// long as fp32. Two columns a thread halve the per-thread cost of the
// copies, barriers and waits a step and read the inner neighbours from
// registers; the step loop is unrolled three times, the period of the
// input rows' rotation, so that no register is moved; a warp's idle
// columns cost as much as its used ones, so `tiling.hdiff_strip` picks the
// strips that need the fewest threads (PERF.md has the candidates' times).
//
// The stages are unrolled at compile time: a launch runs 1 to kMaxSteps of
// them, 3, the most whose registers fit the 64 of a 1024-thread block
// without spilling (8 stages spilled 1.4 KB a thread and ran 2.3x slower
// than k one-step launches; PERF.md). The wrapper chains launches for more.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxSteps = 3;
// Input rows the ring holds (tiling.HDIFF_RING): 3 read a step, 5 in
// flight. 6 to 12 rows time alike on the H100 (PERF.md).
constexpr int kRing = 8;

__device__ __forceinline__ float round_trip(float v, float*) { return v; }
__device__ __forceinline__ float round_trip(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The first `bytes` (1 to N) of the N global bytes at `src` into the N
// shared bytes at `dst` (both N-aligned), the rest zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}
// An arrival on `bar` once this thread's earlier cp.async copies are done.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Window columns a thread owns, side by side: its own columns' neighbours
// come from registers, only the two outer ones from shared memory
// (tiling.HDIFF_COLS). Four columns a thread spill at k >= 2.
constexpr int kCols = 2;

// Shared memory of a block of `threads` threads and k stages
// (tiling.hdiff_stream_smem), for w = kCols * threads window columns, in
// rows of 4 * (w + 8) bytes: fp32 rows (column c at c + 4), two laplacian
// rows a stage and four output rows a stage but the last, then the ring's
// rows, then its mbarriers.
size_t stream_smem(int k, int threads) {
  const size_t row = 4 * (static_cast<size_t>(kCols) * threads + 8);
  return row * (2 * k + 4 * (k - 1) + kRing) + 8 * kRing;
}

// A thread's kCols floats at p (8-byte aligned) from v, in one store.
__device__ __forceinline__ void st_cols(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <typename T, int K>
__global__ void __launch_bounds__(1024)
    hdiff_stream(const T* __restrict__ src, T* __restrict__ out, int ny,
                 int nx, int strips, int segs, float coeff) {
  constexpr int C = kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, c0 = C * threadIdx.x;
  int b = blockIdx.x;
  const int sx = b % strips;
  b /= strips;
  const int sy = b % segs;
  const long long plane = b / segs;
  const int x0 = static_cast<int>(static_cast<long long>(sx) * nx / strips);
  const int x1 = static_cast<int>(static_cast<long long>(sx + 1) * nx / strips);
  const int y0 = static_cast<int>(static_cast<long long>(sy) * ny / segs);
  const int y1 = static_cast<int>(static_cast<long long>(sy + 1) * ny / segs);
  const int xa = x0 - 2 * K;  // the window's first column
  const int xlo = max(xa, 0), xhi = min(x1 + 2 * K, nx);
  const int ya = max(y0 - 2 * K, 0), yb = min(y1 + 2 * K, ny);
  const int i0 = xa + c0;  // this thread's first column
  bool col_in[C], col_out[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    col_in[j] = i0 + j >= 2 && i0 + j < nx - 2;
    col_out[j] = c0 + j >= 2 * K && c0 + j < 2 * K + x1 - x0;
  }

  const int w = C * nt;            // window columns the block holds
  const int pitch = 4 * (w + 8);   // a row, bytes
  const int fp = w + 8;            // fp32 row, column c at c + 4
  float* laps = reinterpret_cast<float*>(smem) + 4;
  float* outs = laps + 2 * K * fp;
  unsigned char* ringp = smem + 4 * fp * (2 * K + 4 * (K - 1));
  const uint32_t rings =
      static_cast<uint32_t>(__cvta_generic_to_shared(ringp));
  const uint32_t bars = rings + kRing * pitch;

  for (int q = threadIdx.x; q < kRing * pitch / 4; q += nt)
    reinterpret_cast<uint32_t*>(ringp)[q] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) nero::mbar_init(bars + 8 * s, nt);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The rows stream in order, ya to yb - 1. A row's in-plane bytes [lo,
  // lo + span) are copied in chunks of kChunk bytes, thread q's chunk q,
  // from the chunk that holds lo, to `head` bytes into its ring row
  // (chunk-aligned, past `lead`, the bytes of the window's columns left of
  // the plane), so window column 0 sits at head - lead + lo % kChunk.
  // Every thread arrives on the row's barrier, copy or not.
  constexpr int kChunk = 4 * C;
  const int lead = (xlo - xa) * static_cast<int>(sizeof(T));
  const int head = kChunk + ((lead + kChunk - 1) & -kChunk);
  const int span = (xhi - xlo) * static_cast<int>(sizeof(T));
  const long long stride = static_cast<long long>(nx) * sizeof(T);
  const unsigned char* next = reinterpret_cast<const unsigned char*>(src) +
                              ((plane * ny + ya) * nx + xlo) * sizeof(T);
  auto lo_of = [](const unsigned char* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & (kChunk - 1));
  };
  const int lo0 = lo_of(next);
  const int dlo = static_cast<int>(stride & (kChunk - 1));
  const uint32_t dst0 = rings + head + kChunk * threadIdx.x;
  auto load = [&](int s) {
    const int rel = kChunk * static_cast<int>(threadIdx.x) - lo_of(next);
    if (rel < span)
      cp_async<kChunk>(dst0 + s * pitch, next + rel, min(kChunk, span - rel));
    cp_async_arrive(bars + 8 * s);
    next += stride;
  };
  auto ring_row = [&](int s, int lo) {
    return reinterpret_cast<const T*>(ringp + s * pitch + head - lead + lo);
  };

  const int nrows = yb - ya, ahead = kRing - 3;
  for (int r = 0; r < min(ahead, nrows); ++r) load(r);

  // Stage s's columns: input rows N-1, N-2, N-3 and laplacian rows N-2,
  // N-3, N being its newest input row.
  float v1[K][C], v2[K][C], v3[K][C], l1[K][C], l2[K][C];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int j = 0; j < C; ++j)
      v1[s][j] = v2[s][j] = v3[s][j] = l1[s][j] = l2[s][j] = 0.0f;
  const T* p1 = ring_row(0, lo0);  // ring rows N-1 and N-2 of stage 1
  const T* p2 = p1;
  int slot = 0, lo = lo0;  // ring row and lo % kChunk of the stream's row t
  uint32_t parity = 0;
  // stage k's row y0 comes out at step y0 - ya + 2k, then a row a step
  T* dst = out + (plane * ny + y0) * nx + i0;
  const int first = y0 - ya + 2 * K, steps = y1 - ya + 2 * K;
#pragma unroll 3
  for (int t = 0; t < steps; ++t) {
    // row t + ahead refills the ring row that row t - 3 left
    if (t + ahead < nrows)
      load(slot + ahead < kRing ? slot + ahead : slot + ahead - kRing);
    const T* p0 = ring_row(slot, lo);
    float x[C];
#pragma unroll
    for (int j = 0; j < C; ++j) x[j] = 0.0f;
    if (t < nrows) {
      while (!nero::mbar_try_wait(bars + 8 * slot, parity)) {
      }
#pragma unroll
      for (int j = 0; j < C; ++j) x[j] = nero::ld(p0, c0 + j);
    }
    float* lw = laps + (t & 1) * fp + c0;        // this step's laplacians
    const float* lr = laps + (~t & 1) * fp + c0;  // the last step's
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // stage s: newest input row N, laplacian of row N-1, output of N-2
      const int o = ya + t - 2 * s - 2;
      float am, ap, bm, bp;  // rows N-1 and N-2 left and right of the columns
      if (s == 0) {
        am = nero::ld(p1, c0 - 1);
        ap = nero::ld(p1, c0 + C);
        bm = nero::ld(p2, c0 - 1);
        bp = nero::ld(p2, c0 + C);
      } else {
        const float* q1 = outs + ((s - 1) * 4 + ((t - 1) & 3)) * fp + c0;
        const float* q2 = outs + ((s - 1) * 4 + ((t - 2) & 3)) * fp + c0;
        am = q1[-1];
        ap = q1[C];
        bm = q2[-1];
        bp = q2[C];
      }
      const float lm = lr[2 * s * fp - 1], lp = lr[2 * s * fp + C];
      float lap[C], res[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float left = j == 0 ? am : v1[s][j - 1];
        const float right = j == C - 1 ? ap : v1[s][j + 1];
        lap[j] = (((left + right) + v2[s][j]) + x[j]) - 4.0f * v1[s][j];
      }
      st_cols(lw + 2 * s * fp, lap);
      const bool row_in = o >= 2 && o < ny - 2;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float s0 = v2[s][j], lap_c = l1[s][j];
        float flx = (j == C - 1 ? lp : l1[s][j + 1]) - lap_c;
        float flx_m = lap_c - (j == 0 ? lm : l1[s][j - 1]);
        float fly = lap[j] - lap_c;
        float fly_m = lap_c - l2[s][j];
        if (flx * ((j == C - 1 ? bp : v2[s][j + 1]) - s0) > 0.0f) flx = 0.0f;
        if (flx_m * (s0 - (j == 0 ? bm : v2[s][j - 1])) > 0.0f) flx_m = 0.0f;
        if (fly * (v1[s][j] - s0) > 0.0f) fly = 0.0f;
        if (fly_m * (s0 - v3[s][j]) > 0.0f) fly_m = 0.0f;
        res[j] = s0;
        if (col_in[j] && row_in)
          res[j] = s0 - coeff * ((flx - flx_m) + (fly - fly_m));
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        v3[s][j] = v2[s][j];
        v2[s][j] = v1[s][j];
        v1[s][j] = x[j];
        l2[s][j] = l1[s][j];
        l1[s][j] = lap[j];
      }
      if (s + 1 < K) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          res[j] = round_trip(res[j], static_cast<T*>(nullptr));
          x[j] = res[j];
        }
        st_cols(outs + (s * 4 + (t & 3)) * fp + c0, res);
      } else if (t >= first) {
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (col_out[j]) nero::st(dst, j, res[j]);
        dst += nx;
      }
    }
    __syncthreads();
    p2 = p1;
    p1 = p0;
    lo = (lo + dlo) & (kChunk - 1);
    if (++slot == kRing) {
      slot = 0;
      parity ^= 1u;
    }
  }
}

template <typename T, int K>
int launch(const void* src, void* out, unsigned blocks, int threads,
           size_t smem, cudaStream_t st, int ny, int nx, int strips, int segs,
           float coeff) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hdiff_stream<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hdiff_stream<T, K><<<blocks, threads, smem, st>>>(
      static_cast<const T*>(src), static_cast<T*>(out), ny, nx, strips, segs,
      coeff);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K = 1>
int launch_k(int k, const void* src, void* out, unsigned blocks, int threads,
             size_t smem, cudaStream_t st, int ny, int nx, int strips,
             int segs, float coeff) {
  if constexpr (K < kMaxSteps) {
    if (k > K)
      return launch_k<T, K + 1>(k, src, out, blocks, threads, smem, st, ny,
                                nx, strips, segs, coeff);
  }
  return launch<T, K>(src, out, blocks, threads, smem, st, ny, nx, strips,
                      segs, coeff);
}

// k stages over a stack of `planes` (ny, nx) planes, in strips of at most
// tx columns and segments of at most ty rows, balanced; a block of
// `threads` threads (a multiple of 32, at least the widest strip + 4k).
int run(const void* src, void* out, long long planes, int ny, int nx,
        float coeff, int ty, int tx, int threads, int k, int bf16,
        void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 || k < 1 || k > kMaxSteps || threads < 32 || threads > 1024 ||
      threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (nx + tx - 1) / tx, segs = (ny + ty - 1) / ty;
  if ((nx + strips - 1) / strips + 4 * k + kCols - 1 > kCols * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = planes * strips * segs;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = stream_smem(k, threads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  if (bf16)
    return launch_k<__nv_bfloat16>(k, src, out, nb, threads, smem, st, ny, nx,
                                   strips, segs, coeff);
  return launch_k<float>(k, src, out, nb, threads, smem, st, ny, nx, strips,
                         segs, coeff);
}

}  // namespace

extern "C" int nero_hdiff(const void* src, void* out, long long planes, int ny,
                          int nx, float coeff, int ty, int tx, int threads,
                          int bf16, void* stream) {
  return run(src, out, planes, ny, nx, coeff, ty, tx, threads, 1, bf16,
             stream);
}

extern "C" int nero_hdiff_kstep(const void* src, void* out, long long planes,
                                int ny, int nx, float coeff, int ty, int tx,
                                int threads, int k_steps, int bf16,
                                void* stream) {
  return run(src, out, planes, ny, nx, coeff, ty, tx, threads, k_steps, bf16,
             stream);
}
