// COSMO compound horizontal diffusion on a stack of (ny, nx) planes, one
// step (`nero_hdiff`) or k steps in one pass (`nero_hdiff_kstep`), in one of
// two boundary modes: passthrough, where the 2-wide ring of every plane
// passes through on every step (the TPU kernels' contract, and the mode of
// every padded slab: a mesh shard's, a chain stage's, a k-step round's), or
// periodic (`nero_hdiff` only), where row j outside [0, ny) is row j mod ny
// and column i outside [0, nx) is column i mod nx, and every point is
// computed: the bits of wrap-padding each plane by 2, the passthrough step
// and the interior crop, with no padded copy in device memory.
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
// * Periodic mode: the segment's rows and the 2 rows either side stream
//   unclamped, each copied from its wrapped row, and every point is
//   computed. A window column beyond the plane's edge is the far side of
//   the same row: the chunks that hold those (at most 2) columns come in
//   by `cp.async` on the same row's mbarrier, into a wrap area of kWrap
//   bytes a ring row (the ring's own copy may write the bytes of the row
//   before or after into those columns' ring places), and the thread that
//   owns such a column moves it to its ring place once the row has
//   arrived, before any thread reads it there.
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
// Bytes a ring row keeps for the periodic mode's wrapped columns
// (tiling.HDIFF_WRAP): the two 8-byte chunks that hold the columns left of
// the plane's edge, then the two that hold those right of it.
constexpr int kWrap = 32;

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
// rows, then its mbarriers, then in periodic mode a wrap area a ring row.
size_t stream_smem(int k, int threads, bool periodic) {
  const size_t row = 4 * (static_cast<size_t>(kCols) * threads + 8);
  return row * (2 * k + 4 * (k - 1) + kRing) + 8 * kRing +
         (periodic ? kWrap * kRing : 0);
}

// A thread's kCols floats at p (8-byte aligned) from v, in one store.
__device__ __forceinline__ void st_cols(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <typename T, int K, bool P>
__global__ void __launch_bounds__(1024)
    hdiff_stream(const T* __restrict__ src, T* __restrict__ out, int ny,
                 int nx, int strips, int segs, float coeff) {
  static_assert(!P || K == 1, "the periodic mode runs one stage");
  constexpr int C = kCols;
  constexpr int sz = static_cast<int>(sizeof(T));
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
  // the rows streamed: clamped to the plane, or in periodic mode wrapped
  const int ya = P ? y0 - 2 * K : max(y0 - 2 * K, 0);
  const int yb = P ? y1 + 2 * K : min(y1 + 2 * K, ny);
  const int i0 = xa + c0;  // this thread's first column
  // wrap_l / wrap_r: a periodic window column left / right of the plane
  bool col_in[C], col_out[C], wrap_l[C], wrap_r[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    col_in[j] = P || (i0 + j >= 2 && i0 + j < nx - 2);
    col_out[j] = c0 + j >= 2 * K && c0 + j < 2 * K + x1 - x0;
    wrap_l[j] = P && i0 + j < 0;
    wrap_r[j] = P && i0 + j >= nx && i0 + j < x1 + 2 * K;
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
  const uint32_t wraps = bars + 8 * kRing;  // periodic mode's wrap areas
  const unsigned char* wrapp = ringp + kRing * pitch + 8 * kRing;

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
  // In periodic mode threads 0 and 1 also copy the two chunks from the one
  // that holds the left wrap's first column (column nx + xa), threads 2 and
  // 3 the two from the one that holds column 0 (the right wrap's first), of
  // the wrapped columns' bytes only, to the row's wrap area.
  // Every thread arrives on the row's barrier, copy or not.
  constexpr int kChunk = 4 * C;
  const int lead = (xlo - xa) * sz;
  const int head = kChunk + ((lead + kChunk - 1) & -kChunk);
  const int span = (xhi - xlo) * sz;
  const long long stride = static_cast<long long>(nx) * sizeof(T);
  const unsigned char* pbase =
      reinterpret_cast<const unsigned char*>(src) + plane * ny * stride;
  auto wrapped = [ny](int y) { return y < 0 ? y + ny : y >= ny ? y - ny : y; };
  auto row_at = [&](int y) { return pbase + wrapped(y) * stride; };
  const unsigned char* next = (P ? row_at(ya) : pbase + ya * stride) + xlo * sz;
  auto lo_of = [](const unsigned char* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & (kChunk - 1));
  };
  const int lo0 = lo_of(next);
  const int dlo = static_cast<int>(stride & (kChunk - 1));
  const uint32_t dst0 = rings + head + kChunk * threadIdx.x;
  const bool wrap_left = threadIdx.x < 2;
  // the wrapped columns this thread copies a chunk of, and the first's column
  const int wrap_n = !P || threadIdx.x >= 4 ? 0
                     : wrap_left            ? max(-xa, 0)
                                            : max(x1 + 2 * K - nx, 0);
  const int wrap_col = wrap_left ? nx + xa : 0;
  const uint32_t wrap_dst = wraps + (threadIdx.x & 3) * kChunk;
  int lrow = ya;  // periodic: the stream's next row to load
  auto load = [&](int s) {
    const unsigned char* lrb = nullptr;  // periodic: its start
    if constexpr (P) {
      lrb = row_at(lrow++);
      next = lrb + xlo * sz;
    }
    const int rel = kChunk * static_cast<int>(threadIdx.x) - lo_of(next);
    if (rel < span)
      cp_async<kChunk>(dst0 + s * pitch, next + rel, min(kChunk, span - rel));
    if (P && wrap_n > 0) {
      const unsigned char* from = lrb + wrap_col * sz;
      const unsigned char* a =
          from - lo_of(from) + kChunk * (threadIdx.x & 1);
      const int bytes = static_cast<int>(from + wrap_n * sz - a);
      if (bytes > 0)
        cp_async<kChunk>(wrap_dst + s * kWrap, a, min(kChunk, bytes));
    }
    cp_async_arrive(bars + 8 * s);
    if constexpr (!P) next += stride;
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
    const unsigned char* rb = nullptr;  // periodic: the stream row's start
    if constexpr (P) {
      rb = row_at(ya + t);
      lo = lo_of(rb + xlo * sz);
    }
    const T* p0 = ring_row(slot, lo);
    float x[C];
#pragma unroll
    for (int j = 0; j < C; ++j) x[j] = 0.0f;
    if (t < nrows) {
      while (!nero::mbar_try_wait(bars + 8 * slot, parity)) {
      }
      if constexpr (P) {
        // a wrapped column to its ring place: the neighbours read it there
        // from the next step on, after this step's __syncthreads
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (wrap_l[j] || wrap_r[j]) {
            const unsigned char* from = wrap_l[j] ? rb + (nx + xa) * sz : rb;
            const int col = wrap_l[j] ? c0 + j : i0 + j - nx;
            const_cast<T*>(p0)[c0 + j] = *reinterpret_cast<const T*>(
                wrapp + slot * kWrap + (wrap_l[j] ? 0 : 2 * kChunk) +
                lo_of(from) + col * sz);
          }
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
      const bool row_in = P || (o >= 2 && o < ny - 2);
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
    if constexpr (!P) lo = (lo + dlo) & (kChunk - 1);
    if (++slot == kRing) {
      slot = 0;
      parity ^= 1u;
    }
  }
}

template <typename T, int K, bool P = false>
int launch(const void* src, void* out, unsigned blocks, int threads,
           size_t smem, cudaStream_t st, int ny, int nx, int strips, int segs,
           float coeff) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hdiff_stream<T, K, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hdiff_stream<T, K, P><<<blocks, threads, smem, st>>>(
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
// Periodic mode runs one stage on planes of at least 2 x 2 (a wrap of 2
// reaches at most one period).
int run(const void* src, void* out, long long planes, int ny, int nx,
        float coeff, int ty, int tx, int threads, int k, int periodic,
        int bf16, void* stream) {
  if (planes < 1 || ny < 1 || nx < 1 || ty < 1 || tx < 1 || k < 1 || k > kMaxSteps || threads < 32 || threads > 1024 ||
      threads % 32 || (periodic != 0 && periodic != 1) ||
      (periodic && (k != 1 || ny < 2 || nx < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (nx + tx - 1) / tx, segs = (ny + ty - 1) / ty;
  if ((nx + strips - 1) / strips + 4 * k + kCols - 1 > kCols * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = planes * strips * segs;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = stream_smem(k, threads, periodic);
  auto st = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  if (periodic)
    return bf16 ? launch<__nv_bfloat16, 1, true>(src, out, nb, threads, smem,
                                                 st, ny, nx, strips, segs,
                                                 coeff)
                : launch<float, 1, true>(src, out, nb, threads, smem, st, ny,
                                         nx, strips, segs, coeff);
  if (bf16)
    return launch_k<__nv_bfloat16>(k, src, out, nb, threads, smem, st, ny, nx,
                                   strips, segs, coeff);
  return launch_k<float>(k, src, out, nb, threads, smem, st, ny, nx, strips,
                         segs, coeff);
}

}  // namespace

// One step; periodic 0 passes the 2-wide ring through, 1 wraps it.
extern "C" int nero_hdiff(const void* src, void* out, long long planes, int ny,
                          int nx, float coeff, int ty, int tx, int threads,
                          int periodic, int bf16, void* stream) {
  return run(src, out, planes, ny, nx, coeff, ty, tx, threads, 1, periodic,
             bf16, stream);
}

extern "C" int nero_hdiff_kstep(const void* src, void* out, long long planes,
                                int ny, int nx, float coeff, int ty, int tx,
                                int threads, int k_steps, int bf16,
                                void* stream) {
  return run(src, out, planes, ny, nx, coeff, ty, tx, threads, k_steps, 0,
             bf16, stream);
}
