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
// Design: the round's state stays on chip, as the TPU kernel keeps it in
// VMEM; in device memory the kernel reads its four inputs and writes its two
// outputs, and keeps no scratch or working state there apart from what
// ptxas spills (24-32 bytes a thread on sm_90a; the build prints it).
//
// * A thread block cluster owns one (member, ty x tx tile) with its 2k-deep
//   periodic halo, (ty+4k) x (tx+4k) columns, and walks the fields. Its
//   blocks split the haloed rows, `rows` each (the last block's rows may run
//   past the halo: they compute values no output reads); one thread per
//   column, one block per SM. The cluster lets a tile outgrow one SM, so
//   the halo costs less redundant work than one block's tile would.
// * Each thread keeps its column's field and stage (the Thomas D in
//   between), nz fp32 values each, in registers: arrays of kNz = 64 levels,
//   of which a column of nz < 64 uses the first nz (the launcher refuses
//   nz > 64). Register arrays need constant indices, yet a fully
//   unrolled 64-level step is too much code: so the level loops run over
//   chunks of kChunk levels, the chunk at hand always at the same positions
//   of the arrays, which are rotated by a chunk after each one. Register
//   pressure decides the speed: with utens in registers too, or with
//   per-level offsets that depend on a runtime stride (which the compiler
//   hoists, 64 of them, out of the loops), ptxas spills, and shared memory
//   leaves too little L1 to catch the spills. So utens waits in shared
//   memory, in a per-column record beside w's coefficients where every
//   level sits at a constant offset, and global addresses walk down the
//   column (`next_level`).
// * The Thomas arithmetic is the column routine of dycore_column.cuh, which
//   the whole-state kernel (dycore_fused.cu) calls too: w's coefficients
//   as_k (= acol_k) and divided_k are computed once per column at the start
//   (`nero::w_record`) and kept in that record for every field and step,
//   and each step runs `nero::forward_chunk` and `nero::backward_chunk` on
//   the column's registers. So in fp32 every step is bit-equal to a
//   whole-state launch, and k steps to k launches.
// * The backward sweep runs in chunks of kChunk levels. Each thread writes
//   the updated field f + dt * stage of its column at each level of a chunk
//   into a plane buffer of its block, and the rows within 2 of a neighbour
//   block's into that block's buffer too (distributed shared memory); one
//   cluster barrier later, hdiff reads only its own block's buffer. Three
//   buffers rotate, so the barrier is split: a block arrives after writing a
//   chunk, sweeps the next chunk, and only then waits and applies hdiff to
//   the first.
// * Step s leaves only the columns at least 2s from the cluster's tile edge
//   exact: hdiff reaches 2 columns (`_window_step`'s docstring). So step s
//   solves only where that distance is at least 2s and diffuses only where
//   it is at least 2s + 2; the rest hold garbage that never reaches the
//   centre. A block's threads take the interior columns of its rows first
//   and the halo columns after, so these skips fall on whole warps. After k
//   steps the ty x tx centre is exact and is written out; bf16 is rounded
//   once, there.
//
// Measured (`chip_smoke.py --kernel-times`, one NVIDIA H100 80GB HBM3 at a
// 700 W power limit; PERF.md): the main path's (4, 4, 64, 256, 256) fp32
// state, a k=2 round 4.612-4.669 ms queued and k=3 8.639-8.643 ms, against
// a 0.421 ms bound; still slower than k whole-state launches.
#include <climits>

#include "dycore_column.cuh"

namespace {

constexpr int kThreads = 256;   // a block's most threads: 2·64 registers each
constexpr int kNz = 64;         // levels of a column's register arrays
constexpr int kChunk = 8;       // levels of the hdiff planes per exchange
constexpr int kBufs = 3;        // plane buffers in rotation
constexpr int kMaxCluster = 8;  // the portable cluster size

constexpr int kRec = 3;         // record floats a level: as, divided, utens

// Floats of one column's record of w's coefficients and utens: kRec a
// level, made odd.
__host__ __device__ __forceinline__ int record_stride(int nz) {
  return (kRec * nz) | 1;
}

using nero::cluster_arrive;
using nero::cluster_wait;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// The shared-memory address in block `rank` of the cluster that holds what
// `addr` holds in this block.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// A store into another block's shared memory. No memory clobber: this block
// reads none of what it writes there, and the cluster barrier (which has
// one) orders it for the block that does.
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v));
}

// Walks a pointer down the levels of a column. The step goes through an
// empty asm, so the compiler cannot fold the walk into base + k * plane and
// keep 64 such offsets live in registers across the loops.
template <typename P>
__device__ __forceinline__ void next_level(P*& p, int64_t plane) {
  p += plane;
  asm volatile("" : "+l"(p));
}

// a[i] = a[(i + by) % NZ]: the register array rotated by `by` positions
// (register moves; nothing when the rotation is whole).
template <int NZ, int by>
__device__ __forceinline__ void rotate(float (&a)[NZ]) {
  if constexpr (by % NZ != 0) {
    float b[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) b[i] = a[(i + by) % NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) a[i] = b[i];
  }
}

template <typename T, int NZ>
__global__ void __launch_bounds__(kThreads, 1) dycore_kstep_kernel(
    const T* __restrict__ fs, const T* __restrict__ w,
    const T* __restrict__ utens, const T* __restrict__ ustage,
    T* __restrict__ fout, T* __restrict__ sout, int nf, int nz, int ny,
    int nx, int ty, int tx, int rows, int k_steps, int tiles_y, int tiles_x,
    float dt, float coeff) {
  using nero::kDtrStage;
  constexpr int NC = NZ / kChunk;
  static_assert(NZ % kChunk == 0, "NZ must be a multiple of kChunk");

  extern __shared__ float smem[];
  const int nt = blockDim.x;  // == rows * tw
  const int hl = 2 * k_steps;  // the round's halo
  const int tw = tx + 2 * hl, th = ty + 2 * hl;
  const int pw = (rows + 4) * tw;  // one level of a plane buffer
  const int c = threadIdx.x;
  // This column's record: (as_k, divided_k, utens_k) at 3k, 3k+1, 3k+2, so
  // every level's offset is a constant; an odd stride keeps the threads'
  // records in distinct banks.
  float* rec = smem + c * record_stride(nz);
  float* P = smem + nt * record_stride(nz);  // (kBufs, kChunk, rows+4, tw)

  const unsigned rank = cluster_rank(), ncl = cluster_size();
  int64_t b = blockIdx.x / ncl;
  const int i0 = static_cast<int>(b % tiles_x) * tx;
  b /= tiles_x;
  const int j0 = static_cast<int>(b % tiles_y) * ty;
  const int64_t member = b / tiles_y;

  // The block's column: the tx interior columns of each of its rows come
  // first (a warp a row when tx is 32), then the 2·hl halo columns of each
  // row, so the work that the validity front skips is skipped by whole warps.
  int rl, q;
  if (c < rows * tx) {
    rl = c / tx;
    q = hl + c % tx;
  } else {
    const int e = c - rows * tx;
    rl = e / (2 * hl);
    q = e % (2 * hl) < hl ? e % (2 * hl) : tx + e % (2 * hl);
  }
  const int r = static_cast<int>(rank) * rows + rl;  // row in the haloed tile
  const int jr = j0 - hl + r, ir = i0 - hl + q;      // unwrapped position
  const int j = ((jr % ny) + ny) % ny, i = ((ir % nx) + nx) % nx;
  // Distance from the haloed tile's edge (negative past its last row). Step
  // s needs the Thomas solve where it is at least 2s and hdiff where it is
  // at least 2s + 2; the centre is where it is at least 2k.
  const int dist = min(min(r, th - 1 - r), min(q, tw - 1 - q));
  const bool centre = dist >= hl && jr < ny && ir < nx;

  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t vol = plane * nz;
  const int64_t col = static_cast<int64_t>(j) * nx + i;
  const int kl = nz - 1;

  // ---- w's Thomas coefficients, once for every field and step ----
  nero::w_record<NZ, kRec>(rec, w + member * vol + col, plane, nz);

  // Where this thread's plane value goes: its own buffer, and the ghost rows
  // of the block above or below when it sits within 2 rows of it.
  const int own = (rl + 2) * tw + q;
  const uint32_t pbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(P));
  const bool to_up = rl < 2 && rank > 0;
  const bool to_down = rl >= rows - 2 && rank + 1 < ncl;
  const uint32_t up =
      to_up ? map_rank(pbase, rank - 1) + 4u * ((rows + 2 + rl) * tw + q)
            : 0u;
  const uint32_t down =
      to_down ? map_rank(pbase, rank + 1) + 4u * ((rl - rows + 2) * tw + q)
              : 0u;

  // Every block of the cluster has started (its shared memory exists) and
  // finished its own setup before any block writes into another.
  cluster_arrive();
  cluster_wait();

  float F[NZ], SD[NZ];
  int buf = 0;  // the plane buffer of the step's first chunk
  for (int field = 0; field < nf; ++field) {
    const int64_t fcol = (member * nf + field) * vol + col;
    {
      // f and the stage straight into registers, every load in flight;
      // utens through registers into the record kChunk levels at a time,
      // so a store waits for one batch of loads, not for each load.
      const T* pf = fs + fcol;
      const T* ps = ustage + fcol;
      const T* pu = utens + fcol;
#pragma unroll
      for (int k = 0; k < NZ; ++k) {
        if (k < nz) {
          F[k] = nero::ld(pf, 0);
          SD[k] = nero::ld(ps, 0);
          next_level(pf, plane);
          next_level(ps, plane);
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < NZ; k0 += kChunk) {
        float u[kChunk];
#pragma unroll
        for (int li = 0; li < kChunk; ++li) {
          if (k0 + li < nz) {
            u[li] = nero::ld(pu, 0);
            next_level(pu, plane);
          }
        }
#pragma unroll
        for (int li = 0; li < kChunk; ++li)
          if (k0 + li < nz) rec[kRec * (k0 + li) + 2] = u[li];
      }
    }
    for (int s = 0; s < k_steps; ++s) {
      const bool solve = dist >= 2 * s, diffuse = dist >= 2 * s + 2;
      // ---- forward sweep: D_k into SD[k] once the old stage is read ----
      // Chunk t (levels kChunk*t ...) sits at positions 0..kChunk-1 of the
      // arrays; rotating them after each chunk brings the next one there
      // and, after all NC chunks, the arrays back into level order.
      float x = 0.0f, dprev = 0.0f;
#pragma unroll 1
      for (int t = 0; t < NC; ++t) {
        const float* rc = rec + kRec * kChunk * t;  // the record at level 8t
        if (solve)
          nero::forward_chunk<kChunk, kRec>(
              kChunk * t, kl, rc,
              [&](int r) -> float& { return F[(r + NZ) % NZ]; },
              [&](int r) -> float& { return SD[r]; },
              [&](int r, float f0) {
                return (kDtrStage * f0 + rc[kRec * r + 2]) + SD[r];
              },
              dprev, x);
        rotate<NZ, kChunk>(F);
        rotate<NZ, kChunk>(SD);
      }

      // ---- backward sweep + update + hdiff, kChunk levels at a time ----
      // Chunk t holds levels NZ-1-t*kChunk down to NZ-(t+1)*kChunk. Pass t
      // sweeps chunk t into its planes and arrives; then waits for every
      // block's planes of chunk t-1 and applies hdiff to them. The stage
      // replaces D in SD, the new field the old one in F. Chunk t sits at
      // positions NZ-kChunk..NZ-1; a rotation the other way after each pass
      // moves it to 0..kChunk-1, where pass t+1 diffuses it.
#pragma unroll 1
      for (int t = 0; t <= NC; ++t) {
        if (t < NC) {
          const int bi = (buf + t) % kBufs;
          float* pb = P + bi * kChunk * pw + own;
          const uint32_t off = 4u * (bi * kChunk * pw);
          const float* rc = rec + kRec * (NZ - 1 - kChunk * t);
          if (solve)
            nero::backward_chunk<kChunk>(
                NZ - 1 - kChunk * t, kl,
                [&](int r) { return nero::c_coef<kRec>(rc - kRec * r); },
                [&](int r) -> float& { return F[NZ - 1 - r]; },
                [&](int r) -> float& { return SD[NZ - 1 - r]; }, dt, x,
                [&](int r, int, float v, float stage) {
                  SD[NZ - 1 - r] = stage;
                  pb[r * pw] = v;
                  if (to_up) st_cluster(up + off + 4u * (r * pw), v);
                  if (to_down) st_cluster(down + off + 4u * (r * pw), v);
                });
        }
        if (t > 0) {
          cluster_wait();
          const int bi = (buf + t - 1) % kBufs;
          const float* pb = P + bi * kChunk * pw;
#pragma unroll
          for (int li = 0; li < kChunk; ++li) {
            const int k = NZ - 1 - (t - 1) * kChunk - li;
            const int at = kChunk - 1 - li;
            if (diffuse && k <= kl)
              F[at] = nero::hdiff_point(pb + li * pw, own, tw, coeff);
          }
        }
        if (t < NC) {
          cluster_arrive();
          rotate<NZ, NZ - kChunk>(F);
          rotate<NZ, NZ - kChunk>(SD);
        }
      }
      buf = (buf + NC) % kBufs;
    }
    // ---- the centre's state after k steps, rounded once ----
    if (centre) {
      T* pf = fout + fcol;
      T* ps = sout + fcol;
#pragma unroll
      for (int k = 0; k < NZ; ++k) {
        if (k < nz) {
          nero::st(pf, 0, F[k]);
          nero::st(ps, 0, SD[k]);
          next_level(pf, plane);
          next_level(ps, plane);
        }
      }
    }
  }
}

// Shared memory of one block: each column's record and the plane buffers.
size_t smem_bytes(int nz, int nt, int rows, int tw) {
  return sizeof(float) *
         (static_cast<size_t>(record_stride(nz)) * nt +
          static_cast<size_t>(kBufs) * kChunk * (rows + 4) * tw);
}

template <typename T>
int launch(const void* fs, const void* w, const void* utens,
           const void* ustage, void* fout, void* sout, unsigned blocks,
           int threads, int cluster, size_t smem, cudaStream_t s, int nf,
           int nz, int ny, int nx, int ty, int tx, int rows, int k_steps,
           int tiles_y, int tiles_x, float dt, float coeff) {
  auto kern = dycore_kstep_kernel<T, kNz>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(fs), static_cast<const T*>(w),
      static_cast<const T*>(utens), static_cast<const T*>(ustage),
      static_cast<T*>(fout), static_cast<T*>(sout), nf, nz, ny, nx, ty, tx,
      rows, k_steps, tiles_y, tiles_x, dt, coeff);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nero_dycore_kstep(const void* fs, const void* w,
                                 const void* utens, const void* ustage,
                                 void* fout, void* sout, long long batch,
                                 int nf, int nz, int ny, int nx, float dt,
                                 float coeff, int ty, int tx, int rows,
                                 int cluster, int k_steps, int bf16,
                                 void* stream) {
  if (batch < 1 || nf < 1 || nz < 2 || nz > kNz || ny < 1 || nx < 1 ||
      ty < 1 || tx < 1 || rows < 2 || k_steps < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tw = tx + 4 * k_steps;
  const long long threads = static_cast<long long>(rows) * tw;
  if (threads > kThreads ||
      static_cast<long long>(cluster) * rows < ty + 4 * k_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_y = (ny + ty - 1) / ty, tiles_x = (nx + tx - 1) / tx;
  const long long blocks = batch * tiles_y * tiles_x * cluster;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(nz, static_cast<int>(threads), rows, tw);
  auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const int nt = static_cast<int>(threads);
  const int ty_ = static_cast<int>(tiles_y), tx_ = static_cast<int>(tiles_x);
  if (bf16)
    return launch<__nv_bfloat16>(fs, w, utens, ustage, fout, sout, nb, nt,
                                 cluster, smem, s, nf, nz, ny, nx, ty, tx,
                                 rows, k_steps, ty_, tx_, dt, coeff);
  return launch<float>(fs, w, utens, ustage, fout, sout, nb, nt, cluster,
                       smem, s, nf, nz, ny, nx, ty, tx, rows, k_steps, ty_,
                       tx_, dt, coeff);
}
