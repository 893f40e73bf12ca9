// The column routine of one fused dycore step, shared by the whole-state
// kernel (dycore_fused.cu) and the k-step kernel (dycore_kstep.cu): w's
// Thomas coefficients a level at a time (`w_level`) or as a per-column
// record (`w_record`), the forward sweep over a chunk of levels and the
// backward sweep over a chunk. Both kernels call these and nothing else for
// the Thomas arithmetic, so they agree bit for bit in fp32. Operation order
// follows `_window_step` in the JAX package's
// src/repro/kernels/dycore_fused/fused.py (vadvc's Thomas solve with u_pos
// == u_stage == f).
//
// A column's values live where its kernel keeps them (the k-step kernel:
// register arrays with constant indices; the whole-state kernel: a few
// registers a level, and the backward sweep's coefficient and D in a
// device-memory scratch); the chunk routines reach them through accessors,
// `f(r)` and `sd(r)`, which return a reference to the value r levels past
// (forward) or below (backward) the chunk's first level, so the same code
// serves every storage. `rc` points at the chunk's first level in the
// column's record: (as_k, divided_k) at R*k and R*k + 1, R >= 2 floats a
// level (the k-step kernel keeps utens at R*k + 2). as_k (= acol_k) and
// divided_k depend on w alone; cs_k = ck_k = -as_{k+1} and cprev_k =
// -as_{k+1} * divided_k follow exactly (kBetM == kBetP, and a product's
// rounding is symmetric in sign), so the record holds two floats a level.
// The backward sweep takes cprev_k through an accessor too (`c_coef`
// computes it from the record), so a kernel that keeps no record (the
// whole-state kernel) can store it in its forward sweep.
#pragma once

#include "common.cuh"

namespace nero {

static_assert(kBetM == kBetP, "as == acol and cs == ck only when BETA_V == 0");

// Level k of the record for 0 < k < kl (w_level's middle, without its
// branches, for a kernel that walks the middle levels in a loop of its own).
__device__ __forceinline__ void w_level_mid(float wk, float wk1, float& cprev,
                                            float* rk) {
  const float gav = -0.25f * wk;
  const float as = gav * kBetM;
  const float acol = gav * kBetP;
  rk[0] = as;
  const float gcv = 0.25f * wk1;
  const float ck = gcv * kBetP;
  const float bcol = (kDtrStage - acol) - ck;
  const float divided = 1.0f / (bcol - cprev * acol);
  cprev = ck * divided;
  rk[1] = divided;
}

// Level k of the record from w_k and w_{k+1} (w_{k+1} unused at the last
// level, kl); `cprev` carries cprev_{k-1} in and cprev_k out.
__device__ __forceinline__ void w_level(int k, int kl, float wk, float wk1,
                                        float& cprev, float* rk) {
  if (k == 0) {
    const float gcv = 0.25f * wk1;
    const float ck = gcv * kBetP;
    const float divided = 1.0f / (kDtrStage - ck);
    cprev = ck * divided;
    rk[0] = 0.0f;
    rk[1] = divided;
  } else if (k < kl) {
    w_level_mid(wk, wk1, cprev, rk);
  } else {
    const float gav = -0.25f * wk;
    const float as = gav * kBetM;
    const float acol = gav * kBetP;
    rk[0] = as;
    rk[1] = 1.0f / ((kDtrStage - acol) - cprev * acol);
  }
}

// The record of a column of 2 <= nz <= NZ levels, w read down the column
// from `pw` (level 0) in steps of `plane`; every load is issued before the
// arithmetic needs it.
template <int NZ, int R, typename T>
__device__ __forceinline__ void w_record(float* rec, const T* pw,
                                         int64_t plane, int nz) {
  float wv[NZ];   // wv[0] unused: level 0 reads w_1 only
#pragma unroll
  for (int k = 1; k < NZ; ++k) {
    if (k < nz) {
      pw += plane;
      asm volatile("" : "+l"(pw));   // a walk, not NZ offsets kept live
      wv[k] = ld(pw, 0);
    }
  }
  wv[0] = 0.0f;
  float cprev = 0.0f;
#pragma unroll
  for (int k = 0; k < NZ; ++k)
    if (k < nz) w_level(k, nz - 1, wv[k], wv[k + 1 < NZ ? k + 1 : k], cprev,
                        rec + R * k);
}

// D_k of the forward sweep at a level 0 < k < kl from the record at k (`rk`,
// as_{k+1} at rk[R]), the field at k-1, k and k+1, the right-hand side at k
// and D_{k-1} (forward_chunk's middle, without its branches).
template <int R>
__device__ __forceinline__ float forward_mid(const float* rk, float fm,
                                             float f0, float f1, float rhs0,
                                             float dprev) {
  const float as = rk[0];
  const float cs = -rk[R];
  const float acol = as;
  const float corr = -as * (fm - f0) - cs * (f1 - f0);
  return ((rhs0 + corr) - dprev * acol) * rk[1];
}

// Forward sweep over levels k0 .. k0+kChunk-1 (those <= kl): D_k goes to
// sd(r) for k < kl; at kl the sweep's result, x_kl, goes to `x`. f(r) is the
// field r levels past k0 (r from -1 to kChunk); rhs(r, f0) the right-hand
// side at level k0 + r; `dprev` carries D from chunk to chunk.
template <int kChunk, int R, typename FA, typename SA, typename Rhs>
__device__ __forceinline__ void forward_chunk(int k0, int kl, const float* rc,
                                              FA f, SA sd, Rhs rhs,
                                              float& dprev, float& x) {
#pragma unroll
  for (int li = 0; li < kChunk; ++li) {
    const int k = k0 + li;
    const float f0 = f(li);
    if (k == 0) {
      const float cs = -rc[R];
      const float corr = -cs * (f(1) - f0);
      dprev = (rhs(0, f0) + corr) * rc[1];
      sd(0) = dprev;
    } else if (k < kl) {
      dprev = forward_mid<R>(rc + R * li, f(li - 1), f0, f(li + 1),
                             rhs(li, f0), dprev);
      sd(li) = dprev;
    } else if (k == kl) {
      const float as = rc[R * li];
      const float acol = as;
      const float corr = -as * (f(li - 1) - f0);
      x = ((rhs(li, f0) + corr) - dprev * acol) * rc[R * li + 1];
    }
  }
}

// The backward sweep's coefficient at level k < kl from the record at level
// k, `rk`: cc_k = cprev_k = -as_{k+1} * divided_k.
template <int R>
__device__ __forceinline__ float c_coef(const float* rk) {
  return -rk[R] * rk[1];
}

// Backward sweep over levels ktop, ktop-1, ..., ktop-kChunk+1 (those <= kl):
// `x` steps down from level k+1 to k (at kl it already holds the forward
// sweep's result), the stage tendency follows and the point-wise update
// v = f + dt * stage; emit(r, k, v, stage) takes both. f(r) and sd(r) are
// the field and D r levels below ktop; cc(r) is `c_coef` at that level (a
// kernel that keeps the record computes it there; one that keeps no record
// stored it in its forward sweep).
template <int kChunk, typename CA, typename FA, typename SA, typename Emit>
__device__ __forceinline__ void backward_chunk(int ktop, int kl, CA cc, FA f,
                                               SA sd, float dt, float& x,
                                               Emit emit) {
#pragma unroll
  for (int li = 0; li < kChunk; ++li) {
    const int k = ktop - li;
    if (k <= kl) {
      if (k < kl) x = sd(li) - cc(li) * x;
      const float fk = f(li);
      const float stage = kDtrStage * (x - fk);
      emit(li, k, fk + dt * stage, stage);
    }
  }
}

// Cluster barrier halves, per thread (not .aligned: a warp may arrive from
// divergent code). Both kernels run their blocks as thread block clusters.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

}  // namespace nero
