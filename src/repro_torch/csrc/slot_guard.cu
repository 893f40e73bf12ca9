// The serving engine's per-slot guard: one pass over a lane's leaves that
// gives each ensemble slot a validity bit (every element finite and
// |x| <= limit) and a uint32 digest of its exact bits.
//
// Replaces `slot_guard` (src/repro/weather/program.py:263), a jitted jnp
// function that XLA fuses into about one pass over the lane; it has no
// Pallas kernel. The plain version beside it is
// `repro_torch/kernels/slot_guard/ref.py::slot_guard`, and the result is
// an exact integer and exact booleans, so the kernel matches it bit for bit.
//
// Bound: device-memory bytes. Every leaf is read once; E x (8 + 1) bytes
// come out.
//
// Design: a block of 256 threads covers a (chunk of rows, leaf, slot); a
// warp takes a row (the x axis, contiguous) at a time, each lane 16 bytes
// a load (4 fp32 or 8 bf16 elements) when every row starts 16-byte aligned,
// else one element a lane (a cropped view). An element's bits b, widened to
// 32, are mixed with its position, v = (b + z*A1 + y*A2 + x*A3) * MIX,
// v ^= v >> 16, and XORed into the lane's word; the largest |x| is kept as
// the bits of |x| (non-negative floats order as their bits, and NaN and Inf
// order above every finite value). Warp shuffles, then shared memory,
// reduce a block to one XOR word and one max word, which go to the slot's
// and leaf's pair of words by atomicXor and atomicMax. A second launch of
// E threads combines the leaves in order, fp = fp * LEAF ^ f, and compares
// each leaf's max with the limit's bits.
//
// On a mesh each shard's block of the state runs the first launch alone
// (`nero_slot_guard_partial`), with its global offset (y0, x0) in the
// position hash, into its rows of an (S, E, leaves, 2) buffer of S
// distinct blocks; one `nero_slot_guard_finish` then XORs the S acc words
// and takes the largest of the S max words before the leaves' combine.
// XOR and max are order-free, so the digest is the whole state's however it
// is split, as the JAX package's sharded jnp reduction is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;

constexpr uint32_t kMix = 0x9E3779B1u;
constexpr uint32_t kLeafMix = 0x01000193u;
constexpr uint32_t kAxisZ = 0xC2B2AE35u;  // FP_AXIS[1]: axis 1 of (E,z,y,x)
constexpr uint32_t kAxisY = 0x27D4EB2Fu;  // FP_AXIS[2]
constexpr uint32_t kAxisX = 0x165667B1u;  // FP_AXIS[3]

struct Leaves {
  const void* ptr[kMaxLeaves];
  long long se[kMaxLeaves];  // element strides of the slot, z and y axes
  long long sz[kMaxLeaves];
  long long sy[kMaxLeaves];
};

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = uint32_t;
  static constexpr uint32_t kAbs = 0x7FFFFFFFu;
};
template <>
struct Bits<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr uint32_t kAbs = 0x7FFFu;
};

__device__ __forceinline__ void mix(uint32_t b, uint32_t pos, uint32_t& acc,
                                    uint32_t& mx, uint32_t abs_mask) {
  uint32_t v = (b + pos) * kMix;
  v ^= v >> 16;
  acc ^= v;
  mx = max(mx, b & abs_mask);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    guard_partial(Leaves leaves, int nleaves, int nz, int ny, int nx,
                  uint32_t y0, uint32_t x0, uint32_t* __restrict__ words) {
  using U = typename Bits<T>::U;
  constexpr uint32_t kAbsMask = Bits<T>::kAbs;
  constexpr int kV = 16 / sizeof(T);  // elements a 16-byte load
  const int leaf = blockIdx.y, e = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const U* base = static_cast<const U*>(leaves.ptr[leaf]) +
                  static_cast<long long>(e) * leaves.se[leaf];
  const long long sz = leaves.sz[leaf], sy = leaves.sy[leaf];
  const int rows = nz * ny;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  uint32_t acc = 0, mx = 0;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int z = r / ny, y = r - z * ny;
    const U* row = base + z * sz + y * sy;
    const uint32_t rowpos = static_cast<uint32_t>(z) * kAxisZ +
                            (y0 + static_cast<uint32_t>(y)) * kAxisY;
    if (kVec) {
      const uint4* vrow = reinterpret_cast<const uint4*>(row);
      for (int c = lane; c < nx / kV; c += 32) {
        const uint4 q = __ldg(vrow + c);
        const U* el = reinterpret_cast<const U*>(&q);
        const uint32_t xc = x0 + static_cast<uint32_t>(c * kV);
#pragma unroll
        for (int j = 0; j < kV; ++j)
          mix(el[j], rowpos + (xc + j) * kAxisX, acc, mx, kAbsMask);
      }
    } else {
      for (int x = lane; x < nx; x += 32)
        mix(row[x], rowpos + (x0 + static_cast<uint32_t>(x)) * kAxisX, acc,
            mx, kAbsMask);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
  }
  __shared__ uint32_t s_acc[kWarps], s_mx[kWarps];
  if (lane == 0) {
    s_acc[warp] = acc;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      acc ^= s_acc[w];
      mx = max(mx, s_mx[w]);
    }
    uint32_t* word = words + 2 * (static_cast<long long>(e) * nleaves + leaf);
    atomicXor(word, acc);
    atomicMax(word + 1, mx);
  }
}

// words: (S, E, nleaves, 2), S blocks' partial words (S = 1 on one device)
__global__ void guard_finish(const uint32_t* __restrict__ words, int S,
                             int E, int nleaves, long long thr,
                             long long* __restrict__ fp_out,
                             bool* __restrict__ ok_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long block = 2LL * E * nleaves;
  uint32_t fp = 0;
  bool ok = true;
  for (int l = 0; l < nleaves; ++l) {
    const uint32_t* w =
        words + 2LL * (static_cast<long long>(e) * nleaves + l);
    uint32_t acc = 0, mx = 0;
    for (int s = 0; s < S; ++s, w += block) {
      acc ^= w[0];
      mx = max(mx, w[1]);
    }
    fp = l == 0 ? acc : (fp * kLeafMix) ^ acc;
    ok = ok && static_cast<long long>(mx) <= thr;
  }
  fp_out[e] = static_cast<long long>(fp);
  ok_out[e] = ok;
}

template <typename T>
int launch(const Leaves& leaves, int nleaves, int E, int nz, int ny, int nx,
           int vec, uint32_t y0, uint32_t x0, uint32_t* words,
           cudaStream_t st) {
  const long long rows = static_cast<long long>(nz) * ny;
  const long long chunks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (rows > INT_MAX || chunks > INT_MAX || E > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(chunks), nleaves, E);
  if (vec)
    guard_partial<T, true><<<grid, kThreads, 0, st>>>(leaves, nleaves, nz,
                                                      ny, nx, y0, x0, words);
  else
    guard_partial<T, false><<<grid, kThreads, 0, st>>>(leaves, nleaves, nz,
                                                       ny, nx, y0, x0, words);
  return static_cast<int>(cudaGetLastError());
}

int partial(const long long* desc, int nleaves, int E, int nz, int ny,
            int nx, int bf16, int vec, long long y0, long long x0,
            uint32_t* words, cudaStream_t st) {
  if (nleaves < 1 || nleaves > kMaxLeaves || E < 1 || nz < 1 || ny < 1 ||
      nx < 1 || (vec != 0 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves leaves{};
  for (int l = 0; l < nleaves; ++l) {
    leaves.ptr[l] = reinterpret_cast<const void*>(desc[4 * l]);
    leaves.se[l] = desc[4 * l + 1];
    leaves.sz[l] = desc[4 * l + 2];
    leaves.sy[l] = desc[4 * l + 3];
  }
  // positions hash mod 2^32, as the JAX package's uint32 iota does
  const auto oy = static_cast<uint32_t>(y0), ox = static_cast<uint32_t>(x0);
  return bf16 ? launch<__nv_bfloat16>(leaves, nleaves, E, nz, ny, nx, vec,
                                      oy, ox, words, st)
              : launch<float>(leaves, nleaves, E, nz, ny, nx, vec, oy, ox,
                              words, st);
}

int finish(const uint32_t* words, int S, int E, int nleaves, long long thr,
           void* fp_out, void* ok_out, cudaStream_t st) {
  if (S < 1 || E < 1 || nleaves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  guard_finish<<<(E + 127) / 128, 128, 0, st>>>(
      words, S, E, nleaves, thr, static_cast<long long*>(fp_out),
      static_cast<bool*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// desc: per leaf (pointer, slot stride, z stride, y stride), x contiguous,
// each leaf (E, nz, ny, nx) of one dtype; vec 1 when every row starts
// 16-byte aligned and nx fills whole 16-byte vectors. thr: the largest
// |x| bits that pass (-1: none). words: E * nleaves * 2 uint32 of scratch,
// zeroed here. Writes fp_out (E int64, each a uint32) and ok_out (E bool).
extern "C" int nero_slot_guard(const long long* desc, int nleaves, int E,
                               int nz, int ny, int nx, int bf16, int vec,
                               long long thr, void* words, void* fp_out,
                               void* ok_out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<uint32_t*>(words);
  if (nleaves < 1 || nleaves > kMaxLeaves || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      w, 0, sizeof(uint32_t) * 2 * static_cast<size_t>(E) * nleaves, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = partial(desc, nleaves, E, nz, ny, nx, bf16, vec, 0, 0, w, st);
  if (rc) return rc;
  return finish(w, 1, E, nleaves, thr, fp_out, ok_out, st);
}

// One block of a sharded state: the partial pass alone, its positions
// hashed at the block's global offset (y0, x0), accumulated into `words`
// (E * nleaves * 2 uint32, zeroed by the caller).
extern "C" int nero_slot_guard_partial(const long long* desc, int nleaves,
                                       int E, int nz, int ny, int nx,
                                       int bf16, int vec, long long y0,
                                       long long x0, void* words,
                                       void* stream) {
  return partial(desc, nleaves, E, nz, ny, nx, bf16, vec, y0, x0,
                 static_cast<uint32_t*>(words),
                 static_cast<cudaStream_t>(stream));
}

// The combine over S blocks' partial words, (S, E, nleaves, 2) uint32.
extern "C" int nero_slot_guard_finish(const void* words, int S, int E,
                                      int nleaves, long long thr,
                                      void* fp_out, void* ok_out,
                                      void* stream) {
  return finish(static_cast<const uint32_t*>(words), S, E, nleaves, thr,
                fp_out, ok_out, static_cast<cudaStream_t>(stream));
}
