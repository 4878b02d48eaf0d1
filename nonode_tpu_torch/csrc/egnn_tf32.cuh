// Pieces shared by the pairwise-chain kernels (egnn_fused_fwd.cu and
// egnn_fused_bwd.cu): the tile shape, the split ("3x") TF32 products on the
// tensor cores, the SiLU formulas, the weight staging, the persistent grid
// and the one dispatch on the width H.
//
// Two widths are instantiated. H = 64 stages W2 and Wc1 in shared memory as
// {big, small} pairs (68 KB for both). At H = 128 the pairs would take
// 2 x 128 x 132 float2 = 270 KB, more than a block's 227 KB, so that route
// reads the raw fp32 matrices (64 KB each, resident in L1 and L2) from
// global memory and splits each B element into big and small in registers
// as it is loaded: the same two TF32 values split_weights would store, so
// the products are the same whichever route a width takes.
//
// Split TF32. The JAX package computes the chain's products at
// Precision.HIGHEST, full fp32. A single TF32 tensor-core pass keeps 10
// mantissa bits (about 1e-3 relative), too coarse for the port's fp32 parity.
// So every operand is written as big + small, each rounded to TF32 with
// cvt.rna (round to nearest, ties away from zero), small taken from the fp32
// difference a - big; a product is the sum of the three tensor-core products
// small*big' + big*small' + big*big', accumulated in fp32. The dropped term
// small*small' is about 2^-22 of |a||b|: fp32-class error at a third of the
// TF32 rate. tests/test_torch_tf32_split.py emulates the rounding on the CPU
// at the kernels' shapes.
//
// The products are mma.sync.m16n8k8 TF32 in inline PTX, with the fragment
// layouts of the PTX ISA (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Knowing where each accumulator sits lets the kernels add biases, take
// SiLUs and sum rows on the accumulators themselves, with no pass through
// shared memory. Rows padded to H + 4 floats (4 mod 32) make every fragment
// load, row-major or transposed, touch 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace egnn_tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // edge rows of a tile: 16 per warp
constexpr int kMaxE = 4;             // edge features the kernels take
constexpr int kMaxN = 64;            // nodes of a graph the kernels take
constexpr float kClip = 100.0f;

// A row of a per-edge [kRows][H] tile, and of a staged HxH weight, is padded
// by 4 floats: the fragment loads then touch 32 distinct banks.
template <int H>
__host__ __device__ constexpr int padded() { return H + 4; }

// Whether width H stages its weights in shared memory (see the top).
template <int H>
constexpr bool kStaged = H == 64;

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// One m16n8k8 TF32 product: c += a b.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big and small of four operand elements.
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b = to_tf32(v[i]);
    big[i] = __float_as_uint(b);
    small[i] = __float_as_uint(to_tf32(v[i] - b));
  }
}

// c += a b in split TF32, b given as its two {big, small} pairs: the two
// correction products, then big * big.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], float2 b0, float2 b1) {
  mma_tf32(c, a_small, __float_as_uint(b0.x), __float_as_uint(b1.x));
  mma_tf32(c, a_big, __float_as_uint(b0.y), __float_as_uint(b1.y));
  mma_tf32(c, a_big, __float_as_uint(b0.x), __float_as_uint(b1.x));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }
__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }
// silu'(z) from s = sigmoid(z)
__device__ __forceinline__ float dsilu(float z, float s) { return s * (1.0f + z * (1.0f - s)); }

// NaN-preserving clip, as jnp.clip / torch.clamp.
__device__ __forceinline__ float clip(float v) {
  return v < -kClip ? -kClip : (v > kClip ? kClip : v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// W2 and Wc1 are staged as [H][H + 4] float2 {big, small}, [in][out]: one
// 64-bit load gives both halves of a B element. The raw copy lands in the
// upper half of each buffer first (stage_weights_async, cp.async, while the
// block computes), then split_weights expands it in place.
template <int H>
__device__ __forceinline__ float* raw_weight(float2* w) {
  return reinterpret_cast<float*>(w) + 2 * H * padded<H>() - H * H;
}

template <int H>
__device__ __forceinline__ void stage_weights_async(float2* s_w2, float2* s_wc1,
                                                    const float* w2, const float* wc1) {
  float* raw2 = raw_weight<H>(s_w2);
  float* raw1 = raw_weight<H>(s_wc1);
  for (int k = threadIdx.x; k < H * H / 4; k += blockDim.x) {
    cp_async16(raw2 + 4 * k, w2 + 4 * k);
    cp_async16(raw1 + 4 * k, wc1 + 4 * k);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int H>
__device__ __forceinline__ void split_weights(float2* s_w2, float2* s_wc1) {
  constexpr int LD = padded<H>();
  constexpr int PER = H * H / kThreads;
  static_assert(H * H % kThreads == 0, "the threads split the weights evenly");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float v2[PER], v1[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v2[i] = raw_weight<H>(s_w2)[threadIdx.x + i * kThreads];
    v1[i] = raw_weight<H>(s_wc1)[threadIdx.x + i * kThreads];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = threadIdx.x + i * kThreads;
    const int at = (k / H) * LD + k % H;
    float b = to_tf32(v2[i]);
    s_w2[at] = make_float2(b, to_tf32(v2[i] - b));
    b = to_tf32(v1[i]);
    s_wc1[at] = make_float2(b, to_tf32(v1[i] - b));
  }
  __syncthreads();
}

struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct Silu {
  __device__ __forceinline__ float operator()(float v) const { return silu(v); }
};

// The B operand of the products, W [H][H] ([in][out]) as {big, small}
// pairs at element offset `at`: staged in shared memory in padded rows, or
// read raw from global memory and split as it is loaded.
template <int H>
struct StagedWeight {
  static constexpr int kLd = padded<H>();
  const float2* w;
  __device__ __forceinline__ float2 operator()(int at) const { return w[at]; }
};

template <int H>
struct GlobalWeight {
  static constexpr int kLd = H;
  const float* w;
  __device__ __forceinline__ float2 operator()(int at) const {
    const float v = __ldg(w + at);
    const float b = to_tf32(v);
    return make_float2(b, to_tf32(v - b));
  }
};

template <int H>
using Weight = std::conditional_t<kStaged<H>, StagedWeight<H>, GlobalWeight<H>>;

// Width H's operand of one weight: the staged pairs, or the raw matrix.
template <int H>
__device__ __forceinline__ Weight<H> weight_of(const float2* staged, const float* raw) {
  if constexpr (kStaged<H>)
    return Weight<H>{staged};
  else
    return Weight<H>{raw};
}

// acc = op(act) @ W (or @ W^T) in split TF32 over the warp's 16 rows of act
// ([16][LD], row-major): acc[nt] is the m16 n8 tile of output columns
// 8 nt .. 8 nt + 7, in the C layout above. op (Identity or Silu) is applied
// to each A element as it is loaded.
template <int H, bool transposed, class Act, class W>
__device__ __forceinline__ void rows_times_weight(float (&acc)[H / 8][4], const float* act,
                                                  W w, Act op) {
  constexpr int LD = padded<H>();
  constexpr int WLD = W::kLd;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const float* a_lo = act + g * LD + t;
  const float* a_hi = a_lo + 8 * LD;
  // B(k, n) = W[k][n], or W[n][k] for W^T; k = 8 ks + t (+ 4), n = 8 nt + g
  const int wl = transposed ? g * WLD + t : t * WLD + g;
#pragma unroll 2
  for (int ks = 0; ks < H / 8; ++ks) {
    const float a[4] = {op(a_lo[8 * ks]), op(a_hi[8 * ks]), op(a_lo[8 * ks + 4]),
                        op(a_hi[8 * ks + 4])};
    uint32_t a_big[4], a_small[4];
    split4(a, a_big, a_small);
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int o0 = wl + (transposed ? 8 * nt * WLD + 8 * ks : 8 * ks * WLD + 8 * nt);
      const int o1 = o0 + (transposed ? 4 : 4 * WLD);
      mma3(acc[nt], a_big, a_small, w(o0), w(o1));
    }
  }
}

// Writes accumulators over the warp's 16 rows of out (after every lane has
// read its operands there).
template <int H>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[H / 8][4]) {
  const int lane = threadIdx.x & 31;
  float* lo = out + (lane >> 2) * padded<H>() + 2 * (lane & 3);
  float* hi = lo + 8 * padded<H>();
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    *reinterpret_cast<float2*>(lo + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(hi + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
}

// Persistent grid: at most max_per_sm resident blocks of `threads` threads
// on each SM, from the SM count and the occupancy query, and never more
// blocks than units. Block b takes units b, b + grid, ...: a static
// assignment, so every sum keeps a fixed order from run to run.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, size_t smem, long long units, int max_per_sm,
                                   int threads, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > max_per_sm) per_sm = max_per_sm;
  const long long slots = (long long)sms * per_sm;
  *grid = (int)(units < slots ? units : slots);
  return cudaSuccess;
}

// The one dispatch on the width: f(std::integral_constant<int, H>()) for an
// instantiated H, cudaErrorInvalidValue for any other h. Both kernels' entry
// points and the backward's scratch size go through it, so a launch and the
// scratch it is given always agree on H.
template <class F>
inline cudaError_t with_width(int h, F&& f) {
  switch (h) {
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool instantiated(int h) {
  return with_width(h, [](auto) { return cudaSuccess; }) == cudaSuccess;
}

// The shapes #1 and #2 both take: G = K * B graphs of 1..kMaxN nodes, an
// instantiated H, 1..kMaxE edge features, and 1..65535 weight sets (the
// grid's y extent).
inline bool bad_shape(long long g, int n, int h, int e, int k) {
  return g <= 0 || n < 1 || n > kMaxN || !instantiated(h) || e < 1 || e > kMaxE || k < 1 ||
         k > 65535 || g % k != 0;
}

}  // namespace egnn_tc
