// The wide route of the pairwise chain's forward (egnn_fused_fwd.cu): every
// width the H = 64 and H = 128 instantiations do not take, and any number E
// of edge features at any width; and the pieces the backward's tile route
// (egnn_fused_bwd.cu) shares with it. The wrapper zero-pads H to a multiple
// of kCols (ops/kernels/egnn_fused.py: padded_width); H is a runtime value
// here, so there is no width limit.
//
// What changes against the instantiated widths, and why:
// - A row of H columns no longer fits a warp's accumulators (at H = 128 a
//   thread holds 64 of them for one product). A product runs over output
//   column passes of kCols = 64 columns (32 accumulators a thread), each
//   with K stepping over all H in m16n8k8 steps; the units of a product,
//   (m16 row tile, column pass), are spread over the block's 8 warps, with
//   a block barrier between stages instead of a warp owning its rows.
// - So a product cannot write its output over its own A operand: the
//   forward keeps a1 and msg in two tiles of [R][H + 4], each stage writing
//   a tile that its product does not read.
// - W2 and Wc1 are read raw from global memory (L1 and L2 hold them: 4 MB
//   each at H = 1024) and split into TF32 {big, small} in registers as they
//   load, as the H = 128 route does; the vectors (wg, b1, b2, bc1, wc2, We)
//   are read from global memory too, so shared memory holds only the tiles
//   and the per-row fields.
// - E is a loop bound everywhere: efea is read from global memory in the
//   first layer. Nothing is sized by E.
// - The tile's rows R follow H: the largest multiple of 16 up to 128, and at
//   least N (a tile holds whole receivers: every receiver's sums over its
//   senders run inside one tile, in order), whose tiles fit in a block's
//   227 KB beside the per-row fields. Where even R = roundup(N, 16) does
//   not fit, the tiles go to the block's slot of a global scratch buffer
//   (kGlobalRows rows) and the same code reads them through generic
//   pointers: above H = 1728 at N <= 16, above H = 832 at N = 31, above
//   H = 384 at N = 64. At H = 256 the forward takes R = 96.
// - A launch takes no more blocks than keep one seed's global tiles within
//   kScratchFloats, so the buffer stays bounded; block counts stay a
//   function of the shapes and the SM count.
// The rules of the instantiated widths hold: no atomics, a static
// assignment of units to blocks, block (b, s) runs seed s's units, and a
// receiver slice changes indexing, not tiles.
#pragma once

#include "egnn_tf32.cuh"

namespace egnn_tc {

// kCols (egnn_tf32.cuh): the output columns of a product pass
constexpr int kGlobalRows = 64;       // rows of a tile kept in global memory
constexpr size_t kSmemBytes = 232448;  // a block's shared memory (227 KB)
constexpr long long kScratchFloats = 1LL << 26;   // one seed's scratch (256 MB)

// Width h's row stride in a tile (h a multiple of kCols: 4 mod 32 floats,
// conflict-free fragment loads as in egnn_tf32.cuh).
__host__ __device__ constexpr int padded_wide(int h) { return h + 4; }

__host__ __device__ constexpr long long round32(long long v) { return (v + 31) / 32 * 32; }

// Floats of a block's tiles: `tiles` per-edge tiles of [rows][h + 4] and
// the per-row partial sums of a product's column passes, [rows][h / kCols].
inline long long wide_tile_floats(int h, int rows, int tiles) {
  return round32((long long)rows * (tiles * padded_wide(h) + h / kCols));
}

struct WideTiles {
  int rows;          // edge rows of a tile: a multiple of 16, at least N
  long long floats;  // floats of the tiles
  bool shared;       // in shared memory; else in the block's scratch slot
};

// The tile of a wide launch with `tiles` per-edge tiles, beside `fixed`
// floats of the kernel's own shared memory (see the top).
inline WideTiles wide_tiles(int h, int n, int tiles, int fixed) {
  const int least = (n + 15) / 16 * 16;
  for (int r = kRows; r >= least; r -= 16) {
    const long long f = wide_tile_floats(h, r, tiles);
    if (sizeof(float) * (fixed + f) <= kSmemBytes) return {r, f, true};
  }
  return {kGlobalRows, wide_tile_floats(h, kGlobalRows, tiles), false};
}

// Blocks of a wide launch over `units` units of one seed: the persistent
// grid of one 256-thread block an SM, and no more blocks than keep
// per_block floats of scratch each within kScratchFloats.
template <class Kernel>
inline cudaError_t wide_grid(Kernel kernel, size_t smem, long long units, long long per_block,
                             int* grid) {
  cudaError_t err = persistent_grid(kernel, smem, units, 1, kThreads, grid);
  if (err != cudaSuccess || per_block <= 0) return err;
  const long long cap = kScratchFloats / per_block;
  if (*grid > cap) *grid = cap > 1 ? (int)cap : 1;
  return cudaSuccess;
}

// B(k, n) of a raw fp32 weight W ([.][ldw] row-major, [in][out]) from global
// memory, as {big, small}: W[k][n], or W[n][k] for W^T.
template <bool transposed>
__device__ __forceinline__ float2 weight_pair(const float* w, int ldw, int k, int n) {
  const float v = __ldg(w + (transposed ? (long long)n * ldw + k : (long long)k * ldw + n));
  const float b = to_tf32(v);
  return make_float2(b, to_tf32(v - b));
}

// K steps a product's tensor-core chain accumulates from zero (64, as the
// H = 64 instantiation); the chunks' sums are added in fp32. The MMA's fp32
// accumulation is not rounded to nearest, and its error grows with the
// chain's length: in one chain, tot_f at EGNO's serving shape read 5.0e-6
// relative to its plain version at K = 256 and 1.06e-5 at K = 512
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), where the same split
// products with rounded accumulation stay within the budget at every width
// (tests/test_torch_tf32_split.py, the whole chain emulated).
constexpr int kChainSteps = 8;

// acc = op(A) @ B[:, n0 .. n0 + kCols) in split TF32: A the 16 rows at `a`
// (stride lda; shared or global), K = 8 ksteps, B(k, n) = W[k][n] or W[n][k]
// (transposed) with W raw in global memory. acc[nt] is the m16 n8 tile of
// columns n0 + 8 nt .. n0 + 8 nt + 7 in egnn_tf32.cuh's C layout; op is
// applied to each A element as it is loaded.
template <bool transposed, class Act>
__device__ __forceinline__ void rows_times_cols(float (&acc)[kCols / 8][4], const float* a,
                                                int lda, const float* w, int ldw, int ksteps,
                                                int n0, Act op) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const float* a_lo = a + g * lda + t;
  const float* a_hi = a_lo + 8 * lda;
  for (int k0 = 0; k0 < ksteps; k0 += kChainSteps) {
    float part[kCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
      part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.0f;
    const int k1 = min(ksteps, k0 + kChainSteps);
#pragma unroll 2
    for (int ks = k0; ks < k1; ++ks) {
      const float av[4] = {op(a_lo[8 * ks]), op(a_hi[8 * ks]), op(a_lo[8 * ks + 4]),
                           op(a_hi[8 * ks + 4])};
      uint32_t a_big[4], a_small[4];
      split4(av, a_big, a_small);
      const int k = 8 * ks + t;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int n = n0 + 8 * nt + g;
        mma3(part[nt], a_big, a_small, weight_pair<transposed>(w, ldw, k, n),
             weight_pair<transposed>(w, ldw, k + 4, n));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
  }
}

// pre1 = r2 wg + efea @ we + hi + hj + b1 at columns c .. c + 3 of one edge
// row (ef: its E features; u, w: its hi and hj columns), in the order of the
// instantiated kernels; the weights read from global memory one float at a
// time (the wrapper aligns only hi, hj, W2 and Wc1).
__device__ __forceinline__ float4 first_layer(float r2, const float* ef, int e, const float* wg,
                                              const float* we, const float* b1, int h, int c,
                                              float4 u, float4 w) {
  float acc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) acc[t] = r2 * __ldg(wg + c + t);
  for (int k = 0; k < e; ++k) {
    const float v = __ldg(ef + k);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = fmaf(v, __ldg(we + k * h + c + t), acc[t]);
  }
  return make_float4(acc[0] + u.x + w.x + __ldg(b1 + c), acc[1] + u.y + w.y + __ldg(b1 + c + 1),
                     acc[2] + u.z + w.z + __ldg(b1 + c + 2),
                     acc[3] + u.w + w.w + __ldg(b1 + c + 3));
}

// The quad of lanes that holds rows g and g + 8 of a product's accumulators
// adds its per-lane sums in a fixed butterfly.
__device__ __forceinline__ void quad_sum(float& lo, float& hi) {
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
}

}  // namespace egnn_tc
