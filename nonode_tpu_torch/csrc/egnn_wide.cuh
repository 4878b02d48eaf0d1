// Pieces the tile routes of the pairwise chain share: #1's
// (egnn_fused_fwd.cu) and #2's (egnn_fused_bwd.cu), which take every (H, E)
// but H = 64 with E <= kMaxE. H is a runtime value there, a multiple of
// kCols after padding, so there is no width limit; E is a loop bound and
// sizes nothing but the vectors a block stages. Where a route's per-edge
// tiles do not fit in a block's shared memory beside its fields, they go to
// the block's slot of a global scratch buffer and the same code reads them
// through generic pointers.
#pragma once

#include "egnn_tf32.cuh"

namespace egnn_tc {

// kCols (egnn_tf32.cuh): the output columns of a product pass
constexpr int kGlobalRows = 64;       // rows of a tile kept in global memory
constexpr size_t kSmemBytes = 232448;  // a block's shared memory (227 KB)

// Width h's row stride in a tile (h a multiple of kCols: 4 mod 32 floats,
// conflict-free fragment loads as in egnn_tf32.cuh).
__host__ __device__ constexpr int padded_wide(int h) { return h + 4; }

__host__ __device__ constexpr long long round32(long long v) { return (v + 31) / 32 * 32; }

// K steps a product's tensor-core chain accumulates from zero (64 deep, as
// the H = 64 kernels); the chunks' sums are added in fp32. The MMA's fp32
// accumulation is not rounded to nearest, and its error grows with the
// chain's length: in one chain, tot_f at EGNO's serving shape read 5.0e-6
// relative to its plain version at K = 256 and 1.06e-5 at K = 512
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), where the same split
// products with rounded accumulation stay within the budget at every width
// (tests/test_torch_tf32_split.py, the whole chain emulated).
constexpr int kChainSteps = 8;

// The quad of lanes that holds rows g and g + 8 of a product's accumulators
// adds its per-lane sums in a fixed butterfly.
__device__ __forceinline__ void quad_sum(float& lo, float& hi) {
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
}

}  // namespace egnn_tc
