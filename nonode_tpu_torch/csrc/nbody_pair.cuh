// Pairwise N-body force laws, and the one sum order of every N-body kernel
// (nbody_pairwise.cu and nbody_leapfrog.cu).
//
// Sum order. kBodyWarps warps sum one receiver i. Thread t of its
// kBodyThreads takes the senders j = t, t + kBodyThreads, ... in increasing
// order (add_senders, over staged tiles whose bases are multiples of
// kBodyThreads, so the sequence runs on across tiles); each warp adds its
// 32 partial sums by a fixed xor butterfly, and the warps' totals are added
// in warp order (warp_partials, then receiver_total). The order of every
// sum depends only on N, never on the grid or the tiling: a kernel gives
// the same bits from run to run, and the standalone force kernels give the
// bits of the force that a leapfrog block computes inside a micro-step. No
// atomics.
//
// The laws are written with explicit roundings (__fmul_rn, __fmaf_rn,
// __fadd_rn), so that every kernel that includes them compiles one sequence
// of roundings, whatever the compiler would contract on its own. All
// positions are [N, 3] row-major fp32.

#pragma once

#include <cuda_runtime.h>

namespace nbody {

constexpr int kBodyWarps = 2;                    // warps that sum a receiver
constexpr int kBodyThreads = 32 * kBodyWarps;
constexpr int kSlots = 8;                        // receivers a block at a time
constexpr int kBlock = kSlots * kBodyThreads;    // threads a block

// NaN-preserving clip, as jnp.clip and torch.clamp.
__device__ __forceinline__ float clip(float v, float c) {
  return v < -c ? -c : (v > c ? c : v);
}

// Every lane ends with the same bits: each level adds the same two partial
// sums on both lanes of a pair, and fp addition commutes.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float component(const float3& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : v.z);
}

// dx^2 + dy^2 + dz^2, rounded as two fused multiply-adds on dx^2.
__device__ __forceinline__ float norm2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

__device__ __forceinline__ void add_scaled(float3& acc, float dx, float dy,
                                           float dz, float w) {
  acc.x = __fmaf_rn(dx, w, acc.x);
  acc.y = __fmaf_rn(dy, w, acc.y);
  acc.z = __fmaf_rn(dz, w, acc.z);
}

// Force law of _charged_kernel (nonode_tpu/ops/pallas/pairwise.py:95) and
// _charged_force_block (ops/pallas/nbody_sim.py:51): diff = x_i - x_j; the
// self pair is masked (r2 -> 1 under the rsqrt, weight 0).
struct Charged {
  float k;
  __device__ __forceinline__ void add(int i, int j, float xi, float yi,
                                      float zi, float wi, float xj, float yj,
                                      float zj, float wj, float3& acc) const {
    const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj),
                dz = __fsub_rn(zi, zj);
    // Both arms of each select are computed: the compiler does not
    // speculate the rounding intrinsics, and would branch on every pair.
    const bool valid = j != i;
    const float r2 = norm2(dx, dy, dz);
    const float inv_r = rsqrtf(valid ? r2 : 1.0f);
    const float w = __fmul_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(k, wi), wj), inv_r), inv_r),
        inv_r);
    add_scaled(acc, dx, dy, dz, valid ? w : 0.0f);
  }
};

// Force law of _gravity_kernel (pairwise.py:37) and _accel_block
// (nbody_sim.py:30): diff = x_j - x_i, softened; the self pair is included
// (its diff is 0). The factor G is applied to the total by the caller.
struct Gravity {
  float eps2;
  __device__ __forceinline__ void add(int, int, float xi, float yi, float zi,
                                      float, float xj, float yj, float zj,
                                      float wj, float3& acc) const {
    const float dx = __fsub_rn(xj, xi), dy = __fsub_rn(yj, yi),
                dz = __fsub_rn(zj, zi);
    const float inv_r = rsqrtf(__fadd_rn(norm2(dx, dy, dz), eps2));
    const float w = __fmul_rn(__fmul_rn(__fmul_rn(wj, inv_r), inv_r), inv_r);
    add_scaled(acc, dx, dy, dz, w);
  }
};

// Thread t's share of receiver i's sum over a staged tile of cnt senders
// whose first is sender `base`: law.add for u = t, t + kBodyThreads, ...
// < cnt, in increasing order, with sender(u) the staged {x, y, z, weight}.
template <class Law, class Sender>
__device__ __forceinline__ void add_senders(const Law& law, int i, float xi,
                                            float yi, float zi, float wi,
                                            int base, int cnt, int t,
                                            const Sender& sender,
                                            float3& acc) {
#pragma unroll 4
  for (int u = t; u < cnt; u += kBodyThreads) {
    const float4 s = sender(u);
    law.add(i, base + u, xi, yi, zi, wi, s.x, s.y, s.z, s.w, acc);
  }
}

// Each warp's butterfly; lanes 0-2 then leave the warp's x, y, z total in
// part[3 warp + c]. Every thread of the block calls it; the caller holds a
// __syncthreads() before receiver_total reads part.
__device__ __forceinline__ void warp_partials(float3 acc, float* part) {
  acc.x = warp_sum(acc.x);
  acc.y = warp_sum(acc.y);
  acc.z = warp_sum(acc.z);
  const int lane = threadIdx.x & 31;
  if (lane < 3) part[3 * (threadIdx.x >> 5) + lane] = component(acc, lane);
}

// Component c of the total of the receiver summed by threads
// [r kBodyThreads, (r + 1) kBodyThreads): its warps' totals in warp order.
__device__ __forceinline__ float receiver_total(const float* part, int r,
                                                int c) {
  float tot = part[3 * (r * kBodyWarps) + c];
  for (int q = 1; q < kBodyWarps; ++q)
    tot = __fadd_rn(tot, part[3 * (r * kBodyWarps + q) + c]);
  return tot;
}

}  // namespace nbody

// The name of a CUDA error code, for the wrapper's message.
extern "C" const char* nbody_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
