// Pairwise N-body force laws shared by nbody_pairwise.cu and
// nbody_leapfrog.cu, and the sums of nbody_pairwise.cu (the leapfrog block
// kernels have their own, with more warps to a receiver).
//
// pair_sum: one warp owns one receiver i. Its 32 lanes split the senders:
// lane l takes j = l, l + 32, l + 64, ... in increasing order, then a fixed
// xor butterfly adds the 32 partial sums. The order of every sum depends
// only on N, never on the grid, so a result has the same bits from run to
// run and from one grid size to another. No atomics.
//
// Senders are staged through shared memory in tiles of kTile, as planes of
// x, y, z and the sender's weight (charge or mass). All positions are [N, 3]
// row-major. Loads go through L2 only (__ldcg).

#pragma once

#include <cuda_runtime.h>

namespace nbody {

constexpr int kWarps = 8;                // receivers a block works on at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;              // senders staged per pass (16 KB)

struct Tile {
  float x[kTile], y[kTile], z[kTile], w[kTile];
};

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

// Force law of _charged_kernel (nonode_tpu/ops/pallas/pairwise.py:95) and
// _charged_force_block (ops/pallas/nbody_sim.py:51): diff = x_i - x_j; the
// self pair is masked (r2 -> 1 under the rsqrt, weight 0).
struct Charged {
  float k;
  __device__ __forceinline__ void add(int i, int j, float xi, float yi,
                                      float zi, float wi, float xj, float yj,
                                      float zj, float wj, float3& acc) const {
    float dx = xi - xj, dy = yi - yj, dz = zi - zj;
    float r2 = dx * dx + dy * dy + dz * dz;
    bool valid = j != i;
    float inv_r = rsqrtf(valid ? r2 : 1.0f);
    float w = valid ? k * wi * wj * inv_r * inv_r * inv_r : 0.0f;
    acc.x += dx * w;
    acc.y += dy * w;
    acc.z += dz * w;
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
    float dx = xj - xi, dy = yj - yi, dz = zj - zi;
    float r2 = dx * dx + dy * dy + dz * dz + eps2;
    float inv_r = rsqrtf(r2);
    float w = wj * inv_r * inv_r * inv_r;
    acc.x += dx * w;
    acc.y += dy * w;
    acc.z += dz * w;
  }
};

// Sum of law.add over every sender j < n for receiver i (the warp's). Every
// thread of the block calls it with the same n (it holds __syncthreads);
// a warp whose i >= n passes through and gets zeros.
template <class Law>
__device__ float3 pair_sum(const Law& law, const float* pos, const float* wts,
                           int n, int i, Tile& s) {
  const int lane = threadIdx.x & 31;
  float xi = 0.0f, yi = 0.0f, zi = 0.0f, wi = 0.0f;
  if (i < n) {
    xi = __ldcg(pos + 3 * (size_t)i);
    yi = __ldcg(pos + 3 * (size_t)i + 1);
    zi = __ldcg(pos + 3 * (size_t)i + 2);
    wi = __ldcg(wts + i);
  }
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();                     // the previous tile is consumed
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const size_t j = (size_t)base + t;
      s.x[t] = __ldcg(pos + 3 * j);
      s.y[t] = __ldcg(pos + 3 * j + 1);
      s.z[t] = __ldcg(pos + 3 * j + 2);
      s.w[t] = __ldcg(wts + j);
    }
    __syncthreads();
    if (i < n) {
      for (int t = lane; t < cnt; t += 32)
        law.add(i, base + t, xi, yi, zi, wi, s.x[t], s.y[t], s.z[t], s.w[t],
                acc);
    }
  }
  acc.x = warp_sum(acc.x);
  acc.y = warp_sum(acc.y);
  acc.z = warp_sum(acc.z);
  return acc;
}

__device__ __forceinline__ float component(const float3& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : v.z);
}

}  // namespace nbody

// The name of a CUDA error code, for the wrapper's message.
extern "C" const char* nbody_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
