// Pairwise N-body forces for Hopper (sm_90a): one call, one force evaluation.
//
// Replaces two TPU kernels (launched through pl.pallas_call):
//   nbody_charged_force <- nonode_tpu/ops/pallas/pairwise.py:_charged_kernel
//     F_i = clip(k sum_{j != i} q_i q_j (x_i - x_j) / r^3, +-max_f) per
//     component;
//   nbody_gravity_accel <- pairwise.py:_gravity_kernel
//     a_i = G sum_j m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}, self term included.
//
// What bounds it on an H100: about 22 fp32 operations and one rsqrt per pair
// against 16 bytes per body in and 12 out, so the CUDA cores (67 TFLOP/s) and
// the special-function units set the bound, not HBM; at N = 1000 that is
// 10^6 pairs, a third of a microsecond, so the launch itself sets the time.
// What the design does: a warp per receiver, senders staged through shared
// memory in tiles and split over the warp's lanes, a fixed-order butterfly
// for the total (nbody_pair.cuh), enough warps to spread N = 1000 over 125
// SMs. The TPU kernel's lane-major [3, Np] planes and its padding to the
// receiver block have no counterpart: the loops stop at n.

#include "nbody_pair.cuh"

namespace {

using namespace nbody;

template <class Law>
__global__ void __launch_bounds__(kThreads)
pair_kernel(Law law, const float* __restrict__ pos,
            const float* __restrict__ wts, float* __restrict__ out, int n,
            float scale, float max_abs) {
  __shared__ Tile s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x * kWarps; b < n; b += gridDim.x * kWarps) {
    const int i = b + warp;
    const float3 acc = pair_sum(law, pos, wts, n, i, s);
    if (i < n && lane < 3) {
      const float v = scale * component(acc, lane);
      out[3 * (size_t)i + lane] = max_abs > 0.0f ? clip(v, max_abs) : v;
    }
  }
}

template <class Law>
int launch(Law law, const float* pos, const float* wts, float* out, int n,
           float scale, float max_abs, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(blocks < 65535 ? blocks : 65535);
  pair_kernel<Law><<<grid, kThreads, 0, stream>>>(law, pos, wts, out, n,
                                                   scale, max_abs);
  return (int)cudaGetLastError();
}

}  // namespace

// pos [n, 3], q [n], out [n, 3], all fp32 on the device. The charges scale
// inside the sum (k q_i q_j), so the total is taken as it is and clipped.
extern "C" int nbody_charged_force(const float* pos, const float* q,
                                   float* out, int n, float k, float max_f,
                                   void* stream) {
  if (!(max_f > 0.0f)) return (int)cudaErrorInvalidValue;
  return launch(Charged{k}, pos, q, out, n, 1.0f, max_f,
                (cudaStream_t)stream);
}

// pos [n, 3], mass [n], out [n, 3]; eps2 = softening^2. Not clipped.
extern "C" int nbody_gravity_accel(const float* pos, const float* mass,
                                   float* out, int n, float g, float eps2,
                                   void* stream) {
  return launch(Gravity{eps2}, pos, mass, out, n, g, 0.0f,
                (cudaStream_t)stream);
}
