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
// against 16 bytes per body in and 12 out, so the CUDA cores (67 TFLOP/s)
// and the special-function units set the bound, not HBM: at N = 1000,
// 10^6 pairs, a third of a microsecond.
// Why a standalone launch cannot reach half of that bound: the launch
// itself (the grid's start on every SM) and one round trip to L2 for the
// senders each take longer than the 0.17 us that half the bound allows,
// and a sum cannot start before its senders have arrived. So the design
// aims at the chain of latencies, not at the arithmetic, and the frame loop
// of the stretch run does not launch this kernel at all: its force
// evaluations run inside the leapfrog block (nbody_leapfrog.cu, with record
// outputs), and only the kick before the loop is left here.
// Design:
// - The sum order of the leapfrog blocks (nbody_pair.cuh): 2 warps a
//   receiver, 8 receivers a block of 512 threads, so N = 1000 is 125 blocks,
//   about one per SM, and each thread adds about 16 senders. A force from
//   here has the bits of the force a leapfrog micro-step computes.
// - All senders staged in one wave: 4-byte cp.async copies of the 3N
//   position floats and the N weights straight into the {x, y, z, weight}
//   tile of the leapfrog blocks, all issued before one wait, so a pair reads
//   its sender with one 16-byte shared load. (16-byte copies of the [N, 3]
//   rows, kept in that layout, were slower: four 4-byte shared loads a
//   pair.)
// - Tiles only past what shared memory holds (about 14,000 bodies on an
//   H100; nbody_pairwise_shape says how many): then each block stages each
//   tile once for each group of receivers it owns.
// What is left after the launch and the wait for L2 is the pair loop:
// about 26 instructions a pair (the rsqrt's denormal fixup, the masked self
// pair, the fixed-order sums) with only 4 warps a scheduler to hide their
// latencies. More warps a receiver would change the sum order that the
// leapfrog blocks share. PERF.md has the measured times.
// - A plain launch (not cooperative), its grid capped at the blocks that
//   are resident at once; block b owns receiver groups b, b + grid, ..., so
//   in one wave a block stages the senders once for all its groups.
// The TPU kernel's lane-major [3, Np] planes and its padding to the
// receiver block have no counterpart: the loops stop at n.

#include "nbody_pair.cuh"

namespace {

using namespace nbody;

constexpr int kPartFloats = 3 * (kBlock / 32);   // the warps' totals

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Senders base .. base + cnt - 1 into the tile, then a block barrier.
__device__ __forceinline__ void stage(const float* pos, const float* wts,
                                      int base, int cnt, float4* tile) {
  float* dst = reinterpret_cast<float*>(tile);
  const float* src = pos + 3 * (size_t)base;
  for (int e = threadIdx.x; e < 3 * cnt; e += kBlock)
    cp_async4(dst + 4 * (e / 3) + e % 3, src + e);
  for (int u = threadIdx.x; u < cnt; u += kBlock)
    cp_async4(dst + 4 * u + 3, wts + base + u);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Shared memory: a tile of `cap` senders {x, y, z, weight}, then the warps'
// totals. cap is a multiple of kBodyThreads when the senders take several
// tiles.
__host__ __device__ constexpr size_t smem_bytes(int cap) {
  return sizeof(float4) * (size_t)cap + sizeof(float) * kPartFloats;
}

template <class Law>
__global__ void __launch_bounds__(kBlock)
pair_kernel(Law law, const float* __restrict__ pos,
            const float* __restrict__ wts, float* __restrict__ out, int n,
            int cap, float scale, float max_abs) {
  extern __shared__ float4 tile[];                         // [cap]
  float* part = reinterpret_cast<float*>(tile + cap);      // [warps][3]
  const int r = threadIdx.x / kBodyThreads, t = threadIdx.x % kBodyThreads;
  const int tiles = (n + cap - 1) / cap;
  const auto sender = [&](int u) { return tile[u]; };
  if (tiles == 1) stage(pos, wts, 0, n, tile);
  for (int g = blockIdx.x; g * kSlots < n; g += gridDim.x) {
    const int i = g * kSlots + r;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, wi = 0.0f;
    if (i < n) {
      xi = __ldcg(pos + 3 * (size_t)i);
      yi = __ldcg(pos + 3 * (size_t)i + 1);
      zi = __ldcg(pos + 3 * (size_t)i + 2);
      wi = __ldcg(wts + i);
    }
    float3 f = make_float3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < tiles; ++k) {
      const int base = k * cap, cnt = min(cap, n - base);
      if (tiles > 1) {
        __syncthreads();                 // the previous tile is consumed
        stage(pos, wts, base, cnt, tile);
      }
      if (i < n) add_senders(law, i, xi, yi, zi, wi, base, cnt, t, sender, f);
    }
    warp_partials(f, part);
    __syncthreads();
    if (i < n && t < 3) {
      const float v = __fmul_rn(scale, receiver_total(part, r, t));
      out[3 * (size_t)i + t] = max_abs > 0.0f ? clip(v, max_abs) : v;
    }
    __syncthreads();                     // part is free for the next group
  }
}

struct Shape {
  int blocks, cap, tiles;
  size_t smem;
};

// The launch for n bodies on the current device: one block per kSlots
// receivers, no more than are resident at once; one wave of senders when
// they fit the shared memory a block may have, else tiles of the most that
// fits.
template <class Law>
int pair_shape(int n, Shape* shape) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)pair_kernel<Law>;
  int dev = 0, sms = 0, most = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int wave = (int)((most - smem_bytes(0)) / sizeof(float4) /
                         kBodyThreads * kBodyThreads);
  const int cap = n <= wave ? n : wave;
  const size_t smem = smem_bytes(cap);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = ((long long)n + kSlots - 1) / kSlots;
  const long long resident = (long long)per_sm * sms;
  shape->blocks = (int)(groups < resident ? groups : resident);
  shape->cap = cap;
  shape->tiles = (n + cap - 1) / cap;
  shape->smem = smem;
  return 0;
}

template <class Law>
int launch(Law law, const float* pos, const float* wts, float* out, int n,
           float scale, float max_abs, cudaStream_t stream) {
  Shape shape;
  const int err = pair_shape<Law>(n, &shape);
  if (err != 0) return err;
  pair_kernel<Law><<<shape.blocks, kBlock, shape.smem, stream>>>(
      law, pos, wts, out, n, shape.cap, scale, max_abs);
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

// The launch of a force kernel (gravity != 0: the gravity one) for n bodies
// on the current device: out = {blocks, threads, receivers a block at a
// time, warps a receiver, senders a tile, tiles, dynamic shared bytes}.
// Returns 0 or a CUDA error code.
extern "C" int nbody_pairwise_shape(int n, int gravity, int* out) {
  Shape s;
  const int err = gravity ? pair_shape<Gravity>(n, &s)
                          : pair_shape<Charged>(n, &s);
  if (err != 0) return err;
  const int shape[7] = {s.blocks, kBlock, kSlots, kBodyWarps, s.cap, s.tiles,
                        (int)s.smem};
  for (int k = 0; k < 7; ++k) out[k] = shape[k];
  return 0;
}
