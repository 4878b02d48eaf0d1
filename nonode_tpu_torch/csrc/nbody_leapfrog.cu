// Fused multi-step N-body integration for Hopper (sm_90a): one launch runs
// all `steps` micro-steps of a sampling block.
//
// Replaces two TPU kernels (launched through pl.pallas_call):
//   nbody_charged_leapfrog <- nonode_tpu/ops/pallas/nbody_sim.py:
//     _charged_block_kernel, per micro-step
//       pos += dt * vel;  vel += dt * F(pos)
//     with F the clipped Coulomb force of _charged_force_block;
//   nbody_gravity_leapfrog <- nbody_sim.py:_gravity_block_kernel, per step
//       vel += acc * (dt/2);  pos += vel * dt;  acc = a(pos);
//       vel += acc * (dt/2)
//     with a the softened gravity of _accel_block.
// The updates are rounded as written (__fmul_rn, __fadd_rn: no contraction
// into an FMA), in the TPU kernel's order.
//
// What bounds it on an H100: per micro-step N^2 pairs at about 22 fp32
// operations and one rsqrt each, and nothing but 3N floats of state; at
// N = 1000 and 99 steps that is 2.2 GFLOP against 32 KB, so operations bound
// it (33 us at 67 TFLOP/s). A micro-step needs every position of the one
// before, and thread blocks cannot wait for each other, so the TPU kernel's
// one program with VMEM-resident state becomes a persistent cooperative
// grid (cudaLaunchCooperativeKernel, no more blocks than can be resident at
// once): each warp owns a receiver and keeps its velocity (and
// acceleration) to itself; positions are double-buffered in device memory,
// so one grid-wide barrier per micro-step, between the drift that writes
// the new positions and the force pass that reads them, is enough. The
// buffer written at step s was last read at step s - 2, before the barrier
// of step s - 1. Sums as in nbody_pair.cuh: fixed order, no atomics, the
// same bits from run to run.

#include <cooperative_groups.h>

#include "nbody_pair.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nbody;

// Receivers of this warp: first, first + stride, ... (the same set in every
// phase, so velocity and acceleration never cross warps).
struct Owner {
  int first, stride, lane;
  __device__ Owner()
      : first(blockIdx.x * kWarps + (threadIdx.x >> 5)),
        stride(gridDim.x * kWarps),
        lane(threadIdx.x & 31) {}
};

__global__ void __launch_bounds__(kThreads)
charged_leapfrog_kernel(const float* pos_in,
                        const float* __restrict__ vel_in,
                        const float* __restrict__ q, float* pos_out,
                        float* vel_out, float* buf, int n, int steps, float dt,
                        float k, float max_f) {
  __shared__ Tile s;
  cg::grid_group grid = cg::this_grid();
  const Owner own;
  const Charged law{k};
  for (int i = own.first; i < n; i += own.stride)
    if (own.lane < 3) vel_out[3 * (size_t)i + own.lane] =
        vel_in[3 * (size_t)i + own.lane];
  const float* cur = pos_in;
  for (int step = 0; step < steps; ++step) {
    float* next = buf + (size_t)(step & 1) * 3 * n;
    for (int i = own.first; i < n; i += own.stride) {   // drift (own bodies)
      if (own.lane < 3) {
        const size_t c = 3 * (size_t)i + own.lane;
        next[c] = __fadd_rn(__ldcg(cur + c), __fmul_rn(dt, vel_out[c]));
      }
    }
    grid.sync();
    cur = next;
    for (int b = blockIdx.x * kWarps; b < n; b += own.stride) {
      const int i = b + (threadIdx.x >> 5);
      const float3 f = pair_sum(law, cur, q, n, i, s);
      if (i < n && own.lane < 3) {                       // kick
        const size_t c = 3 * (size_t)i + own.lane;
        vel_out[c] = __fadd_rn(vel_out[c],
                               __fmul_rn(dt, clip(component(f, own.lane),
                                                  max_f)));
      }
    }
  }
  for (int i = own.first; i < n; i += own.stride)
    if (own.lane < 3) pos_out[3 * (size_t)i + own.lane] =
        __ldcg(cur + 3 * (size_t)i + own.lane);
}

__global__ void __launch_bounds__(kThreads)
gravity_leapfrog_kernel(const float* pos_in,
                        const float* __restrict__ vel_in,
                        const float* __restrict__ acc_in,
                        const float* __restrict__ mass, float* pos_out,
                        float* vel_out, float* acc_out, float* buf, int n,
                        int steps, float dt, float half_dt, float g,
                        float eps2) {
  __shared__ Tile s;
  cg::grid_group grid = cg::this_grid();
  const Owner own;
  const Gravity law{eps2};
  for (int i = own.first; i < n; i += own.stride) {
    if (own.lane < 3) {
      const size_t c = 3 * (size_t)i + own.lane;
      vel_out[c] = vel_in[c];
      acc_out[c] = acc_in[c];
    }
  }
  const float* cur = pos_in;
  for (int step = 0; step < steps; ++step) {
    float* next = buf + (size_t)(step & 1) * 3 * n;
    for (int i = own.first; i < n; i += own.stride) {   // kick, drift
      if (own.lane < 3) {
        const size_t c = 3 * (size_t)i + own.lane;
        const float v = __fadd_rn(vel_out[c], __fmul_rn(acc_out[c], half_dt));
        vel_out[c] = v;
        next[c] = __fadd_rn(__ldcg(cur + c), __fmul_rn(v, dt));
      }
    }
    grid.sync();
    cur = next;
    for (int b = blockIdx.x * kWarps; b < n; b += own.stride) {
      const int i = b + (threadIdx.x >> 5);
      const float3 a = pair_sum(law, cur, mass, n, i, s);
      if (i < n && own.lane < 3) {                       // new acc, kick
        const size_t c = 3 * (size_t)i + own.lane;
        const float ac = __fmul_rn(g, component(a, own.lane));
        acc_out[c] = ac;
        vel_out[c] = __fadd_rn(vel_out[c], __fmul_rn(ac, half_dt));
      }
    }
  }
  for (int i = own.first; i < n; i += own.stride)
    if (own.lane < 3) pos_out[3 * (size_t)i + own.lane] =
        __ldcg(cur + 3 * (size_t)i + own.lane);
}

// The cooperative grid: one block per kWarps receivers, capped at what the
// card holds resident at once (more receivers per warp beyond that).
int cooperative_grid(const void* kernel, int n, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = ((long long)n + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sms;
  *grid = (int)(want < most ? want : most);
  return 0;
}

int launch(const void* kernel, void** args, int n, int steps,
           cudaStream_t stream) {
  if (n < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = cooperative_grid(kernel, n, &grid);
  if (err != 0) return err;
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, stream);
  if (launched != cudaSuccess) {
    cudaGetLastError();                    // clear the refused launch's error
    return (int)launched;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// pos/vel [n, 3], q [n] in; pos_out/vel_out [n, 3] out; buf 2 x [n, 3]
// scratch; all fp32 on the device, outputs distinct from inputs.
extern "C" int nbody_charged_leapfrog(const float* pos, const float* vel,
                                      const float* q, float* pos_out,
                                      float* vel_out, float* buf, int n,
                                      int steps, float dt, float k,
                                      float max_f, void* stream) {
  if (!(max_f > 0.0f)) return (int)cudaErrorInvalidValue;
  void* args[] = {&pos, &vel, &q, &pos_out, &vel_out, &buf, &n, &steps, &dt,
                  &k, &max_f};
  return launch((const void*)charged_leapfrog_kernel, args, n, steps,
                (cudaStream_t)stream);
}

// pos/vel/acc [n, 3], mass [n] in; three [n, 3] out; buf 2 x [n, 3].
extern "C" int nbody_gravity_leapfrog(const float* pos, const float* vel,
                                      const float* acc, const float* mass,
                                      float* pos_out, float* vel_out,
                                      float* acc_out, float* buf, int n,
                                      int steps, float dt, float half_dt,
                                      float g, float eps2, void* stream) {
  void* args[] = {&pos, &vel, &acc, &mass, &pos_out, &vel_out, &acc_out,
                  &buf, &n, &steps, &dt, &half_dt, &g, &eps2};
  return launch((const void*)gravity_leapfrog_kernel, args, n, steps,
                (cudaStream_t)stream);
}

// The grid a block kernel (gravity != 0: the gravity one) launches for n
// bodies on the current device, or a negative CUDA error code.
extern "C" int nbody_leapfrog_grid(int n, int gravity) {
  int grid = 0;
  const int err = cooperative_grid(
      gravity ? (const void*)gravity_leapfrog_kernel
              : (const void*)charged_leapfrog_kernel, n, &grid);
  return err != 0 ? -err : grid;
}
