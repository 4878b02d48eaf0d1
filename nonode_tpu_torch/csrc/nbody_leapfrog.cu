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
// it (33 us at 67 TFLOP/s, 0.33 us a micro-step). But a micro-step needs
// every position of the one before, so each step is also a chain of
// latencies: one exchange of positions between the SMs through L2 (a read
// of the words and the wait for the last SM, about 0.7 us), the block's
// barriers, sums and updates (about 0.8 us), and the force pass, about 8
// receivers x 1000 senders on each SM (about 1 us). Half the bound (0.65 us
// a micro-step) is out of reach at this N while a step waits for every
// position of the one before; PERF.md has the measured split.
//
// Design. The TPU ran the whole block as one program with VMEM-resident
// state; here one launch is a persistent cooperative grid
// (cudaLaunchCooperativeKernel, no more blocks than are resident at once:
// one block of kBlock threads per SM, since the spin-waits below need every
// block running):
// - State stays on chip. A block owns a fixed set of receivers for the whole
//   launch (kSlots at a time, in several passes when N exceeds the grid's
//   reach); their position, velocity (and acceleration) live in its shared
//   memory, and the weights (charge or mass) are staged once when N fits one
//   tile. The kick of step s and the drift of step s + 1 are fused in the
//   owning block, so only the new positions leave the SM.
// - One exchange per micro-step, fused with the wait (NCCL's "LL"
//   protocol), in place of a grid barrier and a full restage. The owner
//   publishes each new position component as an 8-byte word {float bits,
//   step}, with one aligned 64-bit store (single-copy atomic; a 16-byte
//   {x, y, z, step} vector store is not promised to be), into one of two
//   buffers chosen by the step's parity. Consumers stage the senders into
//   shared memory by polling those words until the tag is the step, all
//   words of a thread at once (waiting on one word, then the next, would
//   cost a round trip each).
//   The parity buffer is safe to reuse: a block writes step s + 2 only
//   after it has read every position of step s + 1 (every block owns at
//   least one receiver, so that includes a word from every block), and every
//   block wrote its last word of step s + 1 only after it had read all of
//   step s. So no block still reads step s when its buffer is overwritten.
//   Tags start at 1; each block first clears its own words, and the
//   launch's one grid.sync() orders that before the first publish. Every
//   spin is bounded (kSpinCycles) and ends in __trap(): a protocol fault
//   surfaces as a launch error at the next synchronize, not as a hang.
// - More threads per receiver: kBodyWarps warps sum one receiver, its
//   senders split over their threads in a fixed interleave (thread t takes
//   j = t, t + kBodyThreads, ... in increasing order), the lanes combined by
//   the xor butterfly and the warps in warp order through shared memory:
//   the sum order of nbody_pair.cuh, which the standalone force kernels
//   share. The order of every sum depends on N alone, never on the grid:
//   the same bits from run to run, as a chain of one-step launches, and as
//   a micro-step whose force comes from nbody_pairwise.cu; no atomics.
//   All N(N-1) pairs are evaluated (no Newton's-third-law halving, which
//   would need scattered sums).
// - Records (charged kernel, optional): the stretch run saves, at the end
//   of each sampling block, the position after the last micro-step's drift
//   and the velocity before its kick. The owners write both to rec_pos and
//   rec_vel between that drift and that kick, so a frame is one launch of
//   `sample_freq` micro-steps, not a block of sample_freq - 1 followed by a
//   drift, a force launch and a kick on the host's stream.
// Tried on the card and dropped (PERF.md): 4 warps a receiver (more warps
// make every barrier phase longer), a double-buffered tile without the
// first barrier, unrolling the pair loop by 8, thread-block clusters
// sharing the staged senders through distributed shared memory (the
// exchange is latency-bound, not L2-bandwidth-bound), and chunks consumed
// as they arrive.
// Positions, velocities and accelerations are [N, 3] row-major fp32.

#include <cooperative_groups.h>

#include "nbody_pair.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nbody;

// kSlots receivers a block a pass, kBlock threads (nbody_pair.cuh), one
// block per SM.
constexpr int kStage = 1024;                     // senders staged a tile
constexpr int kPerThread = kStage / kBlock;      // senders a thread stages
constexpr long long kSpinCycles = 20000000000ll; // about 10 s
static_assert(kStage % kBlock == 0, "the interleave spans tiles");

struct Params {
  const float* pos;
  const float* vel;
  const float* acc;                  // gravity only
  const float* w;                    // charges or masses, [n]
  float* pos_out;
  float* vel_out;
  float* acc_out;                    // gravity only
  unsigned long long* words;         // 2 x [3, n] tagged positions
  int n, steps;
  float dt, half_dt;
  float scale;                       // charged: max_f; gravity: G
  float* rec_pos;                    // charged only, optional: the last
  float* rec_vel;                    // micro-step's drifted position and
};                                   // velocity before its kick

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned tag) {
  const unsigned long long word =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(word) : "l"(p) : "memory");
  return word;
}

// Probes (kProbe > 0): the kernel's launch and micro-steps without the pair
// sums (1), and without waiting for the tags either (2: each word read once)
// or without reading the words at all (3).
enum { kKernel = 0, kNoPairs = 1, kNoWait = 2, kNoLoads = 3 };

// Stage senders base + tid + q kBlock (q < kPerThread) of a tile: poll
// their 3 kPerThread words at once, re-reading only those whose tag is not
// yet `tag`, until all are; then store them to the tile (with the weights
// when `weights`).
template <int kProbe>
__device__ __forceinline__ void stage(float4* tile,
                                      const unsigned long long* in,
                                      size_t plane, int base, int cnt,
                                      unsigned tag, const float* w,
                                      bool weights) {
  const int tid = threadIdx.x;
  unsigned long long word[3 * kPerThread];
#pragma unroll
  for (int k = 0; k < 3 * kPerThread; ++k) {
    const int u = tid + (k / 3) * kBlock;
    word[k] = u < cnt && kProbe != kNoLoads
                  ? peek(in + (k % 3) * plane + base + u)
                  : (unsigned long long)tag << 32;
  }
  long long t0 = -1;
  while (kProbe < kNoWait) {
    bool all = true;
#pragma unroll
    for (int k = 0; k < 3 * kPerThread; ++k) {
      if ((unsigned)(word[k] >> 32) != tag) {
        all = false;
        word[k] = peek(in + (k % 3) * plane + base + tid + (k / 3) * kBlock);
      }
    }
    if (all) break;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > kSpinCycles) __trap();
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int u = tid + q * kBlock;
    if (u < cnt) {
      float4& d = tile[u];
      d.x = __uint_as_float((unsigned)word[3 * q]);
      d.y = __uint_as_float((unsigned)word[3 * q + 1]);
      d.z = __uint_as_float((unsigned)word[3 * q + 2]);
      if (weights) d.w = __ldg(w + base + u);
    }
  }
}

// Receiver of slot r in pass p of this block (may be >= n).
__device__ __forceinline__ int receiver(int p, int r) {
  return (p * (int)gridDim.x + (int)blockIdx.x) * kSlots + r;
}

// Shared memory: the staged tile of senders {x, y, z, weight}, the warps'
// partial sums, then kState floats per owned receiver: position, velocity
// (and acceleration).
template <bool kGravity>
struct Layout {
  static constexpr int kState = kGravity ? 9 : 6;
  static size_t bytes(int passes) {
    return sizeof(float4) * kStage + sizeof(float) * 3 * (kBlock / 32) +
           sizeof(float) * (size_t)passes * kSlots * kState;
  }
};

// One launch: `steps` micro-steps. A probe (kProbe > 0) cuts the pair loop
// out (each thread adds one staged sender instead, so the staging is not
// dead) and keeps the launch, the exchange and the updates.
template <class Law, bool kGravity, int kProbe>
__global__ void __launch_bounds__(kBlock, 1)
leapfrog_kernel(Law law, Params a) {
  constexpr int kState = Layout<kGravity>::kState;
  extern __shared__ float4 smem[];
  float4* tile = smem;                                     // [kStage]
  float* part = reinterpret_cast<float*>(tile + kStage);   // [warps][3]
  float* state = part + 3 * (kBlock / 32);     // [passes][kSlots][kState]

  const int n = a.n;
  const int tid = threadIdx.x;
  const int r = tid / kBodyThreads, t = tid % kBodyThreads;
  const int passes =
      ((n + kSlots - 1) / kSlots + (int)gridDim.x - 1) / (int)gridDim.x;
  const int tiles = (n + kStage - 1) / kStage;
  const bool owner = t < 3;             // component t of slot r's receiver
  const size_t plane = (size_t)n;
  // the words of step s: x, y, z planes of n
  auto words = [&](int s) { return a.words + (size_t)(s & 1) * 3 * plane; };

  // Load the owned state, clear the owned words of both buffers.
  for (int p = 0; p < passes; ++p) {
    const int i = receiver(p, r);
    if (owner && i < n) {
      float* st = state + (p * kSlots + r) * kState;
      const size_t c = 3 * (size_t)i + t;
      st[t] = a.pos[c];
      st[3 + t] = a.vel[c];
      if (kGravity) st[6 + t] = a.acc[c];
      words(0)[t * plane + i] = 0ull;
      words(1)[t * plane + i] = 0ull;
    }
  }
  if (tiles == 1)
    for (int j = tid; j < n; j += kBlock) tile[j].w = a.w[j];
  cg::this_grid().sync();

  // The first drift (gravity: kick, drift), published as step 1.
  for (int p = 0; p < passes; ++p) {
    const int i = receiver(p, r);
    if (owner && i < n) {
      float* st = state + (p * kSlots + r) * kState;
      float v = st[3 + t];
      if (kGravity) {
        v = __fadd_rn(v, __fmul_rn(st[6 + t], a.half_dt));
        st[3 + t] = v;
        st[t] = __fadd_rn(st[t], __fmul_rn(v, a.dt));
      } else {
        st[t] = __fadd_rn(st[t], __fmul_rn(a.dt, v));
      }
      publish(words(1) + t * plane + i, st[t], 1u);
    }
  }

  for (int s = 1; s <= a.steps; ++s) {
    const unsigned long long* in = words(s);
    unsigned long long* out = words(s + 1);
    for (int p = 0; p < passes; ++p) {
      const int i = receiver(p, r);
      float* st = state + (p * kSlots + r) * kState;
      float xi = 0.0f, yi = 0.0f, zi = 0.0f, wi = 0.0f;
      float3 f = make_float3(0.0f, 0.0f, 0.0f);
      for (int k = 0; k < tiles; ++k) {
        const int base = k * kStage;
        const int cnt = min(kStage, n - base);
        __syncthreads();                 // the tile's last readers are done
        stage<kProbe>(tile, in, plane, base, cnt, (unsigned)s, a.w,
                      tiles > 1);
        __syncthreads();
        if (i < n) {
          if (k == 0) {
            xi = st[0];
            yi = st[1];
            zi = st[2];
            wi = __ldg(a.w + i);
          }
          if (kProbe == kKernel) {
            add_senders(law, i, xi, yi, zi, wi, base, cnt, t,
                        [&](int u) { return tile[u]; }, f);
          } else {
            const float4 q = tile[t % cnt];
            f.x += q.x;
            f.y += q.y;
            f.z += q.z;
          }
        }
      }
      warp_partials(f, part);
      __syncthreads();
      if (owner && i < n) {              // combine in warp order, update
        const float tot = receiver_total(part, r, t);
        float v = st[3 + t];
        if (kGravity) {
          const float ac = __fmul_rn(a.scale, tot);
          st[6 + t] = ac;
          v = __fadd_rn(v, __fmul_rn(ac, a.half_dt));       // kick
          if (s < a.steps) {
            v = __fadd_rn(v, __fmul_rn(ac, a.half_dt));     // next kick
            st[t] = __fadd_rn(st[t], __fmul_rn(v, a.dt));   // next drift
          }
        } else {
          if (s == a.steps && a.rec_pos != nullptr) {          // record
            const size_t c = 3 * (size_t)i + t;
            a.rec_pos[c] = st[t];
            a.rec_vel[c] = v;
          }
          v = __fadd_rn(v, __fmul_rn(a.dt, clip(tot, a.scale)));   // kick
          if (s < a.steps)                                   // next drift
            st[t] = __fadd_rn(st[t], __fmul_rn(a.dt, v));
        }
        st[3 + t] = v;
        if (s < a.steps) publish(out + t * plane + i, st[t], (unsigned)s + 1);
      }
    }
  }

  for (int p = 0; p < passes; ++p) {
    const int i = receiver(p, r);
    if (owner && i < n) {
      const float* st = state + (p * kSlots + r) * kState;
      const size_t c = 3 * (size_t)i + t;
      a.pos_out[c] = st[t];
      a.vel_out[c] = st[3 + t];
      if (kGravity) a.acc_out[c] = st[6 + t];
    }
  }
}

struct Shape {
  int blocks, passes;
  size_t smem;
};

// The launch for n bodies: one block per kSlots receivers, no more than the
// card holds resident at once (then each block owns several passes of
// kSlots), with the shared memory that their state takes.
template <bool kGravity>
int leapfrog_shape(const void* kernel, int n, Shape* shape) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = ((long long)n + kSlots - 1) / kSlots;
  long long blocks = want < sms ? want : sms;
  const size_t smem =
      Layout<kGravity>::bytes((int)((want + blocks - 1) / blocks));
  if (smem > (size_t)most) return (int)cudaErrorInvalidValue;  // n too large
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  blocks = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
  shape->blocks = (int)blocks;
  shape->passes = (int)((want + blocks - 1) / blocks);
  shape->smem = Layout<kGravity>::bytes(shape->passes);
  return 0;
}

template <class Law, bool kGravity, int kProbe>
int launch(Law law, Params a, cudaStream_t stream) {
  if (a.n < 1 || a.steps < 1) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)leapfrog_kernel<Law, kGravity, kProbe>;
  Shape shape;
  const int err = leapfrog_shape<kGravity>(kernel, a.n, &shape);
  if (err != 0) return err;
  void* args[] = {&law, &a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      kernel, dim3(shape.blocks), dim3(kBlock), args, shape.smem, stream);
  if (launched != cudaSuccess) {
    cudaGetLastError();                    // clear the refused launch's error
    return (int)launched;
  }
  return (int)cudaGetLastError();
}

// The earlier grid-barrier scheme, kept as a probe so that its split can
// be measured again: 8 receivers to a block of 256 threads; per micro-step
// the drift, one grid.sync() and a restage of every position and charge
// from L2, then a kick by one staged value, with no pair sums. parts: 1 the
// barrier, 2 the restage, 3 both. buf: 2 x [n, 3] floats.
constexpr int kWarps = 8;                // receivers a block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;              // senders staged per pass (16 KB)

struct Tile {
  float x[kTile], y[kTile], z[kTile], w[kTile];
};

__global__ void __launch_bounds__(kThreads)
barrier_probe_kernel(const float* pos_in, const float* __restrict__ vel_in,
                     const float* __restrict__ q, float* pos_out,
                     float* vel_out, float* buf, int n, int steps, float dt,
                     int parts) {
  __shared__ Tile s;
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps, lane = threadIdx.x & 31;
  for (int i = first; i < n; i += stride)
    if (lane < 3) vel_out[3 * (size_t)i + lane] = vel_in[3 * (size_t)i + lane];
  const float* cur = pos_in;
  for (int step = 0; step < steps; ++step) {
    float* next = buf + (size_t)(step & 1) * 3 * n;
    for (int i = first; i < n; i += stride) {
      if (lane < 3) {
        const size_t c = 3 * (size_t)i + lane;
        next[c] = __fadd_rn(__ldcg(cur + c), __fmul_rn(dt, vel_out[c]));
      }
    }
    if (parts & 1) grid.sync();
    cur = next;
    for (int b = blockIdx.x * kWarps; b < n; b += stride) {
      const int i = b + (threadIdx.x >> 5);
      for (int base = 0; (parts & 2) && base < n; base += kTile) {
        const int cnt = min(kTile, n - base);
        __syncthreads();
        for (int t = threadIdx.x; t < cnt; t += kThreads) {
          const size_t j = (size_t)base + t;
          s.x[t] = __ldcg(cur + 3 * j);
          s.y[t] = __ldcg(cur + 3 * j + 1);
          s.z[t] = __ldcg(cur + 3 * j + 2);
          s.w[t] = __ldcg(q + j);
        }
        __syncthreads();
      }
      if (i < n && lane < 3) {
        const size_t c = 3 * (size_t)i + lane;
        const int t = i % min(kTile, n);
        const float f = component(make_float3(s.x[t], s.y[t], s.z[t]), lane);
        vel_out[c] = __fadd_rn(vel_out[c], __fmul_rn(dt, f));
      }
    }
  }
  for (int i = first; i < n; i += stride)
    if (lane < 3) pos_out[3 * (size_t)i + lane] =
        __ldcg(cur + 3 * (size_t)i + lane);
}

int launch_barrier_probe(void** args, int n, cudaStream_t stream) {
  const void* kernel = (const void*)barrier_probe_kernel;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)n + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sms;
  err = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)(want < most ? want : most)), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// pos/vel [n, 3], q [n] in; pos_out/vel_out [n, 3] out; rec_pos/rec_vel
// [n, 3] out or both null (the records of the last micro-step: position
// after its drift, velocity before its kick); words 2 x [3, n] 64-bit
// scratch; all on the device, outputs distinct from inputs.
extern "C" int nbody_charged_leapfrog(const float* pos, const float* vel,
                                      const float* q, float* pos_out,
                                      float* vel_out, float* rec_pos,
                                      float* rec_vel, void* words, int n,
                                      int steps, float dt, float k,
                                      float max_f, void* stream) {
  if (!(max_f > 0.0f) || (rec_pos == nullptr) != (rec_vel == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params a{pos, vel, nullptr, q, pos_out, vel_out, nullptr,
                 (unsigned long long*)words, n, steps, dt, 0.0f, max_f,
                 rec_pos, rec_vel};
  return launch<Charged, false, kKernel>(Charged{k}, a, (cudaStream_t)stream);
}

// pos/vel/acc [n, 3], mass [n] in; three [n, 3] out; words 2 x [3, n].
extern "C" int nbody_gravity_leapfrog(const float* pos, const float* vel,
                                      const float* acc, const float* mass,
                                      float* pos_out, float* vel_out,
                                      float* acc_out, void* words, int n,
                                      int steps, float dt, float half_dt,
                                      float g, float eps2, void* stream) {
  const Params a{pos, vel, acc, mass, pos_out, vel_out, acc_out,
                 (unsigned long long*)words, n, steps, dt, half_dt, g};
  return launch<Gravity, true, kKernel>(Gravity{eps2}, a,
                                       (cudaStream_t)stream);
}

// The launch of a block kernel (gravity != 0: the gravity one) for n bodies
// on the current device: out = {blocks, threads, receivers a pass, warps a
// receiver, passes, dynamic shared bytes}. Returns 0 or a CUDA error code.
extern "C" int nbody_leapfrog_shape(int n, int gravity, int* out) {
  Shape s;
  const int err =
      gravity ? leapfrog_shape<true>(
                    (const void*)leapfrog_kernel<Gravity, true, kKernel>, n,
                    &s)
              : leapfrog_shape<false>(
                    (const void*)leapfrog_kernel<Charged, false, kKernel>, n,
                    &s);
  if (err != 0) return err;
  const int shape[6] = {s.blocks, kBlock, kSlots, kBodyWarps, s.passes,
                        (int)s.smem};
  for (int k = 0; k < 6; ++k) out[k] = shape[k];
  return 0;
}

// The charged kernel's micro-steps without the pair sums, on its arguments
// (k = 1, max_f = 100). scheme 1, 2, 3: this design (kNoPairs, kNoWait,
// kNoLoads); 4, 5, 6: the earlier grid-barrier scheme
// (barrier_probe_kernel's parts 1, 2, 3), which uses the first half of the
// words as its 2 x [n, 3] floats.
extern "C" int nbody_leapfrog_probe(const float* pos, const float* vel,
                                    const float* q, float* pos_out,
                                    float* vel_out, void* words, int n,
                                    int steps, float dt, int scheme,
                                    void* stream) {
  const Params a{pos, vel, nullptr, q, pos_out, vel_out, nullptr,
                 (unsigned long long*)words, n, steps, dt, 0.0f, 100.0f};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (scheme) {
    case 1: return launch<Charged, false, kNoPairs>(Charged{1.0f}, a, st);
    case 2: return launch<Charged, false, kNoWait>(Charged{1.0f}, a, st);
    case 3: return launch<Charged, false, kNoLoads>(Charged{1.0f}, a, st);
    case 4: case 5: case 6: {
      if (n < 1 || steps < 1) return (int)cudaErrorInvalidValue;
      int parts = scheme - 3;
      float* buf = (float*)words;
      void* args[] = {&pos, &vel, &q, &pos_out, &vel_out, &buf, &n, &steps,
                      &dt, &parts};
      return launch_barrier_probe(args, n, st);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
