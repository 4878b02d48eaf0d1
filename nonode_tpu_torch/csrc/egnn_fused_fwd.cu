// Forward of the fused EGNN/SEGNO pairwise-message chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel nonode_tpu/ops/pallas/egnn_fused.py:_fwd_kernel
// (launched by _fwd_call through pl.pallas_call). For every edge (i, j) of
// every graph g:
//   pre1 = r2 * wg + hi[i] + hj[j] + efea[i,j] @ we + b1         [H]
//   msg  = silu(silu(pre1) @ W2 + b2)                             [H]
//   cw   = silu(msg @ Wc1 + bc1) . wc2 + bc2                      scalar
//   f    = (x_i - x_j) * cw, clipped to +-100 per edge iff clip_edges
// and for every node i:
//   tot_f[i] = sum_j mask[i,j] f[i,j] / max(sum_j mask[i,j], 1)
//   tot_m[i] = sum_j mask[i,j] msg[i,j]
//
// What bounds it on an H100: two HxH products per edge (4 H^2 = 16 kFLOP at
// H = 64) against only node-level tensors in and out (about 170 bytes per edge
// at N = 5), so the fp32 CUDA cores (67 TFLOP/s), not HBM (3.35 TB/s), set the
// bound. What the design does about it: every per-edge intermediate stays in
// registers or shared memory and only tot_f and tot_m reach device memory;
// W2 and Wc1 sit in shared memory and are read as float4 broadcasts, so the
// inner loops are 4 FFMA per shared load. One thread computes one edge row.
// Only H = 64, the width of every configuration in model_confs.yaml, is
// instantiated; the wrapper refuses any other.
// A block takes whole receiver rows (a node and all N of its senders), so the
// reduction over j runs inside the block, through shared memory, in a fixed
// order: no atomics, and the result does not change from run to run.
//
// The TPU kernel's (8,128) padding and its rows=1600 VMEM budget have no
// counterpart here; its sequential grid becomes independent blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kClip = 100.0f;

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// NaN-preserving clip, as jnp.clip / torch.clamp.
__device__ __forceinline__ float clip(float v) {
  return v < -kClip ? -kClip : (v > kClip ? kClip : v);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
egnn_pairwise_fwd_kernel(const float* __restrict__ x, const float* __restrict__ hi,
                         const float* __restrict__ hj, const float* __restrict__ efea,
                         const float* __restrict__ mask, const float* __restrict__ wg,
                         const float* __restrict__ we, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ wc1, const float* __restrict__ bc1,
                         const float* __restrict__ wc2, const float* __restrict__ bc2,
                         float* __restrict__ totf, float* __restrict__ totm,
                         long long num_nodes, int n, int e, int clip_edges) {
  extern __shared__ __align__(16) float smem[];
  const int nodes_per_block = kThreads / n;
  const int rows = nodes_per_block * n;
  float* s_w2 = smem;                      // [H][H], [in][out]
  float* s_wc1 = s_w2 + H * H;             // [H][H]
  float* s_wg = s_wc1 + H * H;             // [H]
  float* s_b1 = s_wg + H;                  // [H]
  float* s_b2 = s_b1 + H;                  // [H]
  float* s_bc1 = s_b2 + H;                 // [H]
  float* s_wc2 = s_bc1 + H;                // [H]
  float* s_we = s_wc2 + H;                 // [E][H]
  float* s_mask = s_we + e * H;            // [N][N]
  float* s_deg = s_mask + n * n;           // [N]
  float* s_msg = s_deg + n;                // [rows][H + 1]: activations, then message;
                                           // padded: no bank conflicts
  float* s_f = s_msg + rows * (H + 1);     // [rows][3]

  const int tid = threadIdx.x;
  for (int k = tid; k < H * H; k += kThreads) {
    s_w2[k] = w2[k];
    s_wc1[k] = wc1[k];
  }
  for (int k = tid; k < H; k += kThreads) {
    s_wg[k] = wg[k];
    s_b1[k] = b1[k];
    s_b2[k] = b2[k];
    s_bc1[k] = bc1[k];
    s_wc2[k] = wc2[k];
  }
  for (int k = tid; k < e * H; k += kThreads) s_we[k] = we[k];
  for (int k = tid; k < n * n; k += kThreads) s_mask[k] = mask[k];
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    float d = 0.0f;
    for (int j = 0; j < n; ++j) d += s_mask[i * n + j];
    s_deg[i] = fmaxf(d, 1.0f);
  }

  const long long node0 = (long long)blockIdx.x * nodes_per_block;
  const int r_local = tid / n;             // receiver within the block
  const int j = tid - r_local * n;         // sender
  const long long node = node0 + r_local;  // global receiver index g * N + i
  if (r_local < nodes_per_block && node < num_nodes) {
    const long long g = node / n;
    const int i = (int)(node - g * n);
    const long long sender = g * n + j;
    const float mij = s_mask[i * n + j];

    const float d0 = x[node * 3 + 0] - x[sender * 3 + 0];
    const float d1 = x[node * 3 + 1] - x[sender * 3 + 1];
    const float d2 = x[node * 3 + 2] - x[sender * 3 + 2];
    const float r2 = d0 * d0 + d1 * d1 + d2 * d2;

    // Each thread keeps one H-vector of accumulators in registers; the
    // operand vector of each product (the edge's activations, then its
    // message) lives in the thread's own padded row of s_msg. So the loops
    // over k index shared memory, not registers, and need not be unrolled
    // in full: ptxas builds the kernel in seconds, with half the registers.
    float* row = s_msg + tid * (H + 1);
    float acc[H];

    // first edge layer: silu(r2 * wg + efea @ we + hi + hj + b1)
#pragma unroll
    for (int o = 0; o < H; ++o) acc[o] = r2 * s_wg[o];
    const float* ef = efea + (node * n + j) * e;
    for (int k = 0; k < e; ++k) {
      const float v = __ldg(ef + k);
#pragma unroll
      for (int o = 0; o < H; ++o) acc[o] = fmaf(v, s_we[k * H + o], acc[o]);
    }
    const float4* hi4 = reinterpret_cast<const float4*>(hi + node * H);
    const float4* hj4 = reinterpret_cast<const float4*>(hj + sender * H);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 u = __ldg(hi4 + q);
      const float4 w = __ldg(hj4 + q);
      row[4 * q + 0] = silu(acc[4 * q + 0] + u.x + w.x + s_b1[4 * q + 0]);
      row[4 * q + 1] = silu(acc[4 * q + 1] + u.y + w.y + s_b1[4 * q + 1]);
      row[4 * q + 2] = silu(acc[4 * q + 2] + u.z + w.z + s_b1[4 * q + 2]);
      row[4 * q + 3] = silu(acc[4 * q + 3] + u.w + w.w + s_b1[4 * q + 3]);
    }

    // message: silu(row @ W2 + b2), written back over the row (unmasked:
    // the mask applies in the reduction over j)
#pragma unroll
    for (int o = 0; o < H; ++o) acc[o] = s_b2[o];
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float ak = row[k];
      const float4* wrow = reinterpret_cast<const float4*>(s_w2 + k * H);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 w = wrow[q];
        acc[4 * q + 0] = fmaf(ak, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(ak, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(ak, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(ak, w.w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int o = 0; o < H; ++o) row[o] = silu(acc[o]);

    // coordinate weight: silu(msg @ Wc1 + bc1) . wc2 + bc2
#pragma unroll
    for (int o = 0; o < H; ++o) acc[o] = s_bc1[o];
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float mk = row[k];
      const float4* wrow = reinterpret_cast<const float4*>(s_wc1 + k * H);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 w = wrow[q];
        acc[4 * q + 0] = fmaf(mk, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(mk, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(mk, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(mk, w.w, acc[4 * q + 3]);
      }
    }
    float cw = 0.0f;
#pragma unroll
    for (int o = 0; o < H; ++o) cw = fmaf(silu(acc[o]), s_wc2[o], cw);
    cw += __ldg(bc2);

    float f0 = d0 * cw, f1 = d1 * cw, f2 = d2 * cw;
    if (clip_edges) {
      f0 = clip(f0);
      f1 = clip(f1);
      f2 = clip(f2);
    }
    s_f[tid * 3 + 0] = f0 * mij;
    s_f[tid * 3 + 1] = f1 * mij;
    s_f[tid * 3 + 2] = f2 * mij;
  }
  __syncthreads();

  // reduce over senders j in order 0..N-1
  for (int q = tid; q < nodes_per_block * H; q += kThreads) {
    const int r = q / H;
    const int o = q - r * H;
    const long long nd = node0 + r;
    if (nd < num_nodes) {
      const float* mrow = s_mask + (int)(nd % n) * n;
      float s = 0.0f;
      for (int jj = 0; jj < n; ++jj) s += s_msg[(r * n + jj) * (H + 1) + o] * mrow[jj];
      totm[nd * H + o] = s;
    }
  }
  for (int q = tid; q < nodes_per_block * 3; q += kThreads) {
    const int r = q / 3;
    const int c = q - r * 3;
    const long long nd = node0 + r;
    if (nd < num_nodes) {
      float s = 0.0f;
      for (int jj = 0; jj < n; ++jj) s += s_f[(r * n + jj) * 3 + c];
      totf[nd * 3 + c] = s / s_deg[(int)(nd % n)];
    }
  }
}

template <int H>
cudaError_t launch(const float* x, const float* hi, const float* hj, const float* efea,
                   const float* mask, const float* wg, const float* we, const float* b1,
                   const float* w2, const float* b2, const float* wc1, const float* bc1,
                   const float* wc2, const float* bc2, float* totf, float* totm,
                   long long g, int n, int e, int clip_edges, cudaStream_t stream) {
  const int nodes_per_block = kThreads / n;
  const int rows = nodes_per_block * n;
  const size_t smem = sizeof(float) * (size_t)(2 * H * H + 5 * H + e * H + n * n + n +
                                               rows * (H + 1) + rows * 3);
  cudaError_t err = cudaFuncSetAttribute(egnn_pairwise_fwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long num_nodes = g * n;
  const long long blocks = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  egnn_pairwise_fwd_kernel<H><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf, totm,
      num_nodes, n, e, clip_edges);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = launched).
// Shapes: x [G,N,3], hi/hj [G,N,H], efea [G,N,N,E], mask [N,N], wg/b1/b2/bc1/wc2
// [H], we [E,H], w2/wc1 [H,H] in [in,out] layout, bc2 [1]; outputs totf
// [G,N,3], totm [G,N,H]. All fp32, contiguous, on the current device.
extern "C" int egnn_pairwise_fwd(const float* x, const float* hi, const float* hj,
                                 const float* efea, const float* mask, const float* wg,
                                 const float* we, const float* b1, const float* w2,
                                 const float* b2, const float* wc1, const float* bc1,
                                 const float* wc2, const float* bc2, float* totf,
                                 float* totm, long long g, int n, int h, int e,
                                 int clip_edges, void* stream) {
  if (g <= 0 || n < 1 || n > 64 || h != 64 || e < 1) return (int)cudaErrorInvalidValue;
  return (int)launch<64>(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf,
                         totm, g, n, e, clip_edges, reinterpret_cast<cudaStream_t>(stream));
}
