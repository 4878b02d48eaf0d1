// Backward of the fused EGNN/SEGNO pairwise-message chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel nonode_tpu/ops/pallas/egnn_fused.py:_bwd_kernel
// (launched by _bwd_call through pl.pallas_call). The residuals are the
// layer inputs only: for every edge (i, j) of every graph the kernel
// recomputes the forward chain (pre1, a1, pre2, msg, cpre, ca, cw, f) and
// then runs its vector-Jacobian product:
//   gf     = gtotf[i] * mask[i,j] / deg[i]   (zeroed where |f| > 100 iff clip)
//   dcw    = gf . (x_i - x_j);  drij = gf * cw
//   dcpre  = dcw * wc2 * silu'(cpre)
//   dpre2  = (dcpre @ Wc1^T + gtotm[i] * mask[i,j]) * silu'(pre2)
//   dpre1  = (dpre2 @ W2^T) * silu'(pre1)
//   drij  += 2 (x_i - x_j) (dpre1 . wg)
// and writes the node outputs
//   dx[i]  = sum_j drij[i,j] - sum_j drij[j,i]
//   dhi[i] = sum_j dpre1[i,j];  dhj[j] = sum_i dpre1[i,j]
//   defea[i,j] = dpre1[i,j] @ We^T
// and the nine weight gradients summed over every edge of every graph.
//
// What bounds it on an H100: six H x H products per edge (12 H^2 FLOP, 49
// kFLOP at H = 64) against node-level tensors in and out, so the fp32 CUDA
// cores (67 TFLOP/s), not HBM, set the bound. What the design does about it:
// nothing per edge reaches device memory except defea. One thread computes
// one edge. A block owns whole graphs (five at N = 5), so the sums over
// senders j (dhi, the first half of dx) and over receivers i (dhj, the second
// half) both run inside the block, through shared memory, in a fixed order.
// Larger graphs (N > 11) are walked in tiles of 128 edges and the block adds
// each tile's node sums to its own outputs.
//
// The weight gradients need a sum across blocks, which run in no order. Each
// block writes its partial sums to its own slot of a scratch buffer, and a
// second launch adds the slots in block order. No atomics, so the result does
// not change from run to run. Inside a block, each thread owns a fixed slice
// of every weight gradient and reads the per-edge operands (a1, dpre2, msg,
// dcpre, dpre1) from shared memory in edge order.
//
// Shared memory holds five [128][H + 1] rows of per-edge vectors (166 KB at
// H = 64) plus W2 and Wc1 (32 KB): one block per SM, set with
// cudaFuncAttributeMaxDynamicSharedMemorySize. The pre-activations are kept
// until their SiLU derivative is taken, then overwritten in place by the
// activations the weight products need. Only H = 64, the width of every
// configuration in model_confs.yaml, is instantiated.
//
// The TPU kernel's (8,128) padding, its rows=800 VMEM budget and the weight
// gradients it accumulates across its sequential grid have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // edges per tile, one per thread
constexpr int kWarps = kThreads / 32;
constexpr float kClip = 100.0f;

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }
__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// Layout of one block's partial weight gradients (and of the reduced output):
// dW2 [H][H], dWc1 [H][H], dwg, db1, db2, dbc1, dwc2 [H] each, dwe [E][H], dbc2.
__host__ __device__ constexpr long long partial_floats(int h, int e) {
  return 2LL * h * h + 5LL * h + (long long)e * h + 1;
}

__host__ __device__ inline int graphs_per_block(int n) {
  const int g = kThreads / (n * n);
  return g > 0 ? g : 1;
}

template <int H>
size_t smem_bytes(int n, int e) {
  return sizeof(float) * (size_t)(2 * H * H + 5 * H + e * H + n * n + n +
                                  5 * kThreads * (H + 1) + kThreads * (5 + e) +
                                  kWarps * H);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
egnn_pairwise_bwd_kernel(const float* __restrict__ x, const float* __restrict__ hi,
                         const float* __restrict__ hj, const float* __restrict__ efea,
                         const float* __restrict__ mask, const float* __restrict__ wg,
                         const float* __restrict__ we, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ wc1, const float* __restrict__ bc1,
                         const float* __restrict__ wc2, const float* __restrict__ bc2,
                         const float* __restrict__ gtotf, const float* __restrict__ gtotm,
                         float* __restrict__ dx, float* __restrict__ dhi,
                         float* __restrict__ dhj, float* __restrict__ defea,
                         float* __restrict__ partial, long long num_graphs, int n, int e,
                         int clip_edges) {
  static_assert(kThreads == 2 * H, "each thread owns half a column of dW2 and dWc1");
  constexpr int R = H + 1;                 // padded row: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* s_w2 = smem;                      // [H][H], [in][out]
  float* s_wc1 = s_w2 + H * H;             // [H][H]
  float* s_wg = s_wc1 + H * H;             // [H]
  float* s_b1 = s_wg + H;
  float* s_b2 = s_b1 + H;
  float* s_bc1 = s_b2 + H;
  float* s_wc2 = s_bc1 + H;
  float* s_we = s_wc2 + H;                 // [E][H]
  float* s_mask = s_we + e * H;            // [N][N]
  float* s_deg = s_mask + n * n;           // [N]
  float* s_p1 = s_deg + n;                 // [T][R]: pre1, then a1
  float* s_p2 = s_p1 + kThreads * R;       // [T][R]: pre2, then msg
  float* s_dc = s_p2 + kThreads * R;       // [T][R]: dcpre
  float* s_d2 = s_dc + kThreads * R;       // [T][R]: dpre2
  float* s_d1 = s_d2 + kThreads * R;       // [T][R]: dpre1
  float* s_r2 = s_d1 + kThreads * R;       // [T]
  float* s_dcw = s_r2 + kThreads;          // [T]
  float* s_drij = s_dcw + kThreads;        // [T][3]
  float* s_ef = s_drij + 3 * kThreads;     // [T][E]
  float* s_dwc2 = s_ef + kThreads * e;     // [warps][H]: per-warp sums of ca * dcw

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  __syncthreads();

  const float bias_c2 = __ldg(bc2);
  const int nn = n * n;
  const long long g0 = (long long)blockIdx.x * graphs_per_block(n);
  const long long left = num_graphs - g0;
  const int ng = left < graphs_per_block(n) ? (int)left : graphs_per_block(n);
  const int edges = ng * nn;
  const int tiles = (edges + kThreads - 1) / kThreads;
  const long long np = partial_floats(H, e);
  float* part = partial + (long long)blockIdx.x * np;

  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * kThreads;
    const int cnt = min(kThreads, edges - t0);
    const bool first = t == 0;

    // ---- per edge: recompute the chain and run its backward ----
    {
      // threads past the last edge compute edge 0 and contribute nothing
      const int ge = t0 + tid < edges ? t0 + tid : 0;
      const bool valid = t0 + tid < edges;
      const int gl = ge / nn;
      const int w = ge - gl * nn;
      const int i = w / n;
      const int j = w - i * n;
      const long long node_i = (g0 + gl) * n + i;
      const long long node_j = (g0 + gl) * n + j;
      const long long edge = (g0 + gl) * nn + w;
      const float mij = s_mask[i * n + j];
      const float mw = mij / s_deg[i];

      const float d0 = x[node_i * 3 + 0] - x[node_j * 3 + 0];
      const float d1 = x[node_i * 3 + 1] - x[node_j * 3 + 1];
      const float d2 = x[node_i * 3 + 2] - x[node_j * 3 + 2];
      const float r2 = d0 * d0 + d1 * d1 + d2 * d2;

      float* p1 = s_p1 + tid * R;
      float* p2 = s_p2 + tid * R;
      float* dc = s_dc + tid * R;
      float* dp2 = s_d2 + tid * R;
      float* dp1 = s_d1 + tid * R;
      float acc[H];

      // pre1 = r2 * wg + efea @ we + hi + hj + b1
#pragma unroll
      for (int o = 0; o < H; ++o) acc[o] = r2 * s_wg[o];
      const float* ef = efea + edge * e;
      for (int c = 0; c < e; ++c) {
        const float v = __ldg(ef + c);
        s_ef[tid * e + c] = v;
#pragma unroll
        for (int o = 0; o < H; ++o) acc[o] = fmaf(v, s_we[c * H + o], acc[o]);
      }
      const float4* hi4 = reinterpret_cast<const float4*>(hi + node_i * H);
      const float4* hj4 = reinterpret_cast<const float4*>(hj + node_j * H);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 u = __ldg(hi4 + q);
        const float4 v = __ldg(hj4 + q);
        p1[4 * q + 0] = acc[4 * q + 0] + u.x + v.x + s_b1[4 * q + 0];
        p1[4 * q + 1] = acc[4 * q + 1] + u.y + v.y + s_b1[4 * q + 1];
        p1[4 * q + 2] = acc[4 * q + 2] + u.z + v.z + s_b1[4 * q + 2];
        p1[4 * q + 3] = acc[4 * q + 3] + u.w + v.w + s_b1[4 * q + 3];
      }

      // pre2 = silu(pre1) @ W2 + b2
#pragma unroll
      for (int o = 0; o < H; ++o) acc[o] = s_b2[o];
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float ak = silu(p1[k]);
        const float4* wrow = reinterpret_cast<const float4*>(s_w2 + k * H);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 wv = wrow[q];
          acc[4 * q + 0] = fmaf(ak, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(ak, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(ak, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(ak, wv.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int o = 0; o < H; ++o) p2[o] = acc[o];

      // cpre = silu(pre2) @ Wc1 + bc1
#pragma unroll
      for (int o = 0; o < H; ++o) acc[o] = s_bc1[o];
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float mk = silu(p2[k]);
        const float4* wrow = reinterpret_cast<const float4*>(s_wc1 + k * H);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 wv = wrow[q];
          acc[4 * q + 0] = fmaf(mk, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(mk, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(mk, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(mk, wv.w, acc[4 * q + 3]);
        }
      }

      // cw = silu(cpre) . wc2 + bc2; the force and its gate
      float cw = 0.0f;
#pragma unroll
      for (int o = 0; o < H; ++o) cw = fmaf(silu(acc[o]), s_wc2[o], cw);
      cw += bias_c2;
      float gf0 = __ldg(gtotf + node_i * 3 + 0) * mw;
      float gf1 = __ldg(gtotf + node_i * 3 + 1) * mw;
      float gf2 = __ldg(gtotf + node_i * 3 + 2) * mw;
      if (clip_edges) {   // d clip / d f: 1 inside +-100, 0 outside (and for NaN)
        gf0 *= fabsf(d0 * cw) <= kClip ? 1.0f : 0.0f;
        gf1 *= fabsf(d1 * cw) <= kClip ? 1.0f : 0.0f;
        gf2 *= fabsf(d2 * cw) <= kClip ? 1.0f : 0.0f;
      }
      const float dcw = gf0 * d0 + gf1 * d1 + gf2 * d2;
      float dr0 = gf0 * cw, dr1 = gf1 * cw, dr2v = gf2 * cw;

      // dwc2 (per-warp sums of ca * dcw, fixed butterfly order) and dcpre
#pragma unroll
      for (int o = 0; o < H; ++o) {
        const float z = acc[o];
        const float s = sigmoid(z);
        float v = valid ? z * s * dcw : 0.0f;
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (lane == 0) s_dwc2[warp * H + o] = v;
        acc[o] = dcw * s_wc2[o] * (s * (1.0f + z * (1.0f - s)));
        dc[o] = acc[o];
      }

      // dpre2 = (dcpre @ Wc1^T + gtotm * m) * silu'(pre2); pre2 -> msg
      const float* gm = gtotm + node_i * H;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const float4* wrow = reinterpret_cast<const float4*>(s_wc1 + k * H);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 wv = wrow[q];
          s0 = fmaf(acc[4 * q + 0], wv.x, s0);
          s1 = fmaf(acc[4 * q + 1], wv.y, s1);
          s2 = fmaf(acc[4 * q + 2], wv.z, s2);
          s3 = fmaf(acc[4 * q + 3], wv.w, s3);
        }
        const float dm = ((s0 + s1) + (s2 + s3)) + __ldg(gm + k) * mij;
        const float z = p2[k];
        const float s = sigmoid(z);
        dp2[k] = dm * (s * (1.0f + z * (1.0f - s)));
        p2[k] = z * s;
      }

      // dpre1 = (dpre2 @ W2^T) * silu'(pre1); pre1 -> a1; dr2 = dpre1 . wg
#pragma unroll
      for (int o = 0; o < H; ++o) acc[o] = dp2[o];
      float dr2 = 0.0f;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const float4* wrow = reinterpret_cast<const float4*>(s_w2 + k * H);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 wv = wrow[q];
          s0 = fmaf(acc[4 * q + 0], wv.x, s0);
          s1 = fmaf(acc[4 * q + 1], wv.y, s1);
          s2 = fmaf(acc[4 * q + 2], wv.z, s2);
          s3 = fmaf(acc[4 * q + 3], wv.w, s3);
        }
        const float z = p1[k];
        const float s = sigmoid(z);
        const float dp = ((s0 + s1) + (s2 + s3)) * (s * (1.0f + z * (1.0f - s)));
        dp1[k] = dp;
        p1[k] = z * s;
        dr2 = fmaf(dp, s_wg[k], dr2);
      }
      dr0 += 2.0f * d0 * dr2;
      dr1 += 2.0f * d1 * dr2;
      dr2v += 2.0f * d2 * dr2;
      s_drij[tid * 3 + 0] = dr0;
      s_drij[tid * 3 + 1] = dr1;
      s_drij[tid * 3 + 2] = dr2v;
      s_r2[tid] = r2;
      s_dcw[tid] = valid ? dcw : 0.0f;

      // defea = dpre1 @ We^T
      if (valid) {
        for (int c = 0; c < e; ++c) {
          float s = 0.0f;
#pragma unroll 8
          for (int k = 0; k < H; ++k) s = fmaf(dp1[k], s_we[c * H + k], s);
          defea[edge * e + c] = s;
        }
      }
    }
    __syncthreads();

    // ---- weight gradients over the tile's edges, in edge order ----
    {
      const int o = tid & (H - 1);
      const int half = tid / H;          // this thread's rows: k = 2 r + half
      float a[H / 2];
#pragma unroll
      for (int r = 0; r < H / 2; ++r) a[r] = 0.0f;
      for (int el = 0; el < cnt; ++el) {
        const float dv = s_d2[el * R + o];
        const float* row = s_p1 + el * R + half;
#pragma unroll
        for (int r = 0; r < H / 2; ++r) a[r] = fmaf(row[2 * r], dv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < H / 2; ++r) {
        float* dst = part + (2 * r + half) * H + o;                 // dW2
        *dst = first ? a[r] : *dst + a[r];
        a[r] = 0.0f;
      }
      for (int el = 0; el < cnt; ++el) {
        const float dv = s_dc[el * R + o];
        const float* row = s_p2 + el * R + half;
#pragma unroll
        for (int r = 0; r < H / 2; ++r) a[r] = fmaf(row[2 * r], dv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < H / 2; ++r) {
        float* dst = part + H * H + (2 * r + half) * H + o;         // dWc1
        *dst = first ? a[r] : *dst + a[r];
      }

      float* vec = part + 2 * H * H;     // dwg, db1, db2, dbc1, dwc2, dwe, dbc2
      if (half == 0) {
        float swg = 0.0f, sb1 = 0.0f, sb2 = 0.0f;
        for (int el = 0; el < cnt; ++el) {
          const float dp = s_d1[el * R + o];
          swg = fmaf(s_r2[el], dp, swg);
          sb1 += dp;
          sb2 += s_d2[el * R + o];
        }
        vec[o] = first ? swg : vec[o] + swg;
        vec[H + o] = first ? sb1 : vec[H + o] + sb1;
        vec[2 * H + o] = first ? sb2 : vec[2 * H + o] + sb2;
        for (int c = 0; c < e; ++c) {
          float s = 0.0f;
          for (int el = 0; el < cnt; ++el) s = fmaf(s_ef[el * e + c], s_d1[el * R + o], s);
          float* dst = vec + 5 * H + c * H + o;
          *dst = first ? s : *dst + s;
        }
      } else {
        float sbc1 = 0.0f, swc2 = 0.0f;
        for (int el = 0; el < cnt; ++el) sbc1 += s_dc[el * R + o];
        for (int w = 0; w < kWarps; ++w) swc2 += s_dwc2[w * H + o];
        vec[3 * H + o] = first ? sbc1 : vec[3 * H + o] + sbc1;
        vec[4 * H + o] = first ? swc2 : vec[4 * H + o] + swc2;
        if (o == 0) {
          float s = 0.0f;
          for (int el = 0; el < cnt; ++el) s += s_dcw[el];
          float* dst = vec + 5 * H + e * H;
          *dst = first ? s : *dst + s;
        }
      }
    }

    // ---- node sums: over senders (dhi, dx) and over receivers (dhj, dx) ----
    const int nodes = ng * n;
    for (int q = tid; q < nodes * H; q += kThreads) {
      const int node = q / H;
      const int o = q - node * H;
      const int gl = node / n;
      const int a = node - gl * n;
      const int base_i = gl * nn + a * n - t0;   // edge (a, k) at base_i + k
      const int base_j = gl * nn + a - t0;       // edge (k, a) at base_j + k n
      float si = 0.0f, sj = 0.0f;
      for (int k = 0; k < n; ++k) {
        const int ei = base_i + k;
        if (ei >= 0 && ei < cnt) si += s_d1[ei * R + o];
        const int ej = base_j + k * n;
        if (ej >= 0 && ej < cnt) sj += s_d1[ej * R + o];
      }
      const long long out = (g0 * n + node) * H + o;
      dhi[out] = first ? si : dhi[out] + si;
      dhj[out] = first ? sj : dhj[out] + sj;
    }
    for (int q = tid; q < nodes * 3; q += kThreads) {
      const int node = q / 3;
      const int c = q - node * 3;
      const int gl = node / n;
      const int a = node - gl * n;
      const int base_i = gl * nn + a * n - t0;
      const int base_j = gl * nn + a - t0;
      float si = 0.0f, sj = 0.0f;
      for (int k = 0; k < n; ++k) {
        const int ei = base_i + k;
        if (ei >= 0 && ei < cnt) si += s_drij[ei * 3 + c];
        const int ej = base_j + k * n;
        if (ej >= 0 && ej < cnt) sj += s_drij[ej * 3 + c];
      }
      const long long out = (g0 * n + node) * 3 + c;
      dx[out] = first ? si - sj : dx[out] + (si - sj);
    }
    __syncthreads();   // the tile's rows are rewritten by the next tile
  }
}

// Second pass: out[p] = sum over blocks b, in order, of partial[b][p].
__global__ void egnn_pairwise_bwd_reduce(const float* __restrict__ partial,
                                         float* __restrict__ out, int blocks, long long np) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * np + p];
  out[p] = s;
}

}  // namespace

// Floats of scratch the wrapper allocates for one call: one slot of partial
// weight gradients per block.
extern "C" long long egnn_pairwise_bwd_scratch_floats(long long g, int n, int h, int e) {
  const long long gpb = graphs_per_block(n);
  return (g + gpb - 1) / gpb * partial_floats(h, e);
}

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = both
// kernels launched). Inputs as egnn_pairwise_fwd plus gtotf [G,N,3] and
// gtotm [G,N,H]; outputs dx [G,N,3], dhi/dhj [G,N,H], defea [G,N,N,E] and
// dweights, the flat [2H^2 + 5H + EH + 1] layout above; scratch holds
// egnn_pairwise_bwd_scratch_floats floats. All fp32, contiguous, on the
// current device.
extern "C" int egnn_pairwise_bwd(const float* x, const float* hi, const float* hj,
                                 const float* efea, const float* mask, const float* wg,
                                 const float* we, const float* b1, const float* w2,
                                 const float* b2, const float* wc1, const float* bc1,
                                 const float* wc2, const float* bc2, const float* gtotf,
                                 const float* gtotm, float* dx, float* dhi, float* dhj,
                                 float* defea, float* dweights, float* scratch, long long g,
                                 int n, int h, int e, int clip_edges, void* stream_ptr) {
  if (g <= 0 || n < 1 || n > 64 || h != 64 || e < 1) return (int)cudaErrorInvalidValue;
  constexpr int H = 64;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const size_t smem = smem_bytes<H>(n, e);
  cudaError_t err = cudaFuncSetAttribute(egnn_pairwise_bwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gpb = graphs_per_block(n);
  const long long blocks = (g + gpb - 1) / gpb;
  egnn_pairwise_bwd_kernel<H><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, gtotf, gtotm, dx, dhi,
      dhj, defea, scratch, g, n, e, clip_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long np = partial_floats(H, e);
  egnn_pairwise_bwd_reduce<<<(unsigned)((np + 255) / 256), 256, 0, stream>>>(
      scratch, dweights, (int)blocks, np);
  return (int)cudaGetLastError();
}
