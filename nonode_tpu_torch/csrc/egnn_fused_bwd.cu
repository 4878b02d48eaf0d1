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
// A launch takes the receivers i in [i0, i0 + ni) of every graph against all
// N senders (a receiver slice: hi, efea, mask, gtotf, gtotm, dhi and defea
// hold the slice's rows; x, hj, dx and dhj all N). dx and dhj then hold this
// slice's contributions to every node, the sender sums over i in the slice
// only; the sums over slices are the full launch's. (0, N) is the whole graph.
//
// What bounds it on an H100: six HxH products per edge (12 H^2 FLOP, 49
// kFLOP at H = 64) against node-level tensors in and out, so operations, not
// HBM, set the bound. Two routes, chosen by the one dispatch with_bwd_route,
// which the scratch size goes through too:
// - H = 64 with E <= 4 (every configuration in model_confs.yaml):
//   egnn_pairwise_bwd_kernel, W2 and Wc1 staged in shared memory (below).
// - Every other width (a multiple of 64, as the wrapper pads it; 128 for
//   mocap's configs/config_mocap_no.json) and any E: the tile route,
//   egnn_pairwise_bwd_tiles, further below.
// What both do about the bound:
// - All six products run on the tensor cores in split TF32 (egnn_tf32.cuh,
//   mma.sync): the recomputed silu(pre1) @ W2 and silu(pre2) @ Wc1; dcpre @
//   Wc1^T and dpre2 @ W2^T, which read the weights in the transposed
//   fragment layout, with no transposed copy at H = 64; and the weight
//   gradients msg^T dcpre (dWc1) and a1^T dpre2 (dW2), products over the
//   tile's edge dimension that read the per-edge tiles column-major. The
//   elementwise work (SiLU and its derivative with expf and IEEE division,
//   the clip gate, the mask), the E columns of efea @ We and dpre1 @ We^T
//   and the vector gradients stay in fp32 on the CUDA cores.
// - The weight gradients need a sum across blocks, which run in no order.
//   Each tile's dW2 and dWc1 are tensor-core products from zero, added in
//   fp32 to the block's sums in its own slot; a second launch adds the slots
//   in block order (one slot per block, not one per tile). No atomics, a
//   static assignment of units to blocks: two runs give the same bits.
// - Masked-out rows (the diagonal) are computed and multiplied by the mask,
//   as the plain version does, so a non-finite row propagates.
// - Seed axis: K weight sets over G = K * B graphs (graph g on set g / B), for
//   seed fleets. The grid is (blocks, K): block (b, s) takes seed s's units b,
//   b + blocks, ... with seed s's weights, and writes slot s * blocks + b; the
//   second launch sums each seed's slots in block order into its own
//   gradients. blocks is the persistent grid of one seed's units, so each
//   seed's units, slots and sums are those of a launch of its B graphs alone:
//   the same bits. With K > 1 the K * blocks blocks run in waves.
//
// The H = 64 route. A unit is floor(128 / (ni N)) whole graphs' slices (at
// least one; five at N = 5), walked in tiles of 128 edge rows (a graph of
// N > 11 spans several; the block adds each tile's node sums to its
// outputs). A graph is never split across blocks, so the sums over senders j
// (dhi, the first half of dx) and over receivers i (dhj, the second half)
// run inside the block through shared memory in a fixed order. Each of the
// 8 warps owns 16 rows of the tile through the per-edge stages, and works
// on the accumulators where it can: pre2 takes b2 there; cpre takes bc1, and
// cw = silu(cpre) . wc2 is summed per row across the 4 lanes that hold it;
// dpre1 takes silu'(pre1), with dpre1 . wg and dpre1 @ We^T summed the same
// way, and writes a1 back over pre1 for dW2. The weight-gradient products,
// which sum over all rows, and the node sums follow block barriers: dWc1
// before dpre1 overwrites dcpre, dW2 after a1 is written. Persistent grid,
// one block of 256 threads an SM: shared memory holds W2 and Wc1 as {big,
// small} pairs (68 KB, staged once per block with cp.async, overlapped with
// the first tile's first layer) and four [128][H + 4] per-edge tiles (139
// KB): pre1, then a1; pre2, then msg; cpre, then dcpre, then dpre1;
// sigmoid(cpre), then dpre2. The vector gradients are summed in per-lane
// registers across all the block's units and written to the slot at the end.
//
// The TPU kernel's (8,128) padding, its rows=800 VMEM budget and the weight
// gradients it accumulates across its sequential grid have no counterpart here.

#include "egnn_wide.cuh"

namespace {

using namespace egnn_tc;

// Layout of one block's partial weight gradients (and of the reduced output):
// dW2 [H][H], dWc1 [H][H], dwg, db1, db2, dbc1, dwc2 [H] each, dwe [E][H], dbc2.
__host__ __device__ constexpr long long partial_floats(int h, int e) {
  return 2LL * h * h + 5LL * h + (long long)e * h + 1;
}

// A block's slot in the scratch buffer: rounded up to 32 floats, so that each
// slot starts 128-byte aligned (the warps add their dW tiles there in float2).
__host__ __device__ constexpr long long slot_floats(int h, int e) {
  return (partial_floats(h, e) + 31) / 32 * 32;
}

// A block of the H = 64 route: its warps, the edge rows of its tiles (16 a
// warp) and its threads.
template <int H>
__host__ __device__ constexpr int warps_of() {
  static_assert(H == 64, "the H = 64 route stages its weights");
  return kWarps;
}
template <int H>
__host__ __device__ constexpr int rows_of() { return 16 * warps_of<H>(); }
template <int H>
__host__ __device__ constexpr int threads_of() { return 32 * warps_of<H>(); }

template <int H>
__host__ __device__ inline int graphs_per_unit(int edges) {   // a graph's edges
  const int g = rows_of<H>() / edges;
  return g > 0 ? g : 1;
}

template <int H>
constexpr size_t smem_floats() {
  constexpr int R = rows_of<H>();
  return 4 * H * padded<H>()           // W2, Wc1: big and small
         + 4 * R * padded<H>()         // four per-edge tiles
         + R * (4 + kMaxE + 1 + 3 + 1 + 1 + 2)   // rij r2, efea, dcw, drij,
                                       // mask, mask / deg, receiver and sender
         + 5 * H + kMaxE * H           // wg, b1, b2, bc1, wc2; we
         + kMaxN;                      // deg
}

// slot[dW] (+)= A^T B over the first 8 ksteps rows of a tile, in split
// TF32: A and B are [R][LD] per-edge tiles, dW [H][H] row-major in the
// block's slot. The warp takes the m16 tile mi of dW's rows and WT n8 tiles
// from column 8 nb0; first writes, otherwise it adds. The tile's product
// starts from zero and is added in fp32: a tensor-core accumulator carried
// over thousands of rows (N = 64, hundreds of graphs a block) drifts past
// the kernels' 1e-4 tolerance, one carried over a tile's 128 rows does not.
template <int H, int WT>
__device__ __forceinline__ void tile_weight_grad(float* dw, const float* a_tile,
                                                 const float* b_tile, int ksteps, int mi,
                                                 int nb0, bool first) {
  constexpr int LD = padded<H>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float pc[WT][4];
#pragma unroll
  for (int j = 0; j < WT; ++j) pc[j][0] = pc[j][1] = pc[j][2] = pc[j][3] = 0.0f;
  // A(m, k) = a_tile[k][m], m = 16 mi + g (+ 8), k = 8 ks + t4 (+ 4);
  // B(k, n) = b_tile[k][n], n = 8 (nb0 + j) + g
  const float* ap = a_tile + t4 * LD + 16 * mi + g;
  const float* bp = b_tile + t4 * LD + 8 * nb0 + g;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = 8 * ks * LD;
    const float a[4] = {ap[k0], ap[k0 + 8], ap[k0 + 4 * LD], ap[k0 + 4 * LD + 8]};
    uint32_t a_big[4], a_small[4];
    split4(a, a_big, a_small);
#pragma unroll
    for (int j = 0; j < WT; j += 2) {
      const float b[4] = {bp[k0 + 8 * j], bp[k0 + 4 * LD + 8 * j], bp[k0 + 8 * j + 8],
                          bp[k0 + 4 * LD + 8 * j + 8]};
      uint32_t b_big[4], b_small[4];
      split4(b, b_big, b_small);
      mma_tf32(pc[j], a_small, b_big[0], b_big[1]);
      mma_tf32(pc[j + 1], a_small, b_big[2], b_big[3]);
      mma_tf32(pc[j], a_big, b_small[0], b_small[1]);
      mma_tf32(pc[j + 1], a_big, b_small[2], b_small[3]);
      mma_tf32(pc[j], a_big, b_big[0], b_big[1]);
      mma_tf32(pc[j + 1], a_big, b_big[2], b_big[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < WT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // rows g and g + 8
      float2* q = reinterpret_cast<float2*>(dw + (16 * mi + g + 8 * h) * H + 8 * (nb0 + j) +
                                            2 * t4);
      float2 v = make_float2(pc[j][2 * h], pc[j][2 * h + 1]);
      if (!first) {
        const float2 o = *q;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *q = v;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(threads_of<H>(), 1)
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
                         float* __restrict__ partial, long long num_graphs, long long units,
                         int n, int e, int clip_edges, int ni, int first_row) {
  // this block's seed: the first of its graphs (num_graphs and units count
  // one seed's) and its weight set, read only while staging (the parameters
  // stay in the constant bank: no pointer is held in registers)
  const long long seed = blockIdx.y;
  const long long seed_g0 = seed * num_graphs;
  constexpr int NW = warps_of<H>();
  constexpr int R = rows_of<H>();                  // edge rows of a tile
  constexpr int T = threads_of<H>();
  constexpr int LD = padded<H>();
  constexpr int CH = H / 4;                        // 4-column chunks of a row
  constexpr int RPI = 32 / CH;                     // rows a warp covers at once
  constexpr int RPL = 16 / RPI;                    // of its 16 rows, those a lane takes
  constexpr int RB = RPL < 8 ? RPL : 8;            // of them, those whose loads fly at once
  constexpr int NT8 = H / 8;                       // n8 tiles along a row of dW
  constexpr int TILES = (H / 16) * NT8 / NW;       // m16 x n8 tiles of dW a warp owns
  constexpr int WT = TILES < NT8 ? TILES : NT8;    // of them, those a pass takes
  constexpr int PASSES = TILES / WT;
  constexpr int WS = H * LD;                       // float2 of a staged weight
  static_assert(CH <= 32 && 32 % CH == 0, "a row's chunks fit in a warp");
  static_assert((H / 16) * NT8 % NW == 0 && TILES % WT == 0 && NT8 % WT == 0 && WT % 2 == 0,
                "a pass's weight-gradient tiles share one m16 row of tiles");
  extern __shared__ __align__(128) float smem[];
  float2* s_w2 = reinterpret_cast<float2*>(smem);  // [H][LD] {big, small}, [in][out]
  float2* s_wc1 = s_w2 + WS;
  float* s_p1 = reinterpret_cast<float*>(s_wc1 + WS);   // [R][LD]: pre1, then a1
  float* s_p2 = s_p1 + R * LD;                     // pre2, then msg
  float* s_x = s_p2 + R * LD;                      // cpre, dcpre, then dpre1
  float* s_y = s_x + R * LD;                       // sigmoid(cpre), then dpre2
  float* s_rij = s_y + R * LD;                     // [R][4]: rij, r2
  float* s_ef = s_rij + R * 4;                     // [R][kMaxE]
  float* s_dcw = s_ef + R * kMaxE;                 // [R]
  float* s_drij = s_dcw + R;                       // [R][3]
  float* s_m = s_drij + R * 3;                     // [R]: mask[i,j]
  float* s_mw = s_m + R;                           // [R]: mask[i,j] / deg[i]
  int2* s_rs = reinterpret_cast<int2*>(s_mw + R);  // receiver, sender (-1: padding)
  float* s_wg = s_mw + 3 * R;                      // [H]
  float* s_b1 = s_wg + H;
  float* s_b2 = s_b1 + H;
  float* s_bc1 = s_b2 + H;
  float* s_wc2 = s_bc1 + H;
  float* s_we = s_wc2 + H;                         // [E][H]
  float* s_deg = s_we + kMaxE * H;                 // [N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage_weights_async<H>(s_w2, s_wc1, w2 + seed * H * H, wc1 + seed * H * H);
  const StagedWeight<H> W2{s_w2};
  const StagedWeight<H> Wc1{s_wc1};
  for (int k = tid; k < H; k += T) {
    s_wg[k] = wg[seed * H + k];
    s_b1[k] = b1[seed * H + k];
    s_b2[k] = b2[seed * H + k];
    s_bc1[k] = bc1[seed * H + k];
    s_wc2[k] = wc2[seed * H + k];
  }
  for (int k = tid; k < e * H; k += T) s_we[k] = we[seed * e * H + k];
  for (int i = tid; i < ni; i += T) {
    float d = 0.0f;
    for (int j = 0; j < n; ++j) d += __ldg(mask + i * n + j);
    s_deg[i] = fmaxf(d, 1.0f);
  }
  __syncthreads();

  // The warp's part of dW2 and dWc1: TILES m16 x n8 tiles, WT a pass, each
  // pass within one m16 row. Each tile's product is added to the block's sums
  // in its own slot of the scratch buffer (the first tile writes them).
  float* part = partial + (seed * gridDim.x + blockIdx.x) * slot_floats(H, e);
  const int g = lane >> 2, t4 = lane & 3;          // the fragments' row and column
  bool first_tile = true;
  // dw (+)= a_tile^T b_tile over the tile's first 8 ksteps rows
  auto weight_grad = [&](float* dw, const float* a_tile, const float* b_tile, int ksteps) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int first_nt = warp * TILES + p * WT;   // m16 tile first_nt / NT8
      tile_weight_grad<H, WT>(dw, a_tile, b_tile, ksteps, first_nt / NT8, first_nt % NT8,
                              first_tile);
    }
  };
  // the vector gradients: each lane sums its 4 columns over its rows
  float v_wg[4], v_b1[4], v_b2[4], v_bc1[4], v_wc2[4], v_we[kMaxE][4];
  float v_bc2 = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v_wg[t] = v_b1[t] = v_b2[t] = v_bc1[t] = v_wc2[t] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxE; ++k) v_we[k][t] = 0.0f;
  }

  const float bias_c2 = __ldg(bc2 + seed);
  const int nn = ni * n;                           // a graph's edges in the slice
  const int gpu = graphs_per_unit<H>(nn);
  const int r0 = warp * 16;                        // the warp's rows of a tile
  const int ch = lane % CH;                        // a lane's chunk in the column passes
  const int sub = lane / CH;                       // and its first row
  const float4* hi4 = reinterpret_cast<const float4*>(hi);
  const float4* hj4 = reinterpret_cast<const float4*>(hj);
  const float4* gtotm4 = reinterpret_cast<const float4*>(gtotm);
  bool staged = false;
#define ROW4(buf, r) (*reinterpret_cast<float4*>((buf) + (r) * LD + 4 * ch))

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const long long left = num_graphs - unit * gpu;
    const int ng = left < gpu ? (int)left : gpu;
    const int edges = ng * nn;
    const int tiles = (edges + R - 1) / R;
    const long long g0 = seed_g0 + unit * gpu;     // the unit's first graph,
    const long long nbase = g0 * n;                // node (x, hj, dx, dhj),
    const long long qbase = g0 * ni;               // receiver (hi, gtot*, dhi)
    const long long ebase = g0 * nn;               // and edge

    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * R;
      const int cnt = min(R, edges - t0);
      const bool first = t == 0;

      // ---- per row, a lane each: receiver, sender, rij, r2, efea, mask ----
      if (lane < 16) {
        const int r = r0 + lane;
        const int ge = t0 + r;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, mij = 0.0f, mw = 0.0f;
        int li = -1, lj = 0;                       // from qbase and nbase; -1: padding
        if (ge < edges) {
          const int gl = ge / nn;
          const int w = ge - gl * nn;
          const int i = w / n;                     // the receiver's slice row
          const int j = w - i * n;
          li = gl * ni + i;
          lj = gl * n + j;
          const float* xi = x + (nbase + gl * n + first_row + i) * 3;
          const float* xj = x + (nbase + lj) * 3;
          d0 = __ldg(xi + 0) - __ldg(xj + 0);
          d1 = __ldg(xi + 1) - __ldg(xj + 1);
          d2 = __ldg(xi + 2) - __ldg(xj + 2);
          mij = __ldg(mask + i * n + j);
          mw = mij / s_deg[i];
          const float* ef = efea + (ebase + ge) * e;
          for (int k = 0; k < e; ++k) s_ef[r * kMaxE + k] = __ldg(ef + k);
        }
        for (int k = ge < edges ? e : 0; k < kMaxE; ++k) s_ef[r * kMaxE + k] = 0.0f;
        s_rij[r * 4 + 0] = d0;
        s_rij[r * 4 + 1] = d1;
        s_rij[r * 4 + 2] = d2;
        s_rij[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
        s_m[r] = mij;
        s_mw[r] = mw;
        s_rs[r] = make_int2(li, lj);
      }
      __syncwarp();

      // ---- pre1 = r2 wg + efea @ we + hi + hj + b1 (padding rows: zeros) ----
#pragma unroll
      for (int m0 = 0; m0 < RPL; m0 += RB) {
        float4 u[RB], w[RB];
#pragma unroll
        for (int m = 0; m < RB; ++m) {             // RB rows' loads in flight at once
          const int2 rs = s_rs[r0 + sub + RPI * (m0 + m)];
          u[m] = w[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (rs.x >= 0) {
            u[m] = __ldg(hi4 + (qbase + rs.x) * CH + ch);
            w[m] = __ldg(hj4 + (nbase + rs.y) * CH + ch);
          }
        }
        const float4 wg4 = reinterpret_cast<const float4*>(s_wg)[ch];
        const float4 b14 = reinterpret_cast<const float4*>(s_b1)[ch];
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          const int r = r0 + sub + RPI * (m0 + m);
          float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (s_rs[r].x >= 0) {
            const float r2 = s_rij[r * 4 + 3];
            float4 acc = make_float4(r2 * wg4.x, r2 * wg4.y, r2 * wg4.z, r2 * wg4.w);
            for (int k = 0; k < e; ++k) {
              const float v = s_ef[r * kMaxE + k];
              const float4 we4 = reinterpret_cast<const float4*>(s_we + k * H)[ch];
              acc.x = fmaf(v, we4.x, acc.x);
              acc.y = fmaf(v, we4.y, acc.y);
              acc.z = fmaf(v, we4.z, acc.z);
              acc.w = fmaf(v, we4.w, acc.w);
            }
            p.x = acc.x + u[m].x + w[m].x + b14.x;
            p.y = acc.y + u[m].y + w[m].y + b14.y;
            p.z = acc.z + u[m].z + w[m].z + b14.z;
            p.w = acc.w + u[m].w + w[m].w + b14.w;
          }
          ROW4(s_p1, r) = p;
        }
      }
      if (!staged) {  // the weights' copy ran under the first layer
        split_weights<H>(s_w2, s_wc1);
        staged = true;
      }
      __syncwarp();

      // ---- pre2 = silu(pre1) @ W2 + b2 ----
      float acc[H / 8][4];
      rows_times_weight<H, false>(acc, s_p1 + r0 * LD, W2, Silu());
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(s_b2 + 8 * nt + 2 * t4);
        acc[nt][0] += bias.x;
        acc[nt][1] += bias.y;
        acc[nt][2] += bias.x;
        acc[nt][3] += bias.y;
      }
      store_rows<H>(s_p2 + r0 * LD, acc);

      // ---- cpre = silu(pre2) @ Wc1 + bc1; cw; the force's gradient ----
      rows_times_weight<H, false>(acc, s_p2 + r0 * LD, Wc1, Silu());
      {
        // z = cpre -> X and sigmoid(z) -> Y; each lane sums silu(z) wc2 over
        // its columns of rows g and g + 8, the row's quad adds the four sums
        // in a fixed butterfly
        float p_lo = 0.0f, p_hi = 0.0f;
        float* x_lo = s_x + (r0 + g) * LD + 2 * t4;
        float* y_lo = s_y + (r0 + g) * LD + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < H / 8; ++nt) {
          const int c = 8 * nt + 2 * t4;
          const float z0 = acc[nt][0] + s_bc1[c], z1 = acc[nt][1] + s_bc1[c + 1];
          const float z2 = acc[nt][2] + s_bc1[c], z3 = acc[nt][3] + s_bc1[c + 1];
          const float q0 = sigmoid(z0), q1 = sigmoid(z1), q2 = sigmoid(z2), q3 = sigmoid(z3);
          p_lo = fmaf(z0 * q0, s_wc2[c], p_lo);
          p_lo = fmaf(z1 * q1, s_wc2[c + 1], p_lo);
          p_hi = fmaf(z2 * q2, s_wc2[c], p_hi);
          p_hi = fmaf(z3 * q3, s_wc2[c + 1], p_hi);
          *reinterpret_cast<float2*>(x_lo + 8 * nt) = make_float2(z0, z1);
          *reinterpret_cast<float2*>(x_lo + 8 * LD + 8 * nt) = make_float2(z2, z3);
          *reinterpret_cast<float2*>(y_lo + 8 * nt) = make_float2(q0, q1);
          *reinterpret_cast<float2*>(y_lo + 8 * LD + 8 * nt) = make_float2(q2, q3);
        }
        p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 1);
        p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 1);
        p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 2);
        p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 2);
        if (t4 < 2) {       // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
          const int r = r0 + g + 8 * t4;
          const float cw = (t4 == 0 ? p_lo : p_hi) + bias_c2;
          float dcw = 0.0f, dr0 = 0.0f, dr1 = 0.0f, dr2 = 0.0f;
          const int li = s_rs[r].x;
          if (li >= 0) {
            const float mw = s_mw[r];
            const float d0 = s_rij[r * 4 + 0], d1 = s_rij[r * 4 + 1], d2 = s_rij[r * 4 + 2];
            float gf0 = __ldg(gtotf + (qbase + li) * 3 + 0) * mw;
            float gf1 = __ldg(gtotf + (qbase + li) * 3 + 1) * mw;
            float gf2 = __ldg(gtotf + (qbase + li) * 3 + 2) * mw;
            if (clip_edges) {   // d clip / d f: 1 inside +-100, 0 outside (and for NaN)
              gf0 *= fabsf(d0 * cw) <= kClip ? 1.0f : 0.0f;
              gf1 *= fabsf(d1 * cw) <= kClip ? 1.0f : 0.0f;
              gf2 *= fabsf(d2 * cw) <= kClip ? 1.0f : 0.0f;
            }
            dcw = gf0 * d0 + gf1 * d1 + gf2 * d2;
            dr0 = gf0 * cw;
            dr1 = gf1 * cw;
            dr2 = gf2 * cw;
          }
          s_dcw[r] = dcw;
          s_drij[r * 3 + 0] = dr0;
          s_drij[r * 3 + 1] = dr1;
          s_drij[r * 3 + 2] = dr2;
        }
      }
      __syncwarp();
      // dcpre = dcw wc2 silu'(cpre); dwc2 += ca dcw, dbc1 += dcpre, dbc2 += dcw
      {
        const float4 wc24 = reinterpret_cast<const float4*>(s_wc2)[ch];
#pragma unroll
        for (int m = 0; m < RPL; ++m) {
          const int r = r0 + sub + RPI * m;
          const float dcw = s_dcw[r];
          float4& xv = ROW4(s_x, r);
          const float4 s = ROW4(s_y, r);
          const float4 z = xv;
          xv.x = dcw * wc24.x * dsilu(z.x, s.x);
          xv.y = dcw * wc24.y * dsilu(z.y, s.y);
          xv.z = dcw * wc24.z * dsilu(z.z, s.z);
          xv.w = dcw * wc24.w * dsilu(z.w, s.w);
          v_wc2[0] = fmaf(z.x * s.x, dcw, v_wc2[0]);
          v_wc2[1] = fmaf(z.y * s.y, dcw, v_wc2[1]);
          v_wc2[2] = fmaf(z.z * s.z, dcw, v_wc2[2]);
          v_wc2[3] = fmaf(z.w * s.w, dcw, v_wc2[3]);
          v_bc1[0] += xv.x;
          v_bc1[1] += xv.y;
          v_bc1[2] += xv.z;
          v_bc1[3] += xv.w;
          if (ch == 0) v_bc2 += dcw;
        }
      }
      __syncwarp();

      // ---- dpre2 = (dcpre @ Wc1^T + gtotm[i] mask[i,j]) silu'(pre2); pre2 -> msg ----
      rows_times_weight<H, true>(acc, s_x + r0 * LD, Wc1, Identity());
      store_rows<H>(s_y + r0 * LD, acc);
#pragma unroll
      for (int m0 = 0; m0 < RPL; m0 += RB) {
        float4 gm[RB];
#pragma unroll
        for (int m = 0; m < RB; ++m) {             // RB rows' loads in flight at once
          const int li = s_rs[r0 + sub + RPI * (m0 + m)].x;
          gm[m] = li >= 0 ? __ldg(gtotm4 + (qbase + li) * CH + ch)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          const int r = r0 + sub + RPI * (m0 + m);
          const bool valid = s_rs[r].x >= 0;
          const float mij = s_m[r];
          float4& yv = ROW4(s_y, r);
          float4& pv = ROW4(s_p2, r);
          const float4 z = pv;
          const float4 s = make_float4(sigmoid(z.x), sigmoid(z.y), sigmoid(z.z), sigmoid(z.w));
          float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (valid) {
            d.x = (yv.x + gm[m].x * mij) * dsilu(z.x, s.x);
            d.y = (yv.y + gm[m].y * mij) * dsilu(z.y, s.y);
            d.z = (yv.z + gm[m].z * mij) * dsilu(z.z, s.z);
            d.w = (yv.w + gm[m].w * mij) * dsilu(z.w, s.w);
          }
          yv = d;
          pv = make_float4(z.x * s.x, z.y * s.y, z.z * s.z, z.w * s.w);
          v_b2[0] += d.x;
          v_b2[1] += d.y;
          v_b2[2] += d.z;
          v_b2[3] += d.w;
        }
      }
      __syncthreads();

      // ---- dWc1 += msg^T dcpre over the tile's rows (padding rows: dcpre 0) ----
      weight_grad(part + H * H, s_p2, s_x, (cnt + 7) / 8);
      __syncthreads();

      // ---- dpre1 = (dpre2 @ W2^T) silu'(pre1); dwg, db1, dwe ----
      rows_times_weight<H, true>(acc, s_y + r0 * LD, W2, Identity());
      {
        // dpre1 on the accumulators (pre1 read at their places, a1 written
        // back over it); dr2 = dpre1 . wg and defea = dpre1 @ We^T summed
        // per row in the quad
        const int r_lo = r0 + g, r_hi = r_lo + 8;
        const bool v_lo = s_rs[r_lo].x >= 0, v_hi = s_rs[r_hi].x >= 0;
        float* z_lo = s_p1 + r_lo * LD + 2 * t4;
        float pw_lo = 0.0f, pw_hi = 0.0f, pe_lo[kMaxE], pe_hi[kMaxE];
#pragma unroll
        for (int m = 0; m < kMaxE; ++m) pe_lo[m] = pe_hi[m] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < H / 8; ++nt) {
          const int c = 8 * nt + 2 * t4;
          float2* zlp = reinterpret_cast<float2*>(z_lo + 8 * nt);
          float2* zhp = reinterpret_cast<float2*>(z_lo + 8 * LD + 8 * nt);
          const float2 zl = *zlp, zh = *zhp;
          const float s0 = sigmoid(zl.x), s1 = sigmoid(zl.y);
          const float s2 = sigmoid(zh.x), s3 = sigmoid(zh.y);
          *zlp = make_float2(zl.x * s0, zl.y * s1);     // pre1 -> a1, for dW2
          *zhp = make_float2(zh.x * s2, zh.y * s3);
          acc[nt][0] = v_lo ? acc[nt][0] * dsilu(zl.x, s0) : 0.0f;
          acc[nt][1] = v_lo ? acc[nt][1] * dsilu(zl.y, s1) : 0.0f;
          acc[nt][2] = v_hi ? acc[nt][2] * dsilu(zh.x, s2) : 0.0f;
          acc[nt][3] = v_hi ? acc[nt][3] * dsilu(zh.y, s3) : 0.0f;
          pw_lo = fmaf(acc[nt][0], s_wg[c], pw_lo);
          pw_lo = fmaf(acc[nt][1], s_wg[c + 1], pw_lo);
          pw_hi = fmaf(acc[nt][2], s_wg[c], pw_hi);
          pw_hi = fmaf(acc[nt][3], s_wg[c + 1], pw_hi);
#pragma unroll
          for (int m = 0; m < kMaxE; ++m) {
            if (m < e) {
              pe_lo[m] = fmaf(acc[nt][0], s_we[m * H + c], pe_lo[m]);
              pe_lo[m] = fmaf(acc[nt][1], s_we[m * H + c + 1], pe_lo[m]);
              pe_hi[m] = fmaf(acc[nt][2], s_we[m * H + c], pe_hi[m]);
              pe_hi[m] = fmaf(acc[nt][3], s_we[m * H + c + 1], pe_hi[m]);
            }
          }
        }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          pw_lo += __shfl_xor_sync(0xffffffffu, pw_lo, x);
          pw_hi += __shfl_xor_sync(0xffffffffu, pw_hi, x);
#pragma unroll
          for (int m = 0; m < kMaxE; ++m) {
            pe_lo[m] += __shfl_xor_sync(0xffffffffu, pe_lo[m], x);
            pe_hi[m] += __shfl_xor_sync(0xffffffffu, pe_hi[m], x);
          }
        }
        if (t4 < 2 && (t4 == 0 ? v_lo : v_hi)) {   // lane t4 = 0: row g; 1: row g + 8
          const int r = t4 == 0 ? r_lo : r_hi;
          const float dr2 = t4 == 0 ? pw_lo : pw_hi;
#pragma unroll
          for (int c = 0; c < 3; ++c) s_drij[r * 3 + c] += 2.0f * s_rij[r * 4 + c] * dr2;
          const long long edge = ebase + t0 + r;
#pragma unroll
          for (int m = 0; m < kMaxE; ++m)
            if (m < e) defea[edge * e + m] = t4 == 0 ? pe_lo[m] : pe_hi[m];
        }
      }
      store_rows<H>(s_x + r0 * LD, acc);
      // dwg, db1, dwe: each lane sums its 4 columns over its rows
#pragma unroll
      for (int m = 0; m < RPL; ++m) {
        const int r = r0 + sub + RPI * m;
        const float r2 = s_rij[r * 4 + 3];
        const float4 d = ROW4(s_x, r);
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v_wg[c] = fmaf(r2, dv[c], v_wg[c]);
          v_b1[c] += dv[c];
#pragma unroll
          for (int k = 0; k < kMaxE; ++k)
            if (k < e) v_we[k][c] = fmaf(s_ef[r * kMaxE + k], dv[c], v_we[k][c]);
        }
      }
      __syncthreads();

      // ---- dW2 += a1^T dpre2 over the tile's rows (padding rows: dpre2 0) ----
      weight_grad(part, s_p1, s_y, (cnt + 7) / 8);
      first_tile = false;

      // ---- node sums: over senders (dhi, dx) of a receiver of the slice,
      // and over the slice's receivers (dhj, dx) of every node ----
      const int nodes = ng * n;
      for (int q = tid; q < nodes * CH; q += T) {
        const int node = q / CH;
        const int c4 = q - node * CH;
        const int gl = node / n;
        const int a = node - gl * n;
        const int ia = a - first_row;              // a's slice row, if it has one
        const bool recv = ia >= 0 && ia < ni;
        const int base_i = gl * nn + ia * n - t0;  // edge (a, k) at base_i + k
        const int base_j = gl * nn + a - t0;       // edge (k, a) at base_j + k n
        float4 si = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sj = si;
        for (int k = 0; recv && k < n; ++k) {
          const int ei = base_i + k;
          if (ei >= 0 && ei < cnt) {
            const float4 v = *reinterpret_cast<const float4*>(s_x + ei * LD + 4 * c4);
            si.x += v.x;
            si.y += v.y;
            si.z += v.z;
            si.w += v.w;
          }
        }
        for (int k = 0; k < ni; ++k) {
          const int ej = base_j + k * n;
          if (ej >= 0 && ej < cnt) {
            const float4 v = *reinterpret_cast<const float4*>(s_x + ej * LD + 4 * c4);
            sj.x += v.x;
            sj.y += v.y;
            sj.z += v.z;
            sj.w += v.w;
          }
        }
        float4* oj = reinterpret_cast<float4*>(dhj + (nbase + node) * H) + c4;
        if (!first) {
          const float4 pj = *oj;
          sj = make_float4(pj.x + sj.x, pj.y + sj.y, pj.z + sj.z, pj.w + sj.w);
        }
        *oj = sj;
        if (recv) {
          float4* oi = reinterpret_cast<float4*>(dhi + (qbase + gl * ni + ia) * H) + c4;
          if (!first) {
            const float4 pi = *oi;
            si = make_float4(pi.x + si.x, pi.y + si.y, pi.z + si.z, pi.w + si.w);
          }
          *oi = si;
        }
      }
      for (int q = tid; q < nodes * 3; q += T) {
        const int node = q / 3;
        const int c = q - node * 3;
        const int gl = node / n;
        const int a = node - gl * n;
        const int ia = a - first_row;
        const bool recv = ia >= 0 && ia < ni;
        const int base_i = gl * nn + ia * n - t0;
        const int base_j = gl * nn + a - t0;
        float si = 0.0f, sj = 0.0f;
        for (int k = 0; recv && k < n; ++k) {
          const int ei = base_i + k;
          if (ei >= 0 && ei < cnt) si += s_drij[ei * 3 + c];
        }
        for (int k = 0; k < ni; ++k) {
          const int ej = base_j + k * n;
          if (ej >= 0 && ej < cnt) sj += s_drij[ej * 3 + c];
        }
        const long long out = (nbase + node) * 3 + c;
        dx[out] = first ? si - sj : dx[out] + (si - sj);
      }
      __syncthreads();   // the next tile rewrites every per-edge tile
    }
  }
#undef ROW4

  // ---- the vector gradients into the block's slot, summed over its lanes ----
  // each (warp, sub) holds the sums of its rows for every column: its own
  // stretch of s_p1 and s_p2, then a fixed-order sum over them
  constexpr int V = (5 + kMaxE) * H + 1;
  constexpr int slots = NW * RPI;
  static_assert(slots * V <= 2 * R * LD, "the vector sums fit in two tiles");
  float* vec = s_p1 + (warp * RPI + sub) * V;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = 4 * ch + t;
    vec[c] = v_wg[t];
    vec[H + c] = v_b1[t];
    vec[2 * H + c] = v_b2[t];
    vec[3 * H + c] = v_bc1[t];
    vec[4 * H + c] = v_wc2[t];
#pragma unroll
    for (int k = 0; k < kMaxE; ++k) vec[(5 + k) * H + c] = v_we[k][t];
  }
  if (ch == 0) vec[(5 + kMaxE) * H] = v_bc2;
  __syncthreads();
  const int nv = (5 + e) * H + 1;                  // dwg .. dwe, dbc2
  for (int p = tid; p < nv; p += T) {
    const int at = p < (5 + e) * H ? p : (5 + kMaxE) * H;
    float s = 0.0f;
    for (int w = 0; w < slots; ++w) s += s_p1[w * V + at];
    part[2 * H * H + p] = s;
  }
}

// Second pass: out[s][p] = sum over blocks b, in order, of seed s's
// partial[s * blocks + b][p]; the grid's y is the seed.
__global__ void egnn_pairwise_bwd_reduce(const float* __restrict__ partial,
                                         float* __restrict__ out, int blocks, long long slot,
                                         long long np) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  const long long seed = blockIdx.y;
  partial += seed * blocks * slot;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * slot + p];
  out[seed * np + p] = s;
}

template <int H>
cudaError_t grid_of(long long g, int n, int ni, int* grid, long long* units) {
  const long long gpu = graphs_per_unit<H>(ni * n);
  *units = (g + gpu - 1) / gpu;
  return persistent_grid(egnn_pairwise_bwd_kernel<H>, sizeof(float) * smem_floats<H>(),
                         *units, 1, threads_of<H>(), grid);
}

template <int H>
cudaError_t launch(const float* x, const float* hi, const float* hj, const float* efea,
                   const float* mask, const float* wg, const float* we, const float* b1,
                   const float* w2, const float* b2, const float* wc1, const float* bc1,
                   const float* wc2, const float* bc2, const float* gtotf, const float* gtotm,
                   float* dx, float* dhi, float* dhj, float* defea, float* dweights,
                   float* scratch, long long g, int n, int e, int k, int clip_edges, int ni,
                   int first_row, cudaStream_t stream) {
  const long long b = g / k;                     // one seed's graphs
  int grid = 0;
  long long units = 0;
  cudaError_t err = grid_of<H>(b, n, ni, &grid, &units);
  if (err != cudaSuccess) return err;
  egnn_pairwise_bwd_kernel<H>
      <<<dim3(grid, k), threads_of<H>(), sizeof(float) * smem_floats<H>(), stream>>>(
          x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, gtotf, gtotm, dx, dhi,
          dhj, defea, scratch, b, units, n, e, clip_edges, ni, first_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long np = partial_floats(H, e);
  egnn_pairwise_bwd_reduce<<<dim3((unsigned)((np + 255) / 256), k), 256, 0, stream>>>(
      scratch, dweights, grid, slot_floats(H, e), np);
  return cudaGetLastError();
}

// ---- the tile route: every (H, E) but H = 64 with E <= kMaxE ----
//
// What held the routes it replaces back, and what this one does instead:
// - Units that fill the card. A unit is one tile: whole graphs where a
//   graph's edges fit a tile (gpt = R / (ni N) of them), else npt = R / N
//   whole receivers of one graph with all their senders, else (N > R) one
//   receiver with R of its senders. At mocap's shape (H = 128, R = 128,
//   N = 31) that is 4 receivers (124 rows) a tile, 8 tiles a graph and 480
//   units for 60 graphs. A graph that spans tiles no longer stays on one
//   block: each tile writes its sums over the tile's receivers (dhj and dx's
//   - sum_i drij[i,j], and with N > R its receiver's partial dhi) to its own
//   record in the scratch buffer, and a launch after it adds each graph's
//   records in tile order (egnn_pairwise_bwd_node_reduce). dhi and defea of
//   a whole receiver stay inside its tile, and a receiver's tiles are cut
//   the same way whatever the slice, so slices side by side give the whole
//   launch's dhi and defea bit for bit.
// - 8 warps a block, one block of 256 threads an SM: each product's units,
//   (m16 row tile, 64-column pass), are spread over the warps, rows fastest,
//   so the warps of one pass read the same weight fragments together.
// - Weights split once a call. egnn_split_weights writes W2 and Wc1 as TF32
//   {big, small} pairs in the order the products read them, once for B(k, n)
//   = W[k][n] and once for the transposed products (B(k, n) = W[n][k]): a
//   lane takes one 16-byte load per (k step, n8 tile) for both halves of b0
//   and b1, with no split and no conversion in the products (32 H^2 bytes a
//   seed: 512 KB at H = 128, 32 MB at H = 1024, read through L1 and L2). The
//   next k step's fragments are loaded under the current one's products;
//   each 64-deep chunk of K starts from zero and the chunks add in fp32.
// - Three per-edge tiles instead of four: X (a1, then cpre, dcpre, dpre1),
//   P1 (pre1, then a1) and P2 (pre2, then dpre2). The first layer writes a1
//   = silu(pre1) to X beside pre1, so pre2's product reads its operand as it
//   is stored; msg = silu(pre2) is taken as cpre's and dWc1's operand is
//   loaded (FastSilu), before dpre2 is written over pre2; sigmoid(cpre) is recomputed
//   where dcpre is formed. R follows H: the largest multiple of 16 up to 128
//   whose tiles and fields fit in shared memory (128 at H = 128, 64 at
//   H = 256, 32 at H = 512, 16 at H = 1024); above H = 1088 (at E = 2) the
//   tiles go to the block's scratch slot, 64 rows, read through the same
//   generic pointers.
// - dW through less global memory. Each tile's dW product starts from zero
//   and each 64-deep chunk of its K (the tile's rows) too, added in fp32 to
//   a running sum that starts from the block's old value (kChainSteps: one
//   MMA chain over K = 512 drifted past the split-TF32 budget). Where the
//   block's slot (dW2, dWc1 and the vector gradients) fits in shared memory
//   beside the tiles (H = 64 at E > 4), it stays there and is written out
//   once; else it is the block's slot in global memory, whose old values for
//   a warp's next unit load under its current one. One seed's slots are
//   capped at kTileScratchFloats (2 GB), which keeps H = 1024 (8.4 MB a
//   slot) on every SM.
// - dr2 = dpre1 . wg and defea = dpre1 @ We^T are summed in dpre1's
//   epilogue over each pass's columns (wg and We staged in shared memory),
//   cw = silu(cpre) . wc2 in cpre's, and a row's pass sums added in order.
//   The column sums (dwc2, dbc1, dwg, db1, db2, dwe) go a thread a column,
//   rows in order; where H < 256, kThreads / H threads share a column and
//   add their sums in order. efea's rows are staged in shared memory.
// The rules of the H = 64 route hold: no atomics, a static assignment of
// units to blocks, block (b, s) runs seed s's units, and the sums keep a
// fixed order, so two runs give the same bits and K seeds those of K
// single-seed launches.

constexpr int kTileMaxRows = 128;

constexpr int kColParts = 4 * kThreads;             // column sums' partials
constexpr long long kTileScratchFloats = 1LL << 29;  // one seed's slots (2 GB)

// Floats of a tile-route block's own shared memory: per row, rij and r2,
// dcw, drij, the mask, mask / deg, receiver, sender, edge, cw's sum over each
// column pass, its E edge features, dpre1's dots with wg and We over each
// column pass; deg; the column sums' partials; wg and We where v_shared.
__host__ __device__ constexpr long long tile_fields(int rows, int h, int e, bool v_shared) {
  return round32((long long)rows * (13 + h / kCols + e + (long long)(h / kCols) * (e + 1)) +
                 kMaxN + kColParts + (v_shared ? (long long)(e + 1) * h : 0));
}

__host__ __device__ constexpr long long tile_floats(int rows, int h) {
  return 3LL * rows * padded_wide(h);
}

// A tile-route launch: its tiles, units and scratch (see the top).
struct TileRoute {
  int rows;            // R: edge rows a tile holds, a multiple of 16
  int tiles_shared;    // the three tiles in shared memory (else the slot's)
  int slot_shared;     // the block's slot in shared memory
  int v_shared;        // wg and We in shared memory (else read from the scratch's copy)
  int gpt;             // graphs a tile (one where a graph spans tiles)
  int npt, spt;        // receivers and senders a tile
  int rtiles, stiles;  // receiver tiles a graph, sender tiles a receiver tile
  long long units;     // tiles of one seed
  long long rec;       // floats of a tile's node record (0: no graph spans tiles)
  long long stride;    // floats of scratch a block: its slot, then its tiles
  int grid;            // blocks a seed
};

// A tile's node record: dhj's partial [N][H], dx's [N][4], dhi's [H].
inline long long record_floats(int n, int h) { return (long long)n * h + 4LL * n + h; }

inline size_t tile_smem(const TileRoute& t, int h, int e) {
  return sizeof(float) * (tile_fields(t.rows, h, e, t.v_shared) +
                          (t.tiles_shared ? tile_floats(t.rows, h) : 0) +
                          (t.slot_shared ? slot_floats(h, e) : 0));
}

// W2 and Wc1 of one seed as {big, small} fragments: per weight, the order
// for B(k, n) = W[k][n] and for B(k, n) = W[n][k], each (H / 8)^2 x 32
// float4: lane l's {b0 big, b0 small, b1 big, b1 small} of (k step ks, n8
// tile nt) at (nt * H / 8 + ks) * 32 + l (egnn_tf32.cuh's fragment layout);
// and wg over We, [E + 1][H], for the blocks that cannot stage them.
__global__ void egnn_split_weights(const float* __restrict__ w2, const float* __restrict__ wc1,
                                   const float* __restrict__ wg, const float* __restrict__ we,
                                   float4* __restrict__ out, float* __restrict__ vstack, int h,
                                   int e) {
  const long long per = (long long)h * h / 2;      // float4 of one order
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long seed = blockIdx.y;
  const long long nv = (long long)(e + 1) * h;
  if (p >= 4 * per) {
    const long long q = p - 4 * per;
    if (q < nv) vstack[seed * nv + q] = q < h ? wg[seed * h + q] : we[seed * e * h + q - h];
    return;
  }
  const int which = (int)(p / per);                // W2, W2^T, Wc1, Wc1^T
  const long long f = p - which * per;
  const int lane = (int)(f & 31);
  const long long blk = f >> 5;
  const int hk = h / 8;
  const int nt = (int)(blk / hk), ks = (int)(blk - (long long)nt * hk);
  const int k = 8 * ks + (lane & 3), col = 8 * nt + (lane >> 2);
  const float* w = (which < 2 ? w2 : wc1) + seed * h * h;
  const bool transposed = which & 1;
  const float v0 = transposed ? w[(long long)col * h + k] : w[(long long)k * h + col];
  const float v1 = transposed ? w[(long long)col * h + k + 4] : w[(long long)(k + 4) * h + col];
  const float b0 = to_tf32(v0), b1 = to_tf32(v1);
  out[seed * 4 * per + p] = make_float4(b0, to_tf32(v0 - b0), b1, to_tf32(v1 - b1));
}

// acc = op(A) @ B[:, 8 nt0 .. 8 nt0 + kCols) in split TF32: A the warp's 16
// rows at `a` (stride lda; shared or global), K = 8 hk, B from the split
// fragments `frags` of one order. Each 64-deep chunk of K starts from zero
// and the chunks add in fp32; the next k step's fragments load under this
// one's products. op is applied to each A element as it is loaded.
template <class Act>
__device__ __forceinline__ void rows_times_frags(float (&acc)[kCols / 8][4], const float* a,
                                                 int lda, const float4* __restrict__ frags,
                                                 int hk, int nt0, Act op) {
  constexpr int NT = kCols / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const float* a_lo = a + g * lda + t;
  const float* a_hi = a_lo + 8 * lda;
  const long long step = (long long)hk * 32;       // float4 from one n8 tile to the next
  const float4* bp = frags + nt0 * step + lane;
  float4 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(bp + nt * step);
  for (int k0 = 0; k0 < hk; k0 += kChainSteps) {
    float part[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kChainSteps; ++kk) {
      const int ks = k0 + kk;
      const int kn = min(ks + 1, hk - 1);
      float4 bn[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bn[nt] = __ldg(bp + nt * step + kn * 32);
      const float av[4] = {op(a_lo[8 * ks]), op(a_hi[8 * ks]), op(a_lo[8 * ks + 4]),
                           op(a_hi[8 * ks + 4])};
      uint32_t a_big[4], a_small[4];
      split4(av, a_big, a_small);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3(part[nt], a_big, a_small, make_float2(b[nt].x, b[nt].y),
             make_float2(b[nt].z, b[nt].w));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) b[nt] = bn[nt];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
  }
}

// dw[m][n] (+)= sum over the rows k < 8 ksteps of op(A[k][m]) B[k][n] in
// split TF32 for every m, n < h: A and B per-edge tiles (stride ld), dw
// [h][h] row-major (shared or global). The units, (m16 tile mi of dw's rows,
// 64 columns from n0), go to the warps in turn. Each 64-row chunk's product
// starts from zero and is added in fp32 to a running sum that starts from
// dw's old values (zero where first), which load under the previous unit's
// products.
template <class Act>
__device__ __forceinline__ void tile_dw(float* dw, int h, const float* a_tile,
                                        const float* b_tile, int ld, int ksteps, bool first,
                                        Act op) {
  constexpr int WT = kCols / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ht = h / 16;
  const int units = ht * (h / kCols);
  // this lane's first element of unit u (row g, columns 2 t4, + 1), and its
  // float2 of row g + 8 hh, n8 tile j
  auto base = [&](int u) {
    return dw + (long long)(16 * (u % ht) + g) * h + (u / ht) * kCols + 2 * t4;
  };
  auto at = [&](float* b, int j, int hh) {
    return reinterpret_cast<float2*>(b + 8 * hh * h + 8 * j);
  };
  float2 run[WT][2];                     // the running sum of the current unit
  int u = threadIdx.x >> 5;
  float* cur = base(u);
#pragma unroll
  for (int j = 0; j < WT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      run[j][hh] = first || u >= units ? make_float2(0.0f, 0.0f) : *at(cur, j, hh);
  for (; u < units; u += kWarps) {
    const int un = u + kWarps;
    float* nxt = base(un);
    float2 next[WT][2];
#pragma unroll
    for (int j = 0; j < WT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        next[j][hh] = first || un >= units ? make_float2(0.0f, 0.0f) : *at(nxt, j, hh);
    // A(m, k) = a_tile[k][m], m = 16 mi + g (+ 8), k = 8 ks + t4 (+ 4);
    // B(k, n) = b_tile[k][n], n = n0 + 8 j + g
    const float* ap = a_tile + t4 * ld + 16 * (u % ht) + g;
    const float* bp = b_tile + t4 * ld + (u / ht) * kCols + g;
    for (int k0 = 0; k0 < ksteps; k0 += kChainSteps) {
      float pc[WT][4];
#pragma unroll
      for (int j = 0; j < WT; ++j) pc[j][0] = pc[j][1] = pc[j][2] = pc[j][3] = 0.0f;
      const int k1 = min(ksteps, k0 + kChainSteps);
#pragma unroll 2
      for (int ks = k0; ks < k1; ++ks) {
        const int r0 = 8 * ks * ld;
        const float a[4] = {op(ap[r0]), op(ap[r0 + 8]), op(ap[r0 + 4 * ld]),
                            op(ap[r0 + 4 * ld + 8])};
        uint32_t a_big[4], a_small[4];
        split4(a, a_big, a_small);
#pragma unroll
        for (int j = 0; j < WT; j += 2) {
          const float bv[4] = {bp[r0 + 8 * j], bp[r0 + 4 * ld + 8 * j], bp[r0 + 8 * j + 8],
                               bp[r0 + 4 * ld + 8 * j + 8]};
          uint32_t b_big[4], b_small[4];
          split4(bv, b_big, b_small);
          mma_tf32(pc[j], a_small, b_big[0], b_big[1]);
          mma_tf32(pc[j + 1], a_small, b_big[2], b_big[3]);
          mma_tf32(pc[j], a_big, b_small[0], b_small[1]);
          mma_tf32(pc[j + 1], a_big, b_small[2], b_small[3]);
          mma_tf32(pc[j], a_big, b_big[0], b_big[1]);
          mma_tf32(pc[j + 1], a_big, b_big[2], b_big[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < WT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          run[j][hh].x += pc[j][2 * hh];
          run[j][hh].y += pc[j][2 * hh + 1];
        }
    }
#pragma unroll
    for (int j = 0; j < WT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *at(cur, j, hh) = run[j][hh];
        run[j][hh] = next[j][hh];
      }
    cur = nxt;
  }
}

// v (+)= s at a slot the calling thread alone owns.
__device__ __forceinline__ void add_to(float* v, float s, bool first) {
  *v = first ? s : *v + s;
}

// out[s][c] (+)= sum over rows r < rows of the terms f(r, c, sums) adds into
// sums[s], for every column c < h and the first ns of S sums. A thread a
// column, rows in order; where h < kThreads, tpc = kThreads / h threads
// share a column, thread group q taking rows q, q + tpc, ..., and their sums
// are added in group order through s_col. Every thread of the block calls it.
template <int S, class F>
__device__ __forceinline__ void column_sums(float* const (&out)[S], int ns, int h, int rows,
                                            float* s_col, bool first, F f) {
  const int tpc = h < kThreads ? kThreads / h : 1;
  if (tpc == 1) {
    for (int c = threadIdx.x; c < h; c += kThreads) {
      float sums[S] = {};
#pragma unroll 4
      for (int r = 0; r < rows; ++r) f(r, c, sums);
#pragma unroll
      for (int s = 0; s < S; ++s)            // unrolled: sums stays in registers
        if (s < ns) add_to(out[s] + c, sums[s], first);
    }
    return;
  }
  const int grp = threadIdx.x / h, c = threadIdx.x - grp * h;
  if (grp < tpc) {
    float sums[S] = {};
#pragma unroll 4
    for (int r = grp; r < rows; r += tpc) f(r, c, sums);
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < ns) s_col[(s * tpc + grp) * h + c] = sums[s];
  }
  __syncthreads();
  if (grp == 0) {
    for (int s = 0; s < ns; ++s) {
      float v = s_col[s * tpc * h + c];
      for (int q = 1; q < tpc; ++q) v += s_col[(s * tpc + q) * h + c];
      add_to(out[s] + c, v, first);
    }
  }
  __syncthreads();
}

// One block of the tile route; see the top. `frags` holds every seed's
// split W2 and Wc1 (egnn_split_weights); `partial` the blocks' slots (and
// their tiles where those leave shared memory, `geo.stride` floats a
// block); `records` each tile's node record where a graph spans tiles.
__global__ void __launch_bounds__(kThreads, 1)
egnn_pairwise_bwd_tiles(const float* __restrict__ x, const float* __restrict__ hi,
                        const float* __restrict__ hj, const float* __restrict__ efea,
                        const float* __restrict__ mask, const float* __restrict__ wg,
                        const float* __restrict__ we, const float* __restrict__ b1,
                        const float4* __restrict__ frags, const float* __restrict__ b2,
                        const float* __restrict__ bc1, const float* __restrict__ wc2,
                        const float* __restrict__ bc2, const float* __restrict__ gtotf,
                        const float* __restrict__ gtotm, float* __restrict__ dx,
                        float* __restrict__ dhi, float* __restrict__ dhj,
                        float* __restrict__ defea, float* __restrict__ partial,
                        float* __restrict__ records, const float* __restrict__ vstack,
                        const TileRoute geo, long long num_graphs, int n, int h, int e,
                        int clip_edges, int ni, int first_row) {
  const long long seed = blockIdx.y;
  const int R = geo.rows;
  const int LD = padded_wide(h);
  const int CH = h / 4;                    // 4-column chunks of a row
  const int NC = h / kCols;                // column passes of a product
  const int HK = h / 8;                    // k steps of a product over H
  extern __shared__ __align__(128) float smem[];
  float* s_rij = smem;                     // [R][4]: rij, r2
  float* s_dcw = s_rij + 4 * R;            // [R]
  float* s_drij = s_dcw + R;               // [R][3]
  float* s_m = s_drij + 3 * R;             // [R]: mask[i,j]
  float* s_mw = s_m + R;                   // [R]: mask[i,j] / deg[i]
  int* s_li = reinterpret_cast<int*>(s_mw + R);   // [R]: receiver (-1: padding),
  int* s_lj = s_li + R;                    // sender and edge, from the tile's
  int* s_le = s_lj + R;                    // first graph
  float* s_cw = reinterpret_cast<float*>(s_le + R);   // [R][NC]: cw's pass sums
  float* s_ef = s_cw + R * NC;             // [R][E]: efea
  float* s_dp = s_ef + R * e;              // [R][NC][E + 1]: dpre1 . wg, We
  float* s_deg = s_dp + R * NC * (e + 1);  // [kMaxN]
  float* s_col = s_deg + kMaxN;            // [kColParts]
  float* s_v = s_col + kColParts;          // [E + 1][H]: wg, We (where v_shared)
  float* own = smem + tile_fields(R, h, e, geo.v_shared);
  const float* vsrc = geo.v_shared ? s_v : vstack + seed * (e + 1) * h;
  // the block's slot: dW2, dWc1, dwg, db1, db2, dbc1, dwc2, dwe, dbc2
  // (partial_floats), then its tiles when they are not in shared memory
  float* slot_g = partial + (seed * gridDim.x + blockIdx.x) * geo.stride;
  float* P1 = geo.tiles_shared ? own : slot_g + slot_floats(h, e);   // pre1, then a1
  float* P2 = P1 + R * LD;                 // pre2, then dpre2
  float* X = P2 + R * LD;                  // a1, cpre, dcpre, then dpre1
  float* slot = geo.slot_shared ? own + tile_floats(R, h) : slot_g;
  float* p_dw2 = slot;
  float* p_dwc1 = p_dw2 + (long long)h * h;
  float* p_wg = p_dwc1 + (long long)h * h;
  float* p_b1 = p_wg + h;
  float* p_b2 = p_b1 + h;
  float* p_bc1 = p_b2 + h;
  float* p_wc2 = p_bc1 + h;
  float* p_we = p_wc2 + h;
  float* p_bc2 = p_we + (long long)e * h;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long hh4 = (long long)h * h / 2;      // float4 of one fragment order
  const float4* f_w2 = frags + seed * 4 * hh4;
  const float4* f_w2t = f_w2 + hh4;
  const float4* f_wc1 = f_w2t + hh4;
  const float4* f_wc1t = f_wc1 + hh4;
  const float* Wg = wg + seed * h;
  const float* B1 = b1 + seed * h;
  const float* We = we + seed * e * h;
  const float* B2 = b2 + seed * h;
  const float* Bc1 = bc1 + seed * h;
  const float* Wc2 = wc2 + seed * h;
  for (int i = tid; i < ni; i += kThreads) {
    float d = 0.0f;
    for (int j = 0; j < n; ++j) d += __ldg(mask + i * n + j);
    s_deg[i] = fmaxf(d, 1.0f);
  }
  for (int k = tid; geo.v_shared && k < (e + 1) * h; k += kThreads)
    s_v[k] = k < h ? Wg[k] : We[k - h];
  __syncthreads();
  const float bias_c2 = __ldg(bc2 + seed);
  const int nn = ni * n;                   // a graph's edges in the slice
  const int tpg = geo.rtiles * geo.stiles; // tiles a graph
  const int g = lane >> 2, t4 = lane & 3;  // the fragments' row and column pair
  const float4* hi4 = reinterpret_cast<const float4*>(hi);
  const float4* hj4 = reinterpret_cast<const float4*>(hj);
  bool first_tile = true;                  // the block's first: it writes its slot

  for (long long unit = blockIdx.x; unit < geo.units; unit += gridDim.x) {
    // the tile: ng graphs from gfirst, receivers [ia, ib) and senders [ja, jb)
    // of each (a graph's tiles in receiver-tile, then sender-tile order)
    long long gfirst;
    int ng, ia = 0, ib = ni, ja = 0, jb = n;
    if (tpg == 1) {
      gfirst = unit * geo.gpt;
      ng = (int)min((long long)geo.gpt, num_graphs - gfirst);
    } else {
      gfirst = unit / tpg;
      ng = 1;
      const int q = (int)(unit - gfirst * tpg);
      const int rt = q / geo.stiles, st = q - rt * geo.stiles;
      ia = rt * geo.npt;
      ib = min(ni, ia + geo.npt);
      ja = st * geo.spt;
      jb = min(n, ja + geo.spt);
    }
    const int ws = jb - ja;                // senders a row of the tile
    const int rpg = (ib - ia) * ws;        // rows a graph
    const int cnt = ng * rpg;
    const int mt = (cnt + 15) / 16;        // m16 row tiles in use
    const int used = 16 * mt;
    const int units = mt * NC;             // of a product: (m16 tile, column pass)
    const int ksteps = (cnt + 7) / 8;      // of the weight gradients' row sums
    const long long g0 = seed * num_graphs + gfirst;
    const long long nbase = g0 * n;        // node (x, hj, dx, dhj),
    const long long qbase = g0 * ni;       // receiver (hi, gtot*, dhi)
    const long long ebase = g0 * nn;       // and edge of the tile's first graph

    // ---- per row, a thread each: receiver, sender, edge, rij, r2, mask ----
    for (int r = tid; r < used; r += kThreads) {
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, mij = 0.0f, mw = 0.0f;
      int li = -1, lj = 0, le = 0;
      if (r < cnt) {
        const int gl = r / rpg;
        const int w = r - gl * rpg;
        const int i = ia + w / ws;         // the receiver's slice row
        const int j = ja + w % ws;
        li = gl * ni + i;
        lj = gl * n + j;
        le = li * n + j;
        const float* xi = x + (nbase + gl * n + first_row + i) * 3;
        const float* xj = x + (nbase + lj) * 3;
        d0 = __ldg(xi + 0) - __ldg(xj + 0);
        d1 = __ldg(xi + 1) - __ldg(xj + 1);
        d2 = __ldg(xi + 2) - __ldg(xj + 2);
        mij = __ldg(mask + i * n + j);
        mw = mij / s_deg[i];
      }
      s_rij[r * 4 + 0] = d0;
      s_rij[r * 4 + 1] = d1;
      s_rij[r * 4 + 2] = d2;
      s_rij[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
      s_m[r] = mij;
      s_mw[r] = mw;
      s_li[r] = li;
      s_lj[r] = lj;
      s_le[r] = le;
      for (int k = 0; k < e; ++k) s_ef[r * e + k] = li >= 0 ? __ldg(efea + (ebase + le) * e + k)
                                                            : 0.0f;
    }
    __syncthreads();

    // ---- pre1 = r2 wg + efea @ we + hi + hj + b1 -> P1, a1 = silu(pre1) -> X
    // (padding rows: zeros) ----
    for (int q = tid; q < used * CH; q += kThreads) {
      const int r = q / CH;
      const int c = 4 * (q - r * CH);
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (s_li[r] >= 0) {
        const float4 u = __ldg(hi4 + (qbase + s_li[r]) * CH + c / 4);
        const float4 w = __ldg(hj4 + (nbase + s_lj[r]) * CH + c / 4);
        const float r2 = s_rij[r * 4 + 3];
#pragma unroll
        for (int t = 0; t < 4; ++t) p[t] = r2 * __ldg(Wg + c + t);
        for (int k = 0; k < e; ++k) {
          const float v = s_ef[r * e + k];
#pragma unroll
          for (int t = 0; t < 4; ++t) p[t] = fmaf(v, __ldg(We + k * h + c + t), p[t]);
        }
        p[0] += u.x + w.x + __ldg(B1 + c);
        p[1] += u.y + w.y + __ldg(B1 + c + 1);
        p[2] += u.z + w.z + __ldg(B1 + c + 2);
        p[3] += u.w + w.w + __ldg(B1 + c + 3);
      }
      *reinterpret_cast<float4*>(P1 + r * LD + c) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(X + r * LD + c) =
          make_float4(silu(p[0]), silu(p[1]), silu(p[2]), silu(p[3]));
    }
    __syncthreads();

    // ---- pre2 = a1 @ W2 + b2 -> P2 ----
    for (int u = warp; u < units; u += kWarps) {
      const int mi = u % mt, nc = u / mt, c0 = nc * kCols;
      float acc[kCols / 8][4];
      rows_times_frags(acc, X + 16 * mi * LD, LD, f_w2, HK, nc * (kCols / 8), Identity());
      float* lo = P2 + (16 * mi + g) * LD + c0 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int c = c0 + 8 * nt + 2 * t4;
        const float bx = __ldg(B2 + c), by = __ldg(B2 + c + 1);
        *reinterpret_cast<float2*>(lo + 8 * nt) = make_float2(acc[nt][0] + bx, acc[nt][1] + by);
        *reinterpret_cast<float2*>(lo + 8 * LD + 8 * nt) =
            make_float2(acc[nt][2] + bx, acc[nt][3] + by);
      }
    }
    __syncthreads();

    // ---- cpre = silu(pre2) @ Wc1 + bc1 -> X; cw's sum over each pass ----
    for (int u = warp; u < units; u += kWarps) {
      const int mi = u % mt, nc = u / mt, c0 = nc * kCols;
      float acc[kCols / 8][4];
      rows_times_frags(acc, P2 + 16 * mi * LD, LD, f_wc1, HK, nc * (kCols / 8), FastSilu());
      float p_lo = 0.0f, p_hi = 0.0f;
      float* x_lo = X + (16 * mi + g) * LD + c0 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int c = c0 + 8 * nt + 2 * t4;
        const float bx = __ldg(Bc1 + c), by = __ldg(Bc1 + c + 1);
        const float wx = __ldg(Wc2 + c), wy = __ldg(Wc2 + c + 1);
        const float z0 = acc[nt][0] + bx, z1 = acc[nt][1] + by;
        const float z2 = acc[nt][2] + bx, z3 = acc[nt][3] + by;
        p_lo = fmaf(z0 * sigmoid(z0), wx, p_lo);
        p_lo = fmaf(z1 * sigmoid(z1), wy, p_lo);
        p_hi = fmaf(z2 * sigmoid(z2), wx, p_hi);
        p_hi = fmaf(z3 * sigmoid(z3), wy, p_hi);
        *reinterpret_cast<float2*>(x_lo + 8 * nt) = make_float2(z0, z1);
        *reinterpret_cast<float2*>(x_lo + 8 * LD + 8 * nt) = make_float2(z2, z3);
      }
      quad_sum(p_lo, p_hi);
      if (t4 < 2)       // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
        s_cw[(16 * mi + g + 8 * t4) * NC + nc] = t4 == 0 ? p_lo : p_hi;
    }
    __syncthreads();

    // ---- per row: cw, and the force's gradient dcw, drij ----
    for (int r = tid; r < used; r += kThreads) {
      float cw = 0.0f;
      for (int nc = 0; nc < NC; ++nc) cw += s_cw[r * NC + nc];
      cw += bias_c2;
      float dcw = 0.0f, dr0 = 0.0f, dr1 = 0.0f, dr2 = 0.0f;
      const int li = s_li[r];
      if (li >= 0) {
        const float mw = s_mw[r];
        const float d0 = s_rij[r * 4 + 0], d1 = s_rij[r * 4 + 1], d2 = s_rij[r * 4 + 2];
        float gf0 = __ldg(gtotf + (qbase + li) * 3 + 0) * mw;
        float gf1 = __ldg(gtotf + (qbase + li) * 3 + 1) * mw;
        float gf2 = __ldg(gtotf + (qbase + li) * 3 + 2) * mw;
        if (clip_edges) {   // d clip / d f: 1 inside +-100, 0 outside (and for NaN)
          gf0 *= fabsf(d0 * cw) <= kClip ? 1.0f : 0.0f;
          gf1 *= fabsf(d1 * cw) <= kClip ? 1.0f : 0.0f;
          gf2 *= fabsf(d2 * cw) <= kClip ? 1.0f : 0.0f;
        }
        dcw = gf0 * d0 + gf1 * d1 + gf2 * d2;
        dr0 = gf0 * cw;
        dr1 = gf1 * cw;
        dr2 = gf2 * cw;
      }
      s_dcw[r] = dcw;
      s_drij[r * 3 + 0] = dr0;
      s_drij[r * 3 + 1] = dr1;
      s_drij[r * 3 + 2] = dr2;
    }
    __syncthreads();

    // ---- dcpre = dcw wc2 silu'(cpre) -> X (padding rows: dcw 0);
    // dwc2 += ca dcw, dbc1 += dcpre, dbc2 += dcw ----
    {
      float* const out[2] = {p_wc2, p_bc1};
      column_sums<2>(out, 2, h, used, s_col, first_tile, [&](int r, int c, float (&s)[2]) {
        const float z = X[r * LD + c];
        const float q = sigmoid(z), d = s_dcw[r];
        const float dc = d * __ldg(Wc2 + c) * dsilu(z, q);
        X[r * LD + c] = dc;
        s[0] = fmaf(z * q, d, s[0]);
        s[1] += dc;
      });
      if (tid == 0) {
        float s = 0.0f;
        for (int r = 0; r < used; ++r) s += s_dcw[r];
        add_to(p_bc2, s, first_tile);
      }
    }
    __syncthreads();

    // ---- dWc1 += msg^T dcpre over the tile's rows, msg = silu(pre2) taken
    // as P2 is loaded (padding rows: dcpre 0) ----
    tile_dw(p_dwc1, h, P2, X, LD, ksteps, first_tile, FastSilu());
    __syncthreads();

    // ---- dpre2 = (dcpre @ Wc1^T + gtotm[i] mask[i,j]) silu'(pre2) -> P2 ----
    for (int u = warp; u < units; u += kWarps) {
      const int r0 = u % mt * 16, nc = u / mt, c0 = nc * kCols;
      float acc[kCols / 8][4];
      rows_times_frags(acc, X + r0 * LD, LD, f_wc1t, HK, nc * (kCols / 8), Identity());
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {   // rows g and g + 8
        const int r = r0 + g + 8 * hh;
        const int li = s_li[r];
        const float mij = s_m[r];
        const float* gm = gtotm + (qbase + (li >= 0 ? li : 0)) * h;
        float* pr = P2 + r * LD;
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = c0 + 8 * nt + 2 * t4 + cc;
            const float z = pr[c];
            pr[c] = li >= 0
                        ? (acc[nt][2 * hh + cc] + __ldg(gm + c) * mij) * dsilu(z, sigmoid(z))
                        : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // ---- dpre1 = (dpre2 @ W2^T) silu'(pre1) -> X; pre1 -> a1 in P1; dpre1's
    // dots with wg and We over the pass's columns, summed in the quad ----
    for (int u = warp; u < units; u += kWarps) {
      const int mi = u % mt, nc = u / mt, c0 = nc * kCols;
      float acc[kCols / 8][4];
      rows_times_frags(acc, P2 + 16 * mi * LD, LD, f_w2t, HK, nc * (kCols / 8), Identity());
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {       // rows g and g + 8
        const int r = 16 * mi + g + 8 * hh;
        const bool valid = s_li[r] >= 0;
        float* zr = P1 + r * LD;
        float* xr = X + r * LD;
        float d[kCols / 4];                  // this lane's dpre1 of row r
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = c0 + 8 * nt + 2 * t4 + cc;
            const float z = zr[c];
            const float s = sigmoid(z);
            d[2 * nt + cc] = valid ? acc[nt][2 * hh + cc] * dsilu(z, s) : 0.0f;
            xr[c] = d[2 * nt + cc];
            zr[c] = z * s;
          }
        }
        // o = 0: wg, o > 0: We row o - 1; four at a time
        for (int o0 = 0; o0 <= e; o0 += 4) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (o0 + q <= e) {
              const float* v = vsrc + (o0 + q) * h + c0 + 2 * t4;
#pragma unroll
              for (int nt = 0; nt < kCols / 8; ++nt) {
                p[q] = fmaf(d[2 * nt], v[8 * nt], p[q]);
                p[q] = fmaf(d[2 * nt + 1], v[8 * nt + 1], p[q]);
              }
            }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            p[q] += __shfl_xor_sync(0xffffffffu, p[q], 1);
            p[q] += __shfl_xor_sync(0xffffffffu, p[q], 2);
          }
          if (t4 == 0)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (o0 + q <= e) s_dp[(r * NC + nc) * (e + 1) + o0 + q] = p[q];
        }
      }
    }
    __syncthreads();

    // ---- dW2 += a1^T dpre2 over the tile's rows (padding rows: dpre2 0) ----
    tile_dw(p_dw2, h, P1, P2, LD, ksteps, first_tile, Identity());
    // dr2 = dpre1 . wg (into drij) and defea = dpre1 @ We^T: a row's pass sums
    // added in order, a thread each (row, o)
    for (int q = tid; q < cnt * (e + 1); q += kThreads) {
      const int r = q / (e + 1), o = q - r * (e + 1);
      float v = 0.0f;
      for (int nc = 0; nc < NC; ++nc) v += s_dp[(r * NC + nc) * (e + 1) + o];
      if (o == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) s_drij[r * 3 + k] += 2.0f * s_rij[r * 4 + k] * v;
      } else {
        defea[(ebase + s_le[r]) * e + o - 1] = v;
      }
    }
    // dwg += r2 dpre1, db1 += dpre1, db2 += dpre2, dwe += efea dpre1: column
    // sums, four at a time (index -3 .. -1: dwg, db1, db2; k >= 0: dwe[k])
    for (int k0 = -3; k0 < e; k0 += 4) {
      float* const out[4] = {k0 == -3 ? p_wg : p_we + (long long)k0 * h,
                             k0 == -3 ? p_b1 : p_we + (long long)(k0 + 1) * h,
                             k0 == -3 ? p_b2 : p_we + (long long)(k0 + 2) * h,
                             p_we + (long long)(k0 + 3) * h};
      const int ns = min(4, e - k0);
      column_sums<4>(out, ns, h, cnt, s_col, first_tile, [&](int r, int c, float (&s)[4]) {
        const float d = X[r * LD + c];
        const float* ef = s_ef + r * e;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q;
          if (q < ns) {
            if (k == -3)
              s[q] = fmaf(s_rij[r * 4 + 3], d, s[q]);
            else if (k == -2)
              s[q] += d;
            else if (k == -1)
              s[q] += P2[r * LD + c];
            else
              s[q] = fmaf(ef[k], d, s[q]);
          }
        }
      });
    }
    first_tile = false;
    __syncthreads();

    // ---- node sums: over the tile's senders (dhi, dx) of each of its
    // receivers, over its receivers (dhj, dx) of each node; a graph on one
    // tile writes its outputs, else the tile writes its record (and dhi of
    // its whole receivers) ----
    float* rec = tpg > 1 ? records + (seed * geo.units + unit) * geo.rec : nullptr;
    const int nodes = ng * n;
    for (int q = tid; q < nodes * CH; q += kThreads) {
      const int node = q / CH;
      const int c4 = q - node * CH;
      const int gl = node / n;
      const int a = node - gl * n;
      const int ra = a - first_row;              // a's slice row, if it has one
      const bool recv = ra >= ia && ra < ib;
      const int base = gl * rpg;
      float4 si = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sj = si;
      for (int j = 0; recv && j < ws; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(X + (base + (ra - ia) * ws + j) * LD +
                                                          4 * c4);
        si.x += v.x;
        si.y += v.y;
        si.z += v.z;
        si.w += v.w;
      }
      for (int i = 0; a >= ja && a < jb && i < ib - ia; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(X + (base + i * ws + a - ja) * LD +
                                                          4 * c4);
        sj.x += v.x;
        sj.y += v.y;
        sj.z += v.z;
        sj.w += v.w;
      }
      if (rec == nullptr)
        reinterpret_cast<float4*>(dhj + (nbase + node) * h)[c4] = sj;
      else
        reinterpret_cast<float4*>(rec + (long long)a * h)[c4] = sj;
      if (recv) {
        if (geo.stiles == 1)
          reinterpret_cast<float4*>(dhi + (qbase + gl * ni + ra) * h)[c4] = si;
        else
          reinterpret_cast<float4*>(rec + (long long)n * h + 4 * n)[c4] = si;
      }
    }
    for (int q = tid; q < nodes * 3; q += kThreads) {
      const int node = q / 3;
      const int c = q - node * 3;
      const int gl = node / n;
      const int a = node - gl * n;
      const int ra = a - first_row;
      const bool recv = ra >= ia && ra < ib;
      const int base = gl * rpg;
      float si = 0.0f, sj = 0.0f;
      for (int j = 0; recv && j < ws; ++j) si += s_drij[(base + (ra - ia) * ws + j) * 3 + c];
      for (int i = 0; a >= ja && a < jb && i < ib - ia; ++i)
        sj += s_drij[(base + i * ws + a - ja) * 3 + c];
      if (rec == nullptr)
        dx[(nbase + node) * 3 + c] = si - sj;
      else
        rec[(long long)n * h + 4 * a + c] = si - sj;
    }
    __syncthreads();   // the next tile rewrites the fields and the tiles
  }

  // ---- a slot kept in shared memory goes to the block's slot once ----
  if (geo.slot_shared) {
    const long long np = partial_floats(h, e);
    for (long long p = tid; p < np; p += kThreads) slot_g[p] = slot[p];
  }
}

// The node outputs of the graphs that span tiles: each graph's records added
// in tile order; the grid's y is the seed, x runs over one seed's graphs x
// (N x H of dhj, N x 3 of dx, and ni x H of dhi where a receiver spans
// tiles).
__global__ void egnn_pairwise_bwd_node_reduce(const float* __restrict__ records,
                                              float* __restrict__ dx, float* __restrict__ dhi,
                                              float* __restrict__ dhj, long long num_graphs,
                                              int n, int h, int ni, int tpg, int stiles,
                                              long long rec) {
  const long long per = (long long)n * h + 3LL * n + (stiles > 1 ? (long long)ni * h : 0);
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_graphs * per) return;
  const long long graph = blockIdx.y * num_graphs + p / per;
  long long w = p % per;
  const float* base = records + graph * tpg * rec;
  float s = 0.0f;
  if (w < (long long)n * h) {
    for (int t = 0; t < tpg; ++t) s += base[t * rec + w];
    dhj[graph * n * h + w] = s;
    return;
  }
  w -= (long long)n * h;
  if (w < 3LL * n) {
    const int a = (int)(w / 3), c = (int)(w % 3);
    for (int t = 0; t < tpg; ++t) s += base[t * rec + (long long)n * h + 4 * a + c];
    dx[(graph * n + a) * 3 + c] = s;
    return;
  }
  w -= 3LL * n;                                    // a receiver's tiles: its sender tiles
  const int i = (int)(w / h), c = (int)(w % h);
  for (int t = 0; t < stiles; ++t)
    s += base[((long long)i * stiles + t) * rec + (long long)n * h + 4 * n + c];
  dhi[(graph * ni + i) * h + c] = s;
}

// The tile route's launch for B graphs of one seed (see the top).
cudaError_t tile_route(long long b, int n, int h, int e, int ni, TileRoute* out) {
  const int nc = h / kCols;
  *out = TileRoute{};
  // the largest tile whose tiles and fields fit, wg and We staged where they
  // fit too; else the tiles in the block's slot (kGlobalRows, then 16 rows)
  for (int vs = 1; vs >= 0 && out->rows == 0; --vs)
    for (int r = kTileMaxRows; r >= 16; r -= 16) {
      const long long f = tile_fields(r, h, e, vs) + tile_floats(r, h);
      if (sizeof(float) * f <= kSmemBytes) {
        out->rows = r;
        out->tiles_shared = 1;
        out->v_shared = vs;
        out->slot_shared = sizeof(float) * (f + slot_floats(h, e)) <= kSmemBytes;
        break;
      }
    }
  for (int vs = 1; vs >= 0 && out->rows == 0; --vs)
    for (int r : {kGlobalRows, 16})
      if (sizeof(float) * tile_fields(r, h, e, vs) <= kSmemBytes) {
        out->rows = r;
        out->v_shared = vs;
        break;
      }
  if (out->rows == 0) return cudaErrorInvalidValue;
  const int rows = out->rows;
  out->gpt = out->rtiles = out->stiles = 1;
  out->npt = ni;
  out->spt = n;
  if (ni * n <= rows) {                    // whole graphs a tile
    out->gpt = rows / (ni * n);
    out->units = (b + out->gpt - 1) / out->gpt;
  } else if (n <= rows) {                  // whole receivers a tile
    out->npt = rows / n;
    out->rtiles = (ni + out->npt - 1) / out->npt;
    out->units = b * out->rtiles;
  } else {                                 // one receiver, rows senders a tile
    out->npt = 1;
    out->spt = rows;
    out->rtiles = ni;
    out->stiles = (n + rows - 1) / rows;
    out->units = b * ni * out->stiles;
  }
  out->rec = out->rtiles * out->stiles > 1 ? record_floats(n, h) : 0;
  out->stride = slot_floats(h, e) + (out->tiles_shared ? 0 : tile_floats(rows, h));
  cudaError_t err = persistent_grid(egnn_pairwise_bwd_tiles, tile_smem(*out, h, e), out->units,
                                    1, kThreads, &out->grid);
  if (err != cudaSuccess) return err;
  const long long cap = kTileScratchFloats / out->stride;
  if (out->grid > cap) out->grid = cap > 1 ? (int)cap : 1;
  return cudaSuccess;
}

// Floats of a tile-route call's scratch: every seed's split weights and wg
// over We, its blocks' slots, its tiles' records.
inline long long tile_scratch(const TileRoute& t, int h, int e, int k) {
  return (long long)k * (8LL * h * h + round32((long long)(e + 1) * h) + t.grid * t.stride +
                         t.units * t.rec);
}

cudaError_t launch_tiles(const float* x, const float* hi, const float* hj, const float* efea,
                         const float* mask, const float* wg, const float* we, const float* b1,
                         const float* w2, const float* b2, const float* wc1, const float* bc1,
                         const float* wc2, const float* bc2, const float* gtotf,
                         const float* gtotm, float* dx, float* dhi, float* dhj, float* defea,
                         float* dweights, float* scratch, long long g, int n, int h, int e,
                         int k, int clip_edges, int ni, int first_row, cudaStream_t stream) {
  const long long b = g / k;                     // one seed's graphs
  TileRoute t;
  cudaError_t err = tile_route(b, n, h, e, ni, &t);
  if (err != cudaSuccess) return err;
  float4* frags = reinterpret_cast<float4*>(scratch);
  float* vstack = scratch + (long long)k * 8 * h * h;
  float* partial = vstack + (long long)k * round32((long long)(e + 1) * h);
  float* records = partial + (long long)k * t.grid * t.stride;
  // a thread per float4 of one seed's fragments, then per float of wg over We
  const long long nf = 2LL * h * h + (long long)(e + 1) * h;
  egnn_split_weights<<<dim3((unsigned)((nf + 255) / 256), k), 256, 0, stream>>>(
      w2, wc1, wg, we, frags, vstack, h, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  egnn_pairwise_bwd_tiles<<<dim3(t.grid, k), kThreads, tile_smem(t, h, e), stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, frags, b2, bc1, wc2, bc2, gtotf, gtotm, dx, dhi, dhj,
      defea, partial, records, vstack, t, b, n, h, e, clip_edges, ni, first_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long np = partial_floats(h, e);
  egnn_pairwise_bwd_reduce<<<dim3((unsigned)((np + 255) / 256), k), 256, 0, stream>>>(
      partial, dweights, t.grid, t.stride, np);
  err = cudaGetLastError();
  if (err != cudaSuccess || t.rec == 0) return err;
  const long long items = b * ((long long)n * h + 3LL * n + (t.stiles > 1 ? (long long)ni * h : 0));
  egnn_pairwise_bwd_node_reduce<<<dim3((unsigned)((items + 255) / 256), k), 256, 0, stream>>>(
      records, dx, dhi, dhj, b, n, h, ni, t.rtiles * t.stiles, t.stiles, t.rec);
  return cudaGetLastError();
}

// The tile route's tag, for with_bwd_route.
struct Tiles {};

// #2's one dispatch: f(std::integral_constant<int, 64>()) for H = 64 with
// e <= kMaxE (the H = 64 kernel above), f(Tiles()) for every other h and e. The
// entry point and its scratch size both go through it, so a launch and the
// scratch it is given always agree on the route.
template <class F>
inline cudaError_t with_bwd_route(int h, int e, F&& f) {
  if (h == 64 && e <= kMaxE) return f(std::integral_constant<int, 64>());
  return f(Tiles());
}

}  // namespace

// Floats of scratch the wrapper allocates for one call on the current device:
// on the H = 64 route one slot of partial weight gradients per block of the
// launch's grid, for each of the K seeds of G = K * B graphs; on the tile
// route also the split weights and the node records (tile_scratch). On
// receiver slices of ni rows. -1 for a shape the kernel does not take or if
// the grid cannot be found.
extern "C" long long egnn_pairwise_bwd_scratch_floats(long long g, int n, int h, int e, int k,
                                                      int ni) {
  if (bad_shape(g, n, h, e, k) || bad_slice(n, ni, 0, k)) return -1;
  long long size = 0;
  const cudaError_t err = with_bwd_route(h, e, [&](auto route) {
    if constexpr (std::is_same_v<decltype(route), Tiles>) {
      TileRoute t;
      const cudaError_t status = tile_route(g / k, n, h, e, ni, &t);
      size = tile_scratch(t, h, e, k);
      return status;
    } else {
      int grid = 0;
      long long units = 0;
      const cudaError_t status = grid_of<decltype(route)::value>(g / k, n, ni, &grid, &units);
      size = (long long)k * grid * slot_floats(h, e);
      return status;
    }
  });
  return err == cudaSuccess ? size : -1;
}

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = every
// launch went out). Inputs as egnn_pairwise_fwd (K weight sets over G = K * B
// graphs; the receiver slice [i0, i0 + ni)) plus gtotf [G,ni,3] and gtotm
// [G,ni,H]; outputs dx [G,N,3], dhi [G,ni,H], dhj [G,N,H], defea [G,ni,N,E] and
// dweights [K] x the flat [2H^2 + 5H + EH + 1] layout above; scratch holds
// egnn_pairwise_bwd_scratch_floats floats (256-byte aligned). All fp32,
// contiguous, on the current device.
extern "C" int egnn_pairwise_bwd(const float* x, const float* hi, const float* hj,
                                 const float* efea, const float* mask, const float* wg,
                                 const float* we, const float* b1, const float* w2,
                                 const float* b2, const float* wc1, const float* bc1,
                                 const float* wc2, const float* bc2, const float* gtotf,
                                 const float* gtotm, float* dx, float* dhi, float* dhj,
                                 float* defea, float* dweights, float* scratch, long long g,
                                 int n, int h, int e, int k, int clip_edges, int ni, int i0,
                                 void* stream_ptr) {
  if (bad_shape(g, n, h, e, k) || bad_slice(n, ni, i0, k)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream_ptr);
  return (int)with_bwd_route(h, e, [&](auto route) {
    if constexpr (std::is_same_v<decltype(route), Tiles>)
      return launch_tiles(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, gtotf,
                          gtotm, dx, dhi, dhj, defea, dweights, scratch, g, n, h, e, k,
                          clip_edges, ni, i0, s);
    else
      return launch<decltype(route)::value>(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1,
                                            bc1, wc2, bc2, gtotf, gtotm, dx, dhi, dhj, defea,
                                            dweights, scratch, g, n, e, k, clip_edges, ni, i0,
                                            s);
  });
}
