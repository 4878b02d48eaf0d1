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
// HBM, set the bound. What the design does about it:
// - All six products run on the tensor cores in split TF32 (egnn_tf32.cuh,
//   mma.sync): the recomputed silu(pre1) @ W2 and silu(pre2) @ Wc1; dcpre @
//   Wc1^T and dpre2 @ W2^T, which read the staged W in the transposed
//   fragment layout, with no transposed copy; and the weight gradients
//   msg^T dcpre (dWc1) and a1^T dpre2 (dW2), products over the tile's edge
//   dimension that read the per-edge tiles column-major. The elementwise
//   work (SiLU and its derivative with expf and IEEE division, the clip
//   gate, the mask), the E <= 4 columns of efea @ We and dpre1 @ We^T and
//   the vector gradients stay in fp32 on the CUDA cores.
// - A unit is floor(R / (ni N)) whole graphs' slices (at least one; five at
//   N = 5 and R = 128), walked in tiles of R edge rows (a graph of N > 11 spans
//   several; the block adds each tile's node sums to its outputs). A graph is never split
//   across blocks, so the sums over senders j (dhi, the first half of dx) and
//   over receivers i (dhj, the second half) run inside the block through
//   shared memory in a fixed order.
// - Each warp owns 16 rows of the tile through the per-edge stages, and
//   works on the accumulators where it can: pre2 takes b2 there; cpre takes
//   bc1, and cw = silu(cpre) . wc2 is summed per row across the 4 lanes that
//   hold it; dpre1 takes silu'(pre1), with dpre1 . wg and dpre1 @ We^T summed
//   the same way, and writes a1 back over pre1 for dW2. The weight-gradient
//   products, which sum over all rows, and the node sums follow block
//   barriers: dWc1 before dpre1 overwrites dcpre, dW2 after a1 is written.
// - Persistent grid: one block per SM. At H = 64 a block is 256 threads (8
//   warps, R = 128 rows a tile); shared memory holds W2 and Wc1 as {big,
//   small} pairs (68 KB, staged once per block with cp.async, overlapped
//   with the first tile's first layer) and four [R][H + 4] per-edge tiles
//   (139 KB): pre1, then a1; pre2, then msg; cpre, then dcpre, then dpre1;
//   sigmoid(cpre), then dpre2. 214 KB in all, so 8 warps an SM: four tiles
//   of 128 rows are live at once. At H = 128 the four tiles of 128 rows
//   would take 270 KB alone: a block is 128 threads (4 warps, R = 64 rows a
//   tile; the tiles 135 KB, 144 KB in all), and the products read W2 and
//   Wc1 from global memory and split them as they load (egnn_tf32.cuh). A
//   warp then owns 32 of dW's m16 x n8 tiles, taken as two m16 rows one
//   after the other, so that a pass holds 64 accumulators, as a product
//   does.
// - The weight gradients need a sum across blocks, which run in no order.
//   Each tile's dW2 and dWc1 are tensor-core products from zero, added in
//   fp32 to the block's sums in its own slot of the scratch buffer; the
//   vector gradients are summed in per-lane registers across all the
//   block's units and written to the slot at the end. A second launch adds
//   the slots in block order (one slot per SM, not one per 125 rows). No
//   atomics, a static assignment of units to blocks: two runs give the same
//   bits.
// - Masked-out rows (the diagonal) are computed and multiplied by the mask,
//   as the plain version does, so a non-finite row propagates.
// - Seed axis: K weight sets over G = K * B graphs (graph g on set g / B), for
//   seed fleets. The grid is (blocks, K): block (b, s) takes seed s's units b,
//   b + blocks, ... with seed s's weights, and writes slot s * blocks + b; the
//   second launch sums each seed's slots in block order into its own
//   gradients. blocks is the persistent grid of one seed's units, so each
//   seed's units, slots and sums are those of a launch of its B graphs alone:
//   the same bits. With K > 1 the K * blocks blocks run in waves.
// Instantiated for H = 64 (every configuration in model_confs.yaml) and
// H = 128 (mocap's configs/config_mocap_no.json) with E <= 4, through
// egnn_tf32.cuh's with_width, which the scratch size goes through too; every
// other width (a multiple of 64, as the wrapper pads it) and any E take the
// wide route below (egnn_wide.cuh).
//
// The TPU kernel's (8,128) padding, its rows=800 VMEM budget and the weight
// gradients it accumulates across its sequential grid have no counterpart here.

#include <numeric>

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

// A block of width H: its warps, the edge rows of its tiles (16 a warp) and
// its threads.
template <int H>
__host__ __device__ constexpr int warps_of() { return kStaged<H> ? kWarps : 4; }
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
  return (kStaged<H> ? 4 * H * padded<H>() : 0)   // W2, Wc1: big and small
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
  constexpr int WS = kStaged<H> ? H * LD : 0;      // float2 of a staged weight
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
  if constexpr (kStaged<H>)
    stage_weights_async<H>(s_w2, s_wc1, w2 + seed * H * H, wc1 + seed * H * H);
  const Weight<H> W2 = weight_of<H>(s_w2, w2 + seed * H * H);
  const Weight<H> Wc1 = weight_of<H>(s_wc1, wc1 + seed * H * H);
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
  [[maybe_unused]] bool staged = false;
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
      if constexpr (kStaged<H>) {
        if (!staged) {  // the weights' copy ran under the first layer
          split_weights<H>(s_w2, s_wc1);
          staged = true;
        }
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

// ---- the wide route (egnn_wide.cuh): any H that is a multiple of kCols, any E ----

// The wide backward's own shared memory: per row of a tile, rij and r2, dcw,
// drij, the mask, mask / deg, receiver and sender; deg.
constexpr int kWideBwdFixed = kRows * (4 + 1 + 3 + 1 + 1 + 2) + kMaxN;
constexpr int kWideBwdTiles = 4;   // pre1/a1, pre2/msg, cpre/dcpre/dpre1, sigmoid(cpre)/dpre2

inline size_t wide_bwd_smem(const WideTiles& t) {
  return sizeof(float) * (kWideBwdFixed + (t.shared ? t.floats : 0));
}

// A wide unit is gpu whole graphs, walked in tiles of npt = R / N whole
// receivers (a tile may end inside a graph, never inside a receiver's row);
// the block's running sums of the nine weight gradients live in its slot of
// the scratch buffer, followed by its tiles where they are not in shared
// memory (`stride` floats a block).
__global__ void __launch_bounds__(kThreads, 1)
egnn_pairwise_bwd_wide(const float* __restrict__ x, const float* __restrict__ hi,
                       const float* __restrict__ hj, const float* __restrict__ efea,
                       const float* __restrict__ mask, const float* __restrict__ wg,
                       const float* __restrict__ we, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ wc1, const float* __restrict__ bc1,
                       const float* __restrict__ wc2, const float* __restrict__ bc2,
                       const float* __restrict__ gtotf, const float* __restrict__ gtotm,
                       float* __restrict__ dx, float* __restrict__ dhi,
                       float* __restrict__ dhj, float* __restrict__ defea,
                       float* __restrict__ partial, long long stride, int global_tiles,
                       long long num_graphs, long long units, int n, int h, int e,
                       int clip_edges, int ni, int first_row, int rows, int gpu) {
  const long long seed = blockIdx.y;
  const long long seed_g0 = seed * num_graphs;
  const int LD = padded_wide(h);
  const int CH = h / 4;                    // 4-column chunks of a row
  const int NC = h / kCols;                // column passes of a product
  const int MT = rows / 16;                // m16 row tiles of a tile
  const int HT = h / 16;                   // m16 row tiles of dW
  extern __shared__ __align__(128) float smem[];
  float* s_rij = smem;                     // [kRows][4]: rij, r2
  float* s_dcw = s_rij + 4 * kRows;        // [kRows]
  float* s_drij = s_dcw + kRows;           // [kRows][3]
  float* s_m = s_drij + 3 * kRows;         // [kRows]: mask[i,j]
  float* s_mw = s_m + kRows;               // [kRows]: mask[i,j] / deg[i]
  int2* s_rs = reinterpret_cast<int2*>(s_mw + kRows);   // receiver, sender (-1: padding)
  float* s_deg = s_mw + 3 * kRows;         // [N]
  // the block's slot: dW2, dWc1, dwg, db1, db2, dbc1, dwc2, dwe, dbc2
  // (partial_floats), then its tiles when they are not in shared memory
  float* part = partial + (seed * gridDim.x + blockIdx.x) * stride;
  float* s_p1 = global_tiles ? part + slot_floats(h, e) : s_deg + kMaxN;   // pre1, then a1
  float* s_p2 = s_p1 + rows * LD;          // pre2, then msg
  float* s_x = s_p2 + rows * LD;           // cpre, dcpre, then dpre1
  float* s_y = s_x + rows * LD;            // sigmoid(cpre), then dpre2
  float* s_cw = s_y + rows * LD;           // [R][NC]: cw's sum over each column pass
  float* p_dw2 = part;
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
  const float* W2 = w2 + seed * h * h;
  const float* Wc1 = wc1 + seed * h * h;
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
  __syncthreads();
  const float bias_c2 = __ldg(bc2 + seed);
  const int nn = ni * n;                   // a graph's edges in the slice
  const int npt = rows / n;                // receivers a tile
  const int g = lane >> 2, t4 = lane & 3;  // the fragments' row and column pair
  const float4* hi4 = reinterpret_cast<const float4*>(hi);
  const float4* hj4 = reinterpret_cast<const float4*>(hj);
  bool first_tile = true;                  // the block's first: it writes its slot

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const long long left = num_graphs - unit * gpu;
    const int ng = left < gpu ? (int)left : gpu;
    const int edges = ng * nn;
    const int tiles = (ng * ni + npt - 1) / npt;
    const long long g0 = seed_g0 + unit * gpu;   // the unit's first graph,
    const long long nbase = g0 * n;              // node (x, hj, dx, dhj),
    const long long qbase = g0 * ni;             // receiver (hi, gtot*, dhi)
    const long long ebase = g0 * nn;             // and edge

    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * npt * n;
      const int cnt = min(npt * n, edges - t0);
      const int ksteps = (cnt + 7) / 8;   // of the weight gradients' row sums

      // ---- per row, a thread each: receiver, sender, rij, r2, mask ----
      if (tid < rows) {
        const int r = tid;
        const int ge = t0 + r;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, mij = 0.0f, mw = 0.0f;
        int li = -1, lj = 0;
        if (r < cnt) {
          const int gl = ge / nn;
          const int w = ge - gl * nn;
          const int i = w / n;
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
        }
        s_rij[r * 4 + 0] = d0;
        s_rij[r * 4 + 1] = d1;
        s_rij[r * 4 + 2] = d2;
        s_rij[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
        s_m[r] = mij;
        s_mw[r] = mw;
        s_rs[r] = make_int2(li, lj);
      }
      __syncthreads();

      // ---- pre1 = r2 wg + efea @ we + hi + hj + b1 (padding rows: zeros) ----
      for (int q = tid; q < rows * CH; q += kThreads) {
        const int r = q / CH;
        const int c4 = q - r * CH;
        const int2 rs = s_rs[r];
        float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (rs.x >= 0)
          p = first_layer(s_rij[r * 4 + 3], efea + (ebase + t0 + r) * e, e, Wg, We, B1, h,
                          4 * c4, __ldg(hi4 + (qbase + rs.x) * CH + c4),
                          __ldg(hj4 + (nbase + rs.y) * CH + c4));
        *reinterpret_cast<float4*>(s_p1 + r * LD + 4 * c4) = p;
      }
      __syncthreads();

      // ---- pre2 = silu(pre1) @ W2 + b2 ----
      for (int u = warp; u < MT * NC; u += kWarps) {
        const int mi = u % MT, c0 = (u / MT) * kCols;
        float acc[kCols / 8][4];
        rows_times_cols<false>(acc, s_p1 + 16 * mi * LD, LD, W2, h, h / 8, c0, Silu());
        float* lo = s_p2 + (16 * mi + g) * LD + c0 + 2 * t4;
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

      // ---- cpre = silu(pre2) @ Wc1 + bc1 -> X, sigmoid(cpre) -> Y; cw's sums ----
      for (int u = warp; u < MT * NC; u += kWarps) {
        const int mi = u % MT, nc = u / MT, c0 = nc * kCols;
        float acc[kCols / 8][4];
        rows_times_cols<false>(acc, s_p2 + 16 * mi * LD, LD, Wc1, h, h / 8, c0, Silu());
        float p_lo = 0.0f, p_hi = 0.0f;
        float* x_lo = s_x + (16 * mi + g) * LD + c0 + 2 * t4;
        float* y_lo = s_y + (16 * mi + g) * LD + c0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
          const int c = c0 + 8 * nt + 2 * t4;
          const float bx = __ldg(Bc1 + c), by = __ldg(Bc1 + c + 1);
          const float wx = __ldg(Wc2 + c), wy = __ldg(Wc2 + c + 1);
          const float z0 = acc[nt][0] + bx, z1 = acc[nt][1] + by;
          const float z2 = acc[nt][2] + bx, z3 = acc[nt][3] + by;
          const float q0 = sigmoid(z0), q1 = sigmoid(z1), q2 = sigmoid(z2), q3 = sigmoid(z3);
          p_lo = fmaf(z0 * q0, wx, p_lo);
          p_lo = fmaf(z1 * q1, wy, p_lo);
          p_hi = fmaf(z2 * q2, wx, p_hi);
          p_hi = fmaf(z3 * q3, wy, p_hi);
          *reinterpret_cast<float2*>(x_lo + 8 * nt) = make_float2(z0, z1);
          *reinterpret_cast<float2*>(x_lo + 8 * LD + 8 * nt) = make_float2(z2, z3);
          *reinterpret_cast<float2*>(y_lo + 8 * nt) = make_float2(q0, q1);
          *reinterpret_cast<float2*>(y_lo + 8 * LD + 8 * nt) = make_float2(q2, q3);
        }
        quad_sum(p_lo, p_hi);
        if (t4 < 2)       // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
          s_cw[(16 * mi + g + 8 * t4) * NC + nc] = t4 == 0 ? p_lo : p_hi;
      }
      __syncthreads();

      // ---- per row: cw, and the force's gradient dcw, drij ----
      if (tid < rows) {
        const int r = tid;
        float cw = 0.0f;
        for (int nc = 0; nc < NC; ++nc) cw += s_cw[r * NC + nc];
        cw += bias_c2;
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
      __syncthreads();

      // ---- dcpre = dcw wc2 silu'(cpre) -> X; dwc2 += ca dcw, dbc1 += dcpre,
      // dbc2 += dcw: a thread a column, the rows in order ----
      for (int c = tid; c < h; c += kThreads) {
        const float w = __ldg(Wc2 + c);
        float sw = 0.0f, sb = 0.0f;
        for (int r = 0; r < rows; ++r) {
          const float z = s_x[r * LD + c], s = s_y[r * LD + c], d = s_dcw[r];
          const float dc = d * w * dsilu(z, s);
          s_x[r * LD + c] = dc;
          sw = fmaf(z * s, d, sw);
          sb += dc;
        }
        add_to(p_wc2 + c, sw, first_tile);
        add_to(p_bc1 + c, sb, first_tile);
      }
      if (tid == 0) {
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += s_dcw[r];
        add_to(p_bc2, s, first_tile);
      }
      __syncthreads();

      // ---- dpre2 = (dcpre @ Wc1^T + gtotm[i] mask[i,j]) silu'(pre2) -> Y;
      // pre2 -> msg in P2 (neither is this product's operand) ----
      for (int u = warp; u < MT * NC; u += kWarps) {
        const int mi = u % MT, c0 = (u / MT) * kCols;
        float acc[kCols / 8][4];
        rows_times_cols<true>(acc, s_x + 16 * mi * LD, LD, Wc1, h, h / 8, c0, Identity());
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {   // rows g and g + 8
          const int r = 16 * mi + g + 8 * hh;
          const int li = s_rs[r].x;
          const float mij = s_m[r];
          const float* gm = gtotm + (qbase + (li >= 0 ? li : 0)) * h;
          float* yr = s_y + r * LD;
          float* pr = s_p2 + r * LD;
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int c = c0 + 8 * nt + 2 * t4 + cc;
              const float z = pr[c];
              const float s = sigmoid(z);
              yr[c] = li >= 0 ? (acc[nt][2 * hh + cc] + __ldg(gm + c) * mij) * dsilu(z, s) : 0.0f;
              pr[c] = z * s;
            }
          }
        }
      }
      __syncthreads();

      // ---- dWc1 += msg^T dcpre over the tile's rows (padding rows: dcpre 0);
      // db2 += dpre2 ----
      for (int u = warp; u < HT * NC; u += kWarps)
        cols_weight_grad(p_dwc1, h, s_p2, s_x, LD, ksteps, u % HT, (u / HT) * kCols, first_tile);
      for (int c = tid; c < h; c += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += s_y[r * LD + c];
        add_to(p_b2 + c, s, first_tile);
      }
      __syncthreads();

      // ---- dpre1 = (dpre2 @ W2^T) silu'(pre1) -> X; pre1 -> a1 in P1 ----
      for (int u = warp; u < MT * NC; u += kWarps) {
        const int mi = u % MT, c0 = (u / MT) * kCols;
        float acc[kCols / 8][4];
        rows_times_cols<true>(acc, s_y + 16 * mi * LD, LD, W2, h, h / 8, c0, Identity());
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * mi + g + 8 * hh;
          const bool valid = s_rs[r].x >= 0;
          float* zr = s_p1 + r * LD;
          float* xr = s_x + r * LD;
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int c = c0 + 8 * nt + 2 * t4 + cc;
              const float z = zr[c];
              const float s = sigmoid(z);
              xr[c] = valid ? acc[nt][2 * hh + cc] * dsilu(z, s) : 0.0f;
              zr[c] = z * s;
            }
          }
        }
      }
      __syncthreads();

      // ---- dr2 = dpre1 . wg (into drij) and defea = dpre1 @ We^T: a warp a
      // row, its lanes over the columns, then a fixed butterfly ----
      for (int r = warp; r < cnt; r += kWarps) {
        const float* xr = s_x + r * LD;
        for (int o = 0; o <= e; ++o) {
          const float* v = o == 0 ? Wg : We + (o - 1) * h;
          float s = 0.0f;
          for (int c = lane; c < h; c += 32) s = fmaf(xr[c], __ldg(v + c), s);
#pragma unroll
          for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
          if (lane == 0) {
            if (o == 0) {
#pragma unroll
              for (int d = 0; d < 3; ++d) s_drij[r * 3 + d] += 2.0f * s_rij[r * 4 + d] * s;
            } else {
              defea[(ebase + t0 + r) * e + o - 1] = s;
            }
          }
        }
      }
      // dwg += r2 dpre1, db1 += dpre1, dwe += efea dpre1: a thread a column
      for (int c = tid; c < h; c += kThreads) {
        float sg = 0.0f, sb = 0.0f;
        for (int r = 0; r < cnt; ++r) {
          const float d = s_x[r * LD + c];
          sg = fmaf(s_rij[r * 4 + 3], d, sg);
          sb += d;
        }
        add_to(p_wg + c, sg, first_tile);
        add_to(p_b1 + c, sb, first_tile);
        for (int k = 0; k < e; ++k) {
          float s = 0.0f;
          for (int r = 0; r < cnt; ++r)
            s = fmaf(__ldg(efea + (ebase + t0 + r) * e + k), s_x[r * LD + c], s);
          add_to(p_we + k * h + c, s, first_tile);
        }
      }
      // dW2 += a1^T dpre2 over the tile's rows (padding rows: dpre2 0)
      for (int u = warp; u < HT * NC; u += kWarps)
        cols_weight_grad(p_dw2, h, s_p1, s_y, LD, ksteps, u % HT, (u / HT) * kCols, first_tile);
      first_tile = false;
      __syncthreads();

      // ---- node sums of the graphs the tile touches: over senders (dhi, dx)
      // of a receiver of the slice, over the tile's receivers (dhj, dx) of
      // every node; a graph's first tile writes, later ones add ----
      const int gl_lo = t0 / nn;
      const int nodes = ((t0 + cnt - 1) / nn - gl_lo + 1) * n;
      for (int q = tid; q < nodes * CH; q += kThreads) {
        const int node = gl_lo * n + q / CH;
        const int c4 = q % CH;
        const int gl = node / n;
        const int a = node - gl * n;
        const bool first = gl * nn >= t0;
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
        float4* oj = reinterpret_cast<float4*>(dhj + (nbase + node) * h) + c4;
        if (!first) {
          const float4 pj = *oj;
          sj = make_float4(pj.x + sj.x, pj.y + sj.y, pj.z + sj.z, pj.w + sj.w);
        }
        *oj = sj;
        if (recv) {
          float4* oi = reinterpret_cast<float4*>(dhi + (qbase + gl * ni + ia) * h) + c4;
          if (!first) {
            const float4 pi = *oi;
            si = make_float4(pi.x + si.x, pi.y + si.y, pi.z + si.z, pi.w + si.w);
          }
          *oi = si;
        }
      }
      for (int q = tid; q < nodes * 3; q += kThreads) {
        const int node = gl_lo * n + q / 3;
        const int c = q % 3;
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
        dx[out] = gl * nn >= t0 ? si - sj : dx[out] + (si - sj);
      }
      __syncthreads();   // the next tile rewrites the fields and the tiles
    }
  }
}

// A wide backward launch's tiles, its floats of scratch a block (the slot of
// partial weight gradients, then the tiles where they are not in shared
// memory), its graphs a unit, units and blocks a seed.
struct WideBwdGrid {
  WideTiles tiles;
  long long stride, units;
  int gpu, grid;
};

cudaError_t wide_bwd_grid(long long b, int n, int h, int e, int ni, WideBwdGrid* out) {
  out->tiles = wide_tiles(h, n, kWideBwdTiles, kWideBwdFixed);
  out->stride = slot_floats(h, e) + (out->tiles.shared ? 0 : out->tiles.floats);
  const int npt = out->tiles.rows / n;
  out->gpu = npt / std::gcd(npt, ni);      // whole tiles of whole receivers
  out->units = (b + out->gpu - 1) / out->gpu;
  return wide_grid(egnn_pairwise_bwd_wide, wide_bwd_smem(out->tiles), out->units, out->stride,
                   &out->grid);
}

cudaError_t launch_wide(const float* x, const float* hi, const float* hj, const float* efea,
                        const float* mask, const float* wg, const float* we, const float* b1,
                        const float* w2, const float* b2, const float* wc1, const float* bc1,
                        const float* wc2, const float* bc2, const float* gtotf,
                        const float* gtotm, float* dx, float* dhi, float* dhj, float* defea,
                        float* dweights, float* scratch, long long g, int n, int h, int e, int k,
                        int clip_edges, int ni, int first_row, cudaStream_t stream) {
  const long long b = g / k;                     // one seed's graphs
  WideBwdGrid lg;
  cudaError_t err = wide_bwd_grid(b, n, h, e, ni, &lg);
  if (err != cudaSuccess) return err;
  egnn_pairwise_bwd_wide<<<dim3(lg.grid, k), kThreads, wide_bwd_smem(lg.tiles), stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, gtotf, gtotm, dx, dhi, dhj,
      defea, scratch, lg.stride, lg.tiles.shared ? 0 : 1, b, lg.units, n, h, e, clip_edges, ni,
      first_row, lg.tiles.rows, lg.gpu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long np = partial_floats(h, e);
  egnn_pairwise_bwd_reduce<<<dim3((unsigned)((np + 255) / 256), k), 256, 0, stream>>>(
      scratch, dweights, lg.grid, lg.stride, np);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the wrapper allocates for one call on the current device:
// one slot of partial weight gradients per block of the launch's grid (on the
// wide route followed by the block's tiles where they are not in shared
// memory), for each of the K seeds of G = K * B graphs, on receiver slices of
// ni rows. -1 for a shape the kernel does not take or if the grid cannot be
// found.
extern "C" long long egnn_pairwise_bwd_scratch_floats(long long g, int n, int h, int e, int k,
                                                      int ni) {
  if (bad_shape(g, n, h, e, k) || bad_slice(n, ni, 0, k)) return -1;
  long long size = 0;
  const cudaError_t err = with_width(h, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), Wide>) {
      WideBwdGrid lg;
      const cudaError_t status = wide_bwd_grid(g / k, n, h, e, ni, &lg);
      size = (long long)k * lg.grid * lg.stride;
      return status;
    } else {
      int grid = 0;
      long long units = 0;
      const cudaError_t status = grid_of<decltype(width)::value>(g / k, n, ni, &grid, &units);
      size = (long long)k * grid * slot_floats(h, e);
      return status;
    }
  });
  return err == cudaSuccess ? size : -1;
}

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = both
// kernels launched). Inputs as egnn_pairwise_fwd (K weight sets over G = K * B
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
  return (int)with_width(h, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), Wide>)
      return launch_wide(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, gtotf,
                         gtotm, dx, dhi, dhj, defea, dweights, scratch, g, n, h, e, k,
                         clip_edges, ni, i0, s);
    else
      return launch<decltype(width)::value>(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1,
                                            bc1, wc2, bc2, gtotf, gtotm, dx, dhi, dhj, defea,
                                            dweights, scratch, g, n, e, k, clip_edges, ni, i0,
                                            s);
  });
}
