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
// A launch takes the receivers i in [i0, i0 + ni) of every graph against all
// N senders (a receiver slice, for the particle axis sharded over ranks; hi,
// efea, mask and the outputs hold the slice's rows, x and hj all N); (0, N)
// is the whole graph.
//
// What bounds it on an H100: two HxH products per edge (4 H^2 = 16 kFLOP at
// H = 64) against only node-level tensors in and out (about 170 bytes per
// edge at N = 5), so operations, not HBM, set the bound. What the design does
// about it:
// - The two products run on the tensor cores in split TF32 (egnn_tf32.cuh):
//   three mma.sync TF32 products per fp32 product, fp32-class error.
//   Everything else (the first layer, E <= 4 multiply-adds a unit; the SiLUs
//   with expf and IEEE division; the clip; the mask) stays in fp32 on the
//   CUDA cores, with the formulas of the plain version.
// - A tile is whole receiver rows: npt = floor(128 / N) nodes and all N of
//   their senders, npt * N <= 128 edge rows (125 at N = 5), padded to 128,
//   the MMA's 16 rows times 8 warps. Each warp owns 16 rows from one stage to
//   the next: the first layer writes a1 there, the first product's
//   accumulators take b2 and the SiLU in registers and are written back over
//   a1 as msg, and the second product's accumulators take bc1, the SiLU and
//   the dot with wc2 in registers, summed per row across the 4 lanes that
//   hold it. So the stages need no block barrier and no pass through shared
//   memory between them.
// - Per-row work (indices, rij, r2, efea, mask) is done once, a lane per
//   row; the first layer then takes 4 columns of 8 rows a lane, with every
//   row's loads of hi and hj in flight at once.
// - Persistent grid: 2 blocks of 256 threads per SM at H = 64 (110 KB of
//   shared memory each: W2 and Wc1 as {big, small} pairs in padded rows, the
//   128-row tile and its per-row data); block b takes tiles b, b + grid, ...
//   W2 and Wc1 are staged once per block with cp.async, overlapped with the
//   first tile's first layer, and split into big and small once. At H = 128
//   the products read W2 and Wc1 from global memory and split them as they
//   load (egnn_tf32.cuh: the staged pairs would not fit); the tile and its
//   per-row data take 78 KB, and the 64 accumulators a thread holds for a
//   128-column product leave room for one block of 256 threads an SM.
// - tot_m is summed over j from shared memory right after msg (one block
//   barrier), tot_f after the force (another). Both run over j = 0..N-1 in
//   order: no atomics, and two runs give the same bits. Masked-out rows (the
//   diagonal) are computed and multiplied by the mask, so a non-finite row
//   propagates as in the JAX package.
// - Seed axis: K weight sets over G = K * B graphs (graph g on set g / B), for
//   seed fleets. The grid is (blocks, K): block (b, s) runs seed s's tiles b,
//   b + blocks, ... with seed s's weights, so a block stages one weight set
//   once, and each seed's tiles are cut and assigned as a launch of its B
//   graphs alone would cut and assign them. blocks comes from the persistent
//   grid of one seed's tiles; with K > 1 the K * blocks blocks run in waves.
//   K = 1 is the single-set launch.
// - Receiver slice: a tile is npt receivers of the slice (counted over the
//   G * ni receivers) with all N senders, so a slice changes how rows are
//   counted and indexed, not the tile; each row's sums run over j in the
//   same order, so slices put side by side give the full launch's rows bit
//   for bit, and (0, N) is the full launch.
// Instantiated for H = 64 (every configuration in model_confs.yaml) and
// H = 128 (mocap's configs/config_mocap_no.json) with E <= 4, through
// egnn_tf32.cuh's with_width; every other width (a multiple of 64, as the
// wrapper pads it) and any E take the wide route below (egnn_wide.cuh).
//
// The TPU kernel's (8,128) padding and its rows=1600 VMEM budget have no
// counterpart here; its sequential grid becomes the persistent blocks' loop.

#include "egnn_wide.cuh"

namespace {

using namespace egnn_tc;

template <int H>
constexpr size_t smem_floats() {
  return (kStaged<H> ? 4 * H * padded<H>() : 0)   // W2, Wc1: big and small
         + kRows * padded<H>()    // the tile: a1, then msg
         + kRows * 4              // rij and r2, then the masked force
         + kRows * kMaxE          // efea
         + kRows * 3              // mask[i,j]; receiver and sender in the tile
         + 5 * H + kMaxE * H      // wg, b1, b2, bc1, wc2; we
         + kMaxN;                 // deg
}

template <int H>
__global__ void __launch_bounds__(kThreads, kStaged<H> ? 2 : 1)
egnn_pairwise_fwd_kernel(const float* __restrict__ x, const float* __restrict__ hi,
                         const float* __restrict__ hj, const float* __restrict__ efea,
                         const float* __restrict__ mask, const float* __restrict__ wg,
                         const float* __restrict__ we, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ wc1, const float* __restrict__ bc1,
                         const float* __restrict__ wc2, const float* __restrict__ bc2,
                         float* __restrict__ totf, float* __restrict__ totm,
                         long long num_nodes, long long tiles, int n, int e,
                         int clip_edges, int ni, int first_row) {
  // this block's seed: the first of its graphs' receivers (num_nodes and
  // tiles count one seed's receivers of the slice) and its weight set, read
  // only while staging (the parameters stay in the constant bank: no pointer
  // is held in registers)
  const long long seed = blockIdx.y;
  const long long seed_node0 = seed * num_nodes;
  constexpr int LD = padded<H>();
  constexpr int CH = H / 4;                // 4-column chunks of a row
  constexpr int RPI = 32 / CH;             // rows a warp covers at once
  constexpr int RPL = 16 / RPI;            // of its 16 rows, those a lane takes
  constexpr int RB = RPL < 8 ? RPL : 8;    // of them, those whose loads fly at once
  constexpr int WS = kStaged<H> ? H * LD : 0;   // float2 of a staged weight
  static_assert(CH <= 32 && 32 % CH == 0, "a row's chunks fit in a warp");
  extern __shared__ __align__(128) float smem[];
  float2* s_w2 = reinterpret_cast<float2*>(smem);   // [H][LD] {big, small}, [in][out]
  float2* s_wc1 = s_w2 + WS;
  float* s_act = reinterpret_cast<float*>(s_wc1 + WS);   // [kRows][LD]
  float* s_f = s_act + kRows * LD;         // [kRows][4]: rij, r2; then the force
  float* s_ef = s_f + kRows * 4;           // [kRows][kMaxE]
  float* s_m = s_ef + kRows * kMaxE;       // [kRows]: mask[i,j]
  int2* s_rs = reinterpret_cast<int2*>(s_m + kRows);   // [kRows]: receiver, sender
  float* s_wg = s_m + 3 * kRows;           // [H]
  float* s_b1 = s_wg + H;
  float* s_b2 = s_b1 + H;
  float* s_bc1 = s_b2 + H;
  float* s_wc2 = s_bc1 + H;
  float* s_we = s_wc2 + H;                 // [E][H]
  float* s_deg = s_we + kMaxE * H;         // [N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if constexpr (kStaged<H>)
    stage_weights_async<H>(s_w2, s_wc1, w2 + seed * H * H, wc1 + seed * H * H);
  const Weight<H> W2 = weight_of<H>(s_w2, w2 + seed * H * H);
  const Weight<H> Wc1 = weight_of<H>(s_wc1, wc1 + seed * H * H);
  for (int k = tid; k < H; k += kThreads) {
    s_wg[k] = wg[seed * H + k];
    s_b1[k] = b1[seed * H + k];
    s_b2[k] = b2[seed * H + k];
    s_bc1[k] = bc1[seed * H + k];
    s_wc2[k] = wc2[seed * H + k];
  }
  for (int k = tid; k < e * H; k += kThreads) s_we[k] = we[seed * e * H + k];
  for (int i = tid; i < ni; i += kThreads) {
    float d = 0.0f;
    for (int j = 0; j < n; ++j) d += __ldg(mask + i * n + j);
    s_deg[i] = fmaxf(d, 1.0f);
  }
  __syncthreads();

  const float bias_c2 = __ldg(bc2 + seed);
  const int npt = kRows / n;               // receivers a tile
  const int r0 = warp * 16;                // the warp's rows
  float* own = s_act + r0 * LD;
  const int ch = lane % CH;                // a lane's chunk in the column passes
  const int sub = lane / CH;               // and its first row
  const float4* hi4 = reinterpret_cast<const float4*>(hi);
  const float4* hj4 = reinterpret_cast<const float4*>(hj);
  [[maybe_unused]] bool staged = false;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long left = num_nodes - tile * npt;
    const long long node0 = seed_node0 + tile * npt;   // receiver: hi, efea, outputs
    const int nodes = left < npt ? (int)left : npt;
    const int rows = nodes * n;
    const long long graph0 = node0 / ni;   // the graph of the tile's first receiver
    const long long xbase = graph0 * n;    // its node 0: rows of x and hj
    const int q0 = (int)(node0 - graph0 * ni);   // the first receiver's slice row

    // ---- per row, a lane each: receiver, sender, rij, r2, efea, mask ----
    if (lane < 16) {
      const int r = r0 + lane;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, mij = 0.0f;
      int rl = 0, sl = 0;                  // receiver from node0, sender from xbase
      if (r < rows) {
        rl = r / n;
        const int j = r - rl * n;
        const int i = (q0 + rl) % ni;      // slice row of the receiver
        const int gl = (q0 + rl) / ni;     // its graph, from graph0
        sl = gl * n + j;
        const float* xi = x + (xbase + gl * n + first_row + i) * 3;
        const float* xj = x + (xbase + sl) * 3;
        d0 = __ldg(xi + 0) - __ldg(xj + 0);
        d1 = __ldg(xi + 1) - __ldg(xj + 1);
        d2 = __ldg(xi + 2) - __ldg(xj + 2);
        mij = __ldg(mask + i * n + j);
        const float* ef = efea + ((node0 + rl) * n + j) * e;
        for (int k = 0; k < e; ++k) s_ef[r * kMaxE + k] = __ldg(ef + k);
      }
      s_f[r * 4 + 0] = d0;
      s_f[r * 4 + 1] = d1;
      s_f[r * 4 + 2] = d2;
      s_f[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
      s_m[r] = mij;
      s_rs[r] = make_int2(rl, sl);
    }
    __syncwarp();

    // ---- first layer, fp32: a1 = silu(r2 wg + efea @ we + hi + hj + b1) ----
#pragma unroll
    for (int m0 = 0; m0 < RPL; m0 += RB) {
      float4 u[RB], w[RB];
#pragma unroll
      for (int m = 0; m < RB; ++m) {       // RB rows' loads in flight at once
        const int r = r0 + sub + RPI * (m0 + m);
        u[m] = w[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows) {
          const int2 rs = s_rs[r];
          u[m] = __ldg(hi4 + (node0 + rs.x) * CH + ch);
          w[m] = __ldg(hj4 + (xbase + rs.y) * CH + ch);
        }
      }
      const float4 wg4 = reinterpret_cast<const float4*>(s_wg)[ch];
      const float4 b14 = reinterpret_cast<const float4*>(s_b1)[ch];
#pragma unroll
      for (int m = 0; m < RB; ++m) {
        const int r = r0 + sub + RPI * (m0 + m);
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // padding rows
        if (r < rows) {
          const float r2 = s_f[r * 4 + 3];
          float4 acc = make_float4(r2 * wg4.x, r2 * wg4.y, r2 * wg4.z, r2 * wg4.w);
          for (int k = 0; k < e; ++k) {
            const float v = s_ef[r * kMaxE + k];
            const float4 we4 = reinterpret_cast<const float4*>(s_we + k * H)[ch];
            acc.x = fmaf(v, we4.x, acc.x);
            acc.y = fmaf(v, we4.y, acc.y);
            acc.z = fmaf(v, we4.z, acc.z);
            acc.w = fmaf(v, we4.w, acc.w);
          }
          a.x = silu(acc.x + u[m].x + w[m].x + b14.x);
          a.y = silu(acc.y + u[m].y + w[m].y + b14.y);
          a.z = silu(acc.z + u[m].z + w[m].z + b14.z);
          a.w = silu(acc.w + u[m].w + w[m].w + b14.w);
        }
        *reinterpret_cast<float4*>(s_act + r * LD + 4 * ch) = a;
      }
    }
    if constexpr (kStaged<H>) {
      if (!staged) {    // the weights' copy ran under the first layer
        split_weights<H>(s_w2, s_wc1);
        staged = true;
      }
    }
    __syncwarp();

    // ---- msg = silu(a1 @ W2 + b2), over the warp's own rows ----
    const int g = lane >> 2, t4 = lane & 3;  // the accumulators' row and column pair
    float acc[H / 8][4];
    rows_times_weight<H, false>(acc, own, W2, Identity());
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const float2 bias = *reinterpret_cast<const float2*>(s_b2 + 8 * nt + 2 * t4);
      acc[nt][0] = silu(acc[nt][0] + bias.x);
      acc[nt][1] = silu(acc[nt][1] + bias.y);
      acc[nt][2] = silu(acc[nt][2] + bias.x);
      acc[nt][3] = silu(acc[nt][3] + bias.y);
    }
    store_rows<H>(own, acc);
    __syncthreads();

    // ---- tot_m[i] = sum_j mask[i,j] msg[i,j], j in order; 4 columns a thread ----
    for (int q = tid; q < nodes * CH; q += kThreads) {
      const int rl = q / CH;
      const int c4 = q - rl * CH;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < n; ++j) {
        const float m = s_m[rl * n + j];
        const float4 v = *reinterpret_cast<const float4*>(s_act + (rl * n + j) * LD + 4 * c4);
        s.x += v.x * m;
        s.y += v.y * m;
        s.z += v.z * m;
        s.w += v.w * m;
      }
      reinterpret_cast<float4*>(totm + (node0 + rl) * H)[c4] = s;
    }
    // (no barrier: the coordinate MLP reads only its warp's rows of msg)

    // ---- cw = silu(msg @ Wc1 + bc1) . wc2 + bc2; the masked force ----
    rows_times_weight<H, false>(acc, own, Wc1, Identity());
    {
      // each lane sums its columns of rows g and g + 8; then the quad of
      // lanes that holds a row adds its four sums in a fixed butterfly
      float p_lo = 0.0f, p_hi = 0.0f;
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const int c = 8 * nt + 2 * t4;
        p_lo = fmaf(silu(acc[nt][0] + s_bc1[c]), s_wc2[c], p_lo);
        p_lo = fmaf(silu(acc[nt][1] + s_bc1[c + 1]), s_wc2[c + 1], p_lo);
        p_hi = fmaf(silu(acc[nt][2] + s_bc1[c]), s_wc2[c], p_hi);
        p_hi = fmaf(silu(acc[nt][3] + s_bc1[c + 1]), s_wc2[c + 1], p_hi);
      }
      p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 1);
      p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 1);
      p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 2);
      p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 2);
      if (t4 < 2) {       // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
        const int r = r0 + g + 8 * t4;
        const float cw = (t4 == 0 ? p_lo : p_hi) + bias_c2;
        if (r < rows) {
          const float mij = s_m[r];
          float f0 = s_f[r * 4 + 0] * cw, f1 = s_f[r * 4 + 1] * cw, f2 = s_f[r * 4 + 2] * cw;
          if (clip_edges) {
            f0 = clip(f0);
            f1 = clip(f1);
            f2 = clip(f2);
          }
          s_f[r * 4 + 0] = f0 * mij;
          s_f[r * 4 + 1] = f1 * mij;
          s_f[r * 4 + 2] = f2 * mij;
        }
      }
    }
    __syncthreads();

    // ---- tot_f[i] = sum_j (masked f)[i,j] / deg[i], j in order ----
    for (int q = tid; q < nodes * 3; q += kThreads) {
      const int rl = q / 3;
      const int c = q - rl * 3;
      float s = 0.0f;
      for (int j = 0; j < n; ++j) s += s_f[(rl * n + j) * 4 + c];
      totf[(node0 + rl) * 3 + c] = s / s_deg[(q0 + rl) % ni];
    }
    __syncthreads();   // the next tile rewrites s_act and s_f
  }
}

template <int H>
cudaError_t launch(const float* x, const float* hi, const float* hj, const float* efea,
                   const float* mask, const float* wg, const float* we, const float* b1,
                   const float* w2, const float* b2, const float* wc1, const float* bc1,
                   const float* wc2, const float* bc2, float* totf, float* totm,
                   long long g, int n, int e, int k, int clip_edges, int ni, int first_row,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<H>();
  const long long num_nodes = g / k * ni;    // one seed's receivers
  const int npt = kRows / n;
  const long long tiles = (num_nodes + npt - 1) / npt;
  int grid = 0;
  cudaError_t err =
      persistent_grid(egnn_pairwise_fwd_kernel<H>, smem, tiles, 2, kThreads, &grid);
  if (err != cudaSuccess) return err;
  egnn_pairwise_fwd_kernel<H><<<dim3(grid, k), kThreads, smem, stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf, totm, num_nodes,
      tiles, n, e, clip_edges, ni, first_row);
  return cudaGetLastError();
}

// ---- the wide route (egnn_wide.cuh): any H that is a multiple of kCols, any E ----

// The wide forward's own shared memory: per row of a tile, rij and r2 (then
// the masked force), the mask, receiver and sender; deg.
constexpr int kWideFwdFixed = kRows * (4 + 1 + 2) + kMaxN;
constexpr int kWideFwdTiles = 2;   // a1, msg

inline size_t wide_fwd_smem(const WideTiles& t) {
  return sizeof(float) * (kWideFwdFixed + (t.shared ? t.floats : 0));
}

__global__ void __launch_bounds__(kThreads, 1)
egnn_pairwise_fwd_wide(const float* __restrict__ x, const float* __restrict__ hi,
                       const float* __restrict__ hj, const float* __restrict__ efea,
                       const float* __restrict__ mask, const float* __restrict__ wg,
                       const float* __restrict__ we, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ wc1, const float* __restrict__ bc1,
                       const float* __restrict__ wc2, const float* __restrict__ bc2,
                       float* __restrict__ totf, float* __restrict__ totm,
                       float* __restrict__ scratch, long long slot, long long num_nodes,
                       long long tiles, int n, int h, int e, int clip_edges, int ni,
                       int first_row, int rows) {
  // this block's seed and its weight set (num_nodes and tiles count one
  // seed's receivers of the slice, as in the instantiated kernel)
  const long long seed = blockIdx.y;
  const long long seed_node0 = seed * num_nodes;
  const int LD = padded_wide(h);
  const int CH = h / 4;                    // 4-column chunks of a row
  const int NC = h / kCols;                // column passes of a product
  const int MT = rows / 16;                // m16 row tiles of a tile
  extern __shared__ __align__(128) float smem[];
  float* s_f = smem;                       // [kRows][4]: rij, r2; then the force
  float* s_m = s_f + kRows * 4;            // [kRows]: mask[i,j]
  int2* s_rs = reinterpret_cast<int2*>(s_m + kRows);   // [kRows]: receiver, sender
  float* s_deg = s_m + 3 * kRows;          // [N]
  // the tiles: in shared memory after the fields, or the block's scratch slot
  float* s_a = slot ? scratch + (seed * gridDim.x + blockIdx.x) * slot : s_deg + kMaxN;
  float* s_msg = s_a + rows * LD;          // [R][LD]
  float* s_cw = s_msg + rows * LD;         // [R][NC]: cw's sum over each column pass

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
  const int npt = rows / n;                // receivers a tile
  const int g = lane >> 2, t4 = lane & 3;  // the accumulators' row and column pair
  const float4* hi4 = reinterpret_cast<const float4*>(hi);
  const float4* hj4 = reinterpret_cast<const float4*>(hj);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long left = num_nodes - tile * npt;
    const long long node0 = seed_node0 + tile * npt;   // receiver: hi, efea, outputs
    const int nodes = left < npt ? (int)left : npt;
    const int nrows = nodes * n;
    const long long graph0 = node0 / ni;
    const long long xbase = graph0 * n;
    const int q0 = (int)(node0 - graph0 * ni);

    // ---- per row, a thread each: receiver, sender, rij, r2, mask ----
    if (tid < rows) {
      const int r = tid;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, mij = 0.0f;
      int rl = 0, sl = 0;
      if (r < nrows) {
        rl = r / n;
        const int j = r - rl * n;
        const int i = (q0 + rl) % ni;
        const int gl = (q0 + rl) / ni;
        sl = gl * n + j;
        const float* xi = x + (xbase + gl * n + first_row + i) * 3;
        const float* xj = x + (xbase + sl) * 3;
        d0 = __ldg(xi + 0) - __ldg(xj + 0);
        d1 = __ldg(xi + 1) - __ldg(xj + 1);
        d2 = __ldg(xi + 2) - __ldg(xj + 2);
        mij = __ldg(mask + i * n + j);
      }
      s_f[r * 4 + 0] = d0;
      s_f[r * 4 + 1] = d1;
      s_f[r * 4 + 2] = d2;
      s_f[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
      s_m[r] = mij;
      s_rs[r] = make_int2(rl, sl);
    }
    __syncthreads();

    // ---- first layer, fp32: a1 = silu(r2 wg + efea @ we + hi + hj + b1) ----
    for (int q = tid; q < rows * CH; q += kThreads) {
      const int r = q / CH;
      const int c4 = q - r * CH;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // padding rows
      if (r < nrows) {
        const int2 rs = s_rs[r];
        const float4 u = __ldg(hi4 + (node0 + rs.x) * CH + c4);
        const float4 w = __ldg(hj4 + (xbase + rs.y) * CH + c4);
        const float4 pre = first_layer(s_f[r * 4 + 3], efea + (node0 * n + r) * e, e, Wg,
                                       We, B1, h, 4 * c4, u, w);
        a = make_float4(silu(pre.x), silu(pre.y), silu(pre.z), silu(pre.w));
      }
      *reinterpret_cast<float4*>(s_a + r * LD + 4 * c4) = a;
    }
    __syncthreads();

    // ---- msg = silu(a1 @ W2 + b2): (m16 tile, column pass) units over the warps ----
    for (int u = warp; u < MT * NC; u += kWarps) {
      const int mi = u % MT, c0 = (u / MT) * kCols;
      float acc[kCols / 8][4];
      rows_times_cols<false>(acc, s_a + 16 * mi * LD, LD, W2, h, h / 8, c0, Identity());
      float* lo = s_msg + (16 * mi + g) * LD + c0 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int c = c0 + 8 * nt + 2 * t4;
        const float bx = __ldg(B2 + c), by = __ldg(B2 + c + 1);
        *reinterpret_cast<float2*>(lo + 8 * nt) =
            make_float2(silu(acc[nt][0] + bx), silu(acc[nt][1] + by));
        *reinterpret_cast<float2*>(lo + 8 * LD + 8 * nt) =
            make_float2(silu(acc[nt][2] + bx), silu(acc[nt][3] + by));
      }
    }
    __syncthreads();

    // ---- tot_m[i] = sum_j mask[i,j] msg[i,j], j in order; 4 columns a thread ----
    for (int q = tid; q < nodes * CH; q += kThreads) {
      const int rl = q / CH;
      const int c4 = q - rl * CH;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < n; ++j) {
        const float m = s_m[rl * n + j];
        const float4 v = *reinterpret_cast<const float4*>(s_msg + (rl * n + j) * LD + 4 * c4);
        s.x += v.x * m;
        s.y += v.y * m;
        s.z += v.z * m;
        s.w += v.w * m;
      }
      reinterpret_cast<float4*>(totm + (node0 + rl) * h)[c4] = s;
    }

    // ---- silu(msg @ Wc1 + bc1) . wc2 over each column pass, per row ----
    for (int u = warp; u < MT * NC; u += kWarps) {
      const int mi = u % MT, nc = u / MT, c0 = nc * kCols;
      float acc[kCols / 8][4];
      rows_times_cols<false>(acc, s_msg + 16 * mi * LD, LD, Wc1, h, h / 8, c0, Identity());
      float p_lo = 0.0f, p_hi = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int c = c0 + 8 * nt + 2 * t4;
        const float bx = __ldg(Bc1 + c), by = __ldg(Bc1 + c + 1);
        const float wx = __ldg(Wc2 + c), wy = __ldg(Wc2 + c + 1);
        p_lo = fmaf(silu(acc[nt][0] + bx), wx, p_lo);
        p_lo = fmaf(silu(acc[nt][1] + by), wy, p_lo);
        p_hi = fmaf(silu(acc[nt][2] + bx), wx, p_hi);
        p_hi = fmaf(silu(acc[nt][3] + by), wy, p_hi);
      }
      quad_sum(p_lo, p_hi);
      if (t4 < 2)         // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
        s_cw[(16 * mi + g + 8 * t4) * NC + nc] = t4 == 0 ? p_lo : p_hi;
    }
    __syncthreads();

    // ---- cw = the column passes' sums in order + bc2; the masked force ----
    if (tid < nrows) {
      const int r = tid;
      float cw = 0.0f;
      for (int nc = 0; nc < NC; ++nc) cw += s_cw[r * NC + nc];
      cw += bias_c2;
      const float mij = s_m[r];
      float f0 = s_f[r * 4 + 0] * cw, f1 = s_f[r * 4 + 1] * cw, f2 = s_f[r * 4 + 2] * cw;
      if (clip_edges) {
        f0 = clip(f0);
        f1 = clip(f1);
        f2 = clip(f2);
      }
      s_f[r * 4 + 0] = f0 * mij;
      s_f[r * 4 + 1] = f1 * mij;
      s_f[r * 4 + 2] = f2 * mij;
    }
    __syncthreads();

    // ---- tot_f[i] = sum_j (masked f)[i,j] / deg[i], j in order ----
    for (int q = tid; q < nodes * 3; q += kThreads) {
      const int rl = q / 3;
      const int c = q - rl * 3;
      float s = 0.0f;
      for (int j = 0; j < n; ++j) s += s_f[(rl * n + j) * 4 + c];
      totf[(node0 + rl) * 3 + c] = s / s_deg[(q0 + rl) % ni];
    }
    __syncthreads();   // the next tile rewrites the fields and the tiles
  }
}

// A wide forward launch's tiles, their floats in the scratch buffer a block
// (0: in shared memory), its tiles of receivers and its blocks a seed.
struct WideFwdGrid {
  WideTiles tiles;
  long long slot, units;
  int grid;
};

cudaError_t wide_fwd_grid(long long g, int n, int h, int k, int ni, WideFwdGrid* out) {
  out->tiles = wide_tiles(h, n, kWideFwdTiles, kWideFwdFixed);
  out->slot = out->tiles.shared ? 0 : out->tiles.floats;
  const long long num_nodes = g / k * ni;
  const int npt = out->tiles.rows / n;
  out->units = (num_nodes + npt - 1) / npt;
  return wide_grid(egnn_pairwise_fwd_wide, wide_fwd_smem(out->tiles), out->units, out->slot,
                   &out->grid);
}

cudaError_t launch_wide(const float* x, const float* hi, const float* hj, const float* efea,
                        const float* mask, const float* wg, const float* we, const float* b1,
                        const float* w2, const float* b2, const float* wc1, const float* bc1,
                        const float* wc2, const float* bc2, float* totf, float* totm,
                        float* scratch, long long g, int n, int h, int e, int k,
                        int clip_edges, int ni, int first_row, cudaStream_t stream) {
  WideFwdGrid lg;
  cudaError_t err = wide_fwd_grid(g, n, h, k, ni, &lg);
  if (err != cudaSuccess) return err;
  if (lg.slot > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  egnn_pairwise_fwd_wide<<<dim3(lg.grid, k), kThreads, wide_fwd_smem(lg.tiles), stream>>>(
      x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf, totm, scratch,
      lg.slot, g / k * ni, lg.units, n, h, e, clip_edges, ni, first_row, lg.tiles.rows);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the wrapper allocates for one forward call on the current
// device: the wide route's tiles where they do not fit in shared memory, one
// slot per block of the launch's grid for each of the K seeds; 0 when the
// launch needs none, -1 for a shape the kernel does not take.
extern "C" long long egnn_pairwise_fwd_scratch_floats(long long g, int n, int h, int e, int k,
                                                      int ni) {
  if (bad_shape(g, n, h, e, k) || bad_slice(n, ni, 0, k)) return -1;
  long long size = 0;
  const cudaError_t err = with_width(h, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), Wide>) {
      WideFwdGrid lg;
      const cudaError_t status = wide_fwd_grid(g, n, h, k, ni, &lg);
      size = (long long)k * lg.grid * lg.slot;
      return status;
    } else {
      return cudaSuccess;
    }
  });
  return err == cudaSuccess ? size : -1;
}

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = launched).
// Shapes: x [G,N,3], hj [G,N,H]; the receiver slice [i0, i0 + ni): hi
// [G,ni,H], efea [G,ni,N,E], mask [ni,N] (its rows of the [N,N] mask);
// wg/b1/b2/bc1/wc2 [K,H], we [K,E,H], w2/wc1 [K,H,H] in [in,out] layout
// (16-byte aligned), bc2 [K]: K weight sets, G = K * B graphs, graph g on set
// g / B (K = 1: one set; K > 1 takes the whole graph, ni = N); outputs totf
// [G,ni,3], totm [G,ni,H]; scratch holds egnn_pairwise_fwd_scratch_floats
// floats (null where that is 0). All fp32, contiguous, on the current device.
extern "C" int egnn_pairwise_fwd(const float* x, const float* hi, const float* hj,
                                 const float* efea, const float* mask, const float* wg,
                                 const float* we, const float* b1, const float* w2,
                                 const float* b2, const float* wc1, const float* bc1,
                                 const float* wc2, const float* bc2, float* totf, float* totm,
                                 float* scratch, long long g, int n, int h, int e, int k,
                                 int clip_edges, int ni, int i0, void* stream) {
  if (bad_shape(g, n, h, e, k) || bad_slice(n, ni, i0, k)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)with_width(h, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), Wide>)
      return launch_wide(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf,
                         totm, scratch, g, n, h, e, k, clip_edges, ni, i0, s);
    else
      return launch<decltype(width)::value>(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1,
                                            bc1, wc2, bc2, totf, totm, g, n, e, k, clip_edges,
                                            ni, i0, s);
  });
}
