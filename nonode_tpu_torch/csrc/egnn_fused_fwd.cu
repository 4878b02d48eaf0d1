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
// What bounds it on an H100: two HxH products per edge (4 H^2 FLOP) against
// only node-level tensors in and out (about 170 bytes per edge at N = 5), so
// operations, not HBM, set the bound. Two routes, chosen by egnn_tf32.cuh's
// with_width on the padded width hp (64 up to 64, else a multiple of 64) and
// E, which the scratch size goes through too:
// - hp = 64 with E <= 4 (every configuration in model_confs.yaml):
//   egnn_pairwise_fwd_kernel, below, with its mma.sync products.
// - Every other (hp, E): the tile route, egnn_pairwise_fwd_tiles, further
//   below, with its products on wgmma.
// Both keep these rules:
// - The products run on the tensor cores in split TF32 (egnn_tf32.cuh):
//   three TF32 products per fp32 product, fp32-class error. Everything else
//   (the first layer, the SiLUs, the clip, the mask) stays in fp32 on the
//   CUDA cores.
// - A tile is whole receiver rows: npt = floor(R / N) receivers (counted over
//   the launch's G * ni receivers) with all N of their senders.
// - tot_m and tot_f are summed over j = 0..N-1 in order from shared memory
//   (or the block's tiles): no atomics, and two runs give the same bits.
//   Masked-out rows (the diagonal) are computed and multiplied by the mask,
//   so a non-finite row propagates as in the JAX package.
// - Persistent grid: block b takes tiles b, b + grid, ... Seed axis: K
//   weight sets over G = K * B graphs (graph g on set g / B); the grid is
//   (blocks, K) and block (b, s) runs seed s's tiles with seed s's weights,
//   each seed's tiles cut and assigned as a launch of its B graphs alone
//   would cut and assign them; K = 1 is the single-set launch.
// - Receiver slice: a slice changes how rows are counted and indexed, not a
//   row's arithmetic; each row's sums run over j in the same order, so
//   slices put side by side give the full launch's rows bit for bit, and
//   (0, N) is the full launch.
//
// The H = 64 kernel. A tile is 128 edge rows (125 at N = 5), the MMA's 16
// rows times 8 warps. Each warp owns 16 rows from one stage to the next: the
// first layer writes a1 there, the first product's accumulators take b2 and
// the SiLU in registers and are written back over a1 as msg, and the second
// product's accumulators take bc1, the SiLU and the dot with wc2 in
// registers, summed per row across the 4 lanes that hold it. Per-row work
// (indices, rij, r2, efea, mask) is done once, a lane per row; the first
// layer then takes 4 columns of 8 rows a lane. 2 blocks of 256 threads an
// SM (110 KB of shared memory each: W2 and Wc1 as {big, small} pairs in
// padded rows, staged once per block with cp.async under the first tile's
// first layer and split once; the tile and its per-row data). The SiLUs use
// expf and IEEE division, as the plain version.
//
// The TPU kernel's (8,128) padding and its rows=1600 VMEM budget have no
// counterpart here; its sequential grid becomes the persistent blocks' loop.

#include "egnn_wgmma.cuh"
#include "egnn_wide.cuh"

namespace {

using namespace egnn_tc;

template <int H>
constexpr size_t smem_floats() {
  return 4 * H * padded<H>()      // W2, Wc1: big and small
         + kRows * padded<H>()    // the tile: a1, then msg
         + kRows * 4              // rij and r2, then the masked force
         + kRows * kMaxE          // efea
         + kRows * 3              // mask[i,j]; receiver and sender in the tile
         + 5 * H + kMaxE * H      // wg, b1, b2, bc1, wc2; we
         + kMaxN;                 // deg
}

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
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
  constexpr int WS = H * LD;               // float2 of a staged weight
  static_assert(H == 64, "the tile route takes every other width");
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
  stage_weights_async<H>(s_w2, s_wc1, w2 + seed * H * H, wc1 + seed * H * H);
  const StagedWeight<H> W2{s_w2};
  const StagedWeight<H> Wc1{s_wc1};
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
  bool staged = false;

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
    if (!staged) {      // the weights' copy ran under the first layer
      split_weights<H>(s_w2, s_wc1);
      staged = true;
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

// ---- the tile route: every (hp, E) but hp = 64 with E <= kMaxE ----
//
// What held the two kernels it replaces back (an H = 128 instantiation of
// the kernel above that read W2 and Wc1 raw from global memory and split
// them as each warp loaded them; a route for wider widths that did the same
// with a block barrier after each stage), and what this one does instead:
// - Weights split once a call. egnn_fwd_split writes W2 and Wc1 of each seed
//   as TF32 big and small parts, zero-padded to hp, in 64 x 64 slabs in the
//   order and layout wgmma reads them (egnn_wgmma.cuh), 4 hp^2 floats a
//   seed (256 KB at hp = 128, 16 MB at hp = 1024). A block stages wg, b1,
//   b2, bc1, wc2 and We in shared memory, zero-padded to hp, and each
//   tile's per-row fields and edge features.
// - The products on wgmma. A block is W consumer warpgroups (W = 1 or 2,
//   R = 64 W edge rows a tile) and one producer warp. The producer's first
//   lane streams every slab a tile reads, W2's and then Wc1's, pass by pass
//   (64 output columns) and chunk by chunk (64 rows of K), through a ring
//   of S stages of 32 KB with one bulk copy a slab: full and empty
//   mbarriers, every consumer warp releasing a stage after its products
//   from it have completed. Every warp of the block reads a stage, so a
//   slab crosses from L2 once for R rows. A consumer thread loads its A
//   fragments (a1 or msg, fp32) from the tile, splits them into big and
//   small in registers, and issues wgmma m64n64k8 TF32 with A from
//   registers: small * big, big * small, big * big for each of a chunk's 8 k
//   steps, the first from zero, then adds the chunk's sum to the pass's in
//   fp32 (kChainSteps: each 64-deep chunk of K starts from zero).
// - The epilogues on the accumulators: msg = silu(acc + b2) written to the
//   msg tile; silu(acc + bc1) . wc2 summed per row over each pass's 64
//   columns (a row's 4 lanes in a fixed butterfly), the passes added in
//   order. The tiles hold a1 and msg, [R][hp + 4] each, in shared memory
//   where they fit beside a ring of 2 stages, else in the block's slot of
//   the scratch buffer (generic pointers, the same code; the A fragments
//   then load from L2, not through the ring).
// - A warp owns 16 rows of the tile (its rows of its warpgroup's m64
//   products) through the fields, the first layer and the products; only
//   the sums over j, which cross warps, wait on a consumer barrier. Its
//   first layer and epilogues compute a batch of rows into registers
//   before storing any, so that the loads of the batch are not held behind
//   its stores.
// - Units that fill the card: W = 2 where 128-row tiles give every SM one
//   (its tiles in shared memory up to hp = 128, in the block's slot above),
//   else W = 1 (64-row tiles, in shared memory up to hp = 256). The
//   consumer phases outside the products are latency-bound at 4 or 8 warps
//   an SM, so above hp = 128 eight warps with their tiles in L2 beat four
//   with them in shared memory. The rows of a product do not interact and
//   every row takes the same steps, so a row's bits do not depend on W, R
//   or the slice.
// - Native widths without copies: the kernel reads hi and hj at their
//   width h (16-byte loads where h % 4 == 0, else per float), takes every
//   column >= h as zero, and writes tot_m at width h. Zero columns add
//   exact zeros, so the values are those of the zero-padded width.
// - FastSilu (egnn_tf32.cuh) for every SiLU of the route: a1, msg and the
//   coordinate MLP's, 3 hp of them an edge row.

constexpr int kMaxStages = 4;

// #1's tile-route launch (see above): its consumer warpgroups, ring stages,
// where the tiles live, and its units and grid.
struct FwdPlan {
  int warpgroups;      // W: R = 64 W rows a tile
  int stages;          // S: 32 KB ring stages
  int tiles_shared;    // a1 and msg in shared memory (else the block's slot)
  long long units;     // tiles of one seed
  long long slot;      // floats of global tiles a block (0: shared)
  int grid;            // blocks a seed
};

__host__ __device__ constexpr long long fwd_tile_floats(int w, int hp) {
  return 2LL * 64 * w * padded_wide(hp);
}

// Floats of a tile-route block's own shared memory: the ring and its 2 S
// barriers; per row rij and r2 (then the masked force), the mask, receiver
// and sender, cw's sum over each pass, the E edge features; deg; wg, b1,
// b2, bc1, wc2 and We zero-padded to hp. The tiles follow where they are
// shared.
__host__ __device__ constexpr long long fwd_fields(int w, int stages, int hp, int e) {
  return (long long)stages * kSlab + 4LL * stages +
         round32(64LL * w * (7 + hp / kPanel + e) + kMaxN) + round32((5LL + e) * hp);
}

inline size_t fwd_smem(const FwdPlan& p, int hp, int e) {
  return sizeof(float) * (fwd_fields(p.warpgroups, p.stages, hp, e) +
                          (p.tiles_shared ? fwd_tile_floats(p.warpgroups, hp) : 0));
}

// W2 and Wc1 of each seed as slabs (egnn_wgmma.cuh): slab (w, pass, chunk),
// w = 0 for W2 and 1 for Wc1, holds B(k, n) = W[64 chunk + k][64 pass + n],
// big part then small, at ((w * NP + pass) * NP + chunk) * kSlab floats,
// NP = hp / 64; zero where the row or column is >= h. A thread per element
// of one seed's weights; grid (., K).
__global__ void egnn_fwd_split(const float* __restrict__ w2, const float* __restrict__ wc1,
                               float* __restrict__ slabs, int h, int hp) {
  const long long seed = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)hp * hp;      // elements of one weight
  if (p >= 2 * per) return;
  const int np = hp / kPanel;
  const int which = (int)(p / per);
  const long long f = p - which * per;
  const long long slab = f / kPart;              // pass * np + chunk
  const int within = (int)(f - slab * kPart);
  const int pass = (int)(slab / np), chunk = (int)(slab - (long long)pass * np);
  const int cm = within >> 5;                    // core matrix (n / 8) * 16 + k / 4
  const int n = (cm >> 4) * 8 + ((within & 31) >> 2);
  const int k = (cm & 15) * 4 + (within & 3);
  const int row = chunk * kPanel + k, col = pass * kPanel + n;
  const float* w = (which ? wc1 : w2) + seed * h * h;
  const float v = row < h && col < h ? w[(long long)row * h + col] : 0.0f;
  const float big = to_tf32(v);
  float* out = slabs + seed * 4 * per + ((long long)which * np * np + slab) * kSlab + within;
  out[0] = big;
  out[kPart] = to_tf32(v - big);
}

// The named barrier of a tile-route block's consumer threads (the producer
// warp takes no part).
template <int W>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * W) : "memory");
}

// Four columns c .. c + 3 of a row of width h: one 16-byte load where vec4
// (h % 4 == 0 and 16-byte aligned rows), else per float; zero from column h.
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row, int c, int h,
                                            bool vec4) {
  if (c >= h) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec4) return __ldg(reinterpret_cast<const float4*>(row + c));
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = c + t < h ? __ldg(row + c + t) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The thread's A fragments of k steps k0 .. k0 + 3 (columns 8 k0 ..) of
// its warp's 16 rows, split into big and small: all 16 loads first.
__device__ __forceinline__ void load_half(uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                                          const float* a_lo, const float* a_hi, int k0) {
  float v[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k = 8 * (k0 + ks);
    v[ks][0] = a_lo[k];
    v[ks][1] = a_hi[k];
    v[ks][2] = a_lo[k + 4];
    v[ks][3] = a_hi[k + 4];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    split4(v[ks], big[ks], small[ks]);
    fence_regs(big[ks]);
    fence_regs(small[ks]);
  }
}

// The 12 products of half a chunk (4 k steps from k0) on the slab part pair
// at shared byte address b: small * big, big * small, big * big each; the
// chunk's first k step from zero.
__device__ __forceinline__ void issue_half(float (&part)[32], const uint32_t (&big)[4][4],
                                           const uint32_t (&small)[4][4], uint32_t b, int k0) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t at = b + (k0 + ks) * kStepBytes;
    const uint64_t b_big = slab_desc(at), b_small = slab_desc(at + 4 * kPart);
    wgmma_tf32(part, small[ks], b_big, k0 + ks > 0);
    wgmma_tf32(part, big[ks], b_small, 1);
    wgmma_tf32(part, big[ks], b_big, 1);
  }
}

// One pass of a product over the warp's 16 rows of act (stride ld): run =
// act @ B[:, 64 pass .. 64 pass + 64) in split TF32, B from the next
// `chunks` ring stages (slab q, q + 1, ...; q advances). Each chunk's 8 k
// steps go to the tensor cores from zero, in two halves whose A fragments
// load under the other half's products; the chunks' sums add in fp32.
__device__ __forceinline__ void product_pass(float (&run)[32], const float* act, int ld,
                                             const float* ring, uint64_t* full, uint64_t* empty,
                                             int stages, uint32_t& q, int chunks) {
  const int lane = threadIdx.x & 31;
  const float* a_lo = act + (lane >> 2) * ld + (lane & 3);
  const float* a_hi = a_lo + 8 * ld;
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = 0.0f;
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.0f;
  uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
  load_half(big0, small0, a_lo, a_hi, 0);
  for (int c = 0; c < chunks; ++c, ++q) {
    const int s = (int)(q % stages);
    mbar_wait(full + s, (q / stages) & 1);
    const uint32_t b = smem_addr(ring + s * kSlab);
    fence_regs(part);
    wgmma_fence();
    issue_half(part, big0, small0, b, 0);
    wgmma_commit();
    load_half(big1, small1, a_lo + kPanel * c, a_hi + kPanel * c, 4);
    wgmma_fence();
    issue_half(part, big1, small1, b, 4);
    wgmma_commit();
    if (c + 1 < chunks) {
      wgmma_wait<1>();                     // the first half's A is free
      load_half(big0, small0, a_lo + kPanel * (c + 1), a_hi + kPanel * (c + 1), 0);
    }
    wgmma_wait<0>();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
    for (int i = 0; i < 32; ++i) run[i] += part[i];
  }
}

// One block of the tile route; see above. `slabs` holds every seed's split
// W2 and Wc1 (egnn_fwd_split); `tiles` the blocks' slots where the tiles
// leave shared memory.
template <int W>
__global__ void __launch_bounds__(128 * W + 32, 1)
egnn_pairwise_fwd_tiles(const float* __restrict__ x, const float* __restrict__ hi,
                        const float* __restrict__ hj, const float* __restrict__ efea,
                        const float* __restrict__ mask, const float* __restrict__ wg,
                        const float* __restrict__ we, const float* __restrict__ b1,
                        const float* __restrict__ slabs, const float* __restrict__ b2,
                        const float* __restrict__ bc1, const float* __restrict__ wc2,
                        const float* __restrict__ bc2, float* __restrict__ totf,
                        float* __restrict__ totm, float* __restrict__ tiles, const FwdPlan plan,
                        long long num_nodes, int n, int h, int hp, int e, int clip_edges, int ni,
                        int first_row) {
  constexpr int R = 64 * W;
  constexpr int kConsumers = 128 * W;
  const int S = plan.stages;
  const int NP = hp / kPanel;              // passes of a product, chunks of its K
  const int LD = padded_wide(hp);
  const int CH = hp / 4;                   // 4-column chunks of a row
  const bool vec4 = (h & 3) == 0;
  const long long seed = blockIdx.y;
  const long long seed_node0 = seed * num_nodes;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                      // [S][kSlab]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (long long)S * kSlab);
  uint64_t* empty = full + S;
  float* s_f = reinterpret_cast<float*>(empty + S);   // [R][4]: rij, r2; then the force
  float* s_m = s_f + 4 * R;                // [R]: mask[i,j]
  int2* s_rs = reinterpret_cast<int2*>(s_m + R);      // [R]: receiver, sender
  float* s_cw = reinterpret_cast<float*>(s_rs + R);   // [R][NP]: cw's sum over each pass
  float* s_ef = s_cw + R * NP;             // [R][E]
  float* s_deg = s_ef + R * e;             // [N]
  float* s_vec = s_f + round32(R * (7LL + NP + e) + kMaxN);   // [5 + E][hp]
  float* s_wg = s_vec;
  float* s_b1 = s_vec + hp;
  float* s_b2 = s_vec + 2 * hp;
  float* s_bc1 = s_vec + 3 * hp;
  float* s_wc2 = s_vec + 4 * hp;
  float* s_we = s_vec + 5 * hp;            // [E][hp]
  float* a1 = plan.tiles_shared ? smem + fwd_fields(W, S, hp, e)
                                : tiles + (seed * gridDim.x + blockIdx.x) * plan.slot;
  float* msg = a1 + R * LD;                // [R][LD] each

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long units = plan.units;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * W);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * W) {                     // the producer warp
    if (lane == 0) {
      const float* src = slabs + seed * 4LL * hp * hp;
      const int per_tile = 2 * NP * NP;
      uint32_t q = 0;
      for (long long tile = blockIdx.x; tile < units; tile += gridDim.x)
        for (int i = 0; i < per_tile; ++i, ++q) {
          const int s = (int)(q % S);
          mbar_wait(empty + s, ((q / S) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, kSlabBytes);
          bulk_load(ring + s * kSlab, src + (long long)i * kSlab, kSlabBytes, full + s);
        }
    }
    return;
  }

  // the vectors zero-padded to hp (a column's loads in flight at once), deg
  for (int c = tid; c < hp; c += kConsumers) {
    const bool in = c < h;
    const long long at = seed * h + c;
    const float v[5] = {in ? __ldg(wg + at) : 0.0f, in ? __ldg(b1 + at) : 0.0f,
                        in ? __ldg(b2 + at) : 0.0f, in ? __ldg(bc1 + at) : 0.0f,
                        in ? __ldg(wc2 + at) : 0.0f};
#pragma unroll
    for (int t = 0; t < 5; ++t) s_vec[t * hp + c] = v[t];
  }
  for (int k = tid; k < e * hp; k += kConsumers) {
    const int row = k / hp, c = k - row * hp;
    s_we[k] = c < h ? __ldg(we + (seed * e + row) * h + c) : 0.0f;
  }
  for (int i = tid; i < ni; i += kConsumers) {
    float d = 0.0f;
    for (int j = 0; j < n; ++j) d += __ldg(mask + i * n + j);
    s_deg[i] = fmaxf(d, 1.0f);
  }
  consumers_sync<W>();
  const float bias_c2 = __ldg(bc2 + seed);
  const int npt = R / n;                   // receivers a tile
  const int r0 = warp * 16;                // the warp's rows
  const int g = lane >> 2, t4 = lane & 3;  // the accumulators' row and column pair
  // the first layer's lanes: lpr lanes a row (a 4-column chunk each), rows
  // rsub, rsub + rstep, ... of the warp's 16
  const int lpr = CH < 32 ? CH : 32;
  const int rstep = 32 / lpr;
  const int c4_0 = lane % lpr, rsub = lane / lpr;
  const FastSilu act{};
  uint32_t q = 0;                          // slabs consumed

  for (long long tile = blockIdx.x; tile < units; tile += gridDim.x) {
    const long long left = num_nodes - tile * npt;
    const long long node0 = seed_node0 + tile * npt;   // receiver: hi, efea, outputs
    const int nodes = left < npt ? (int)left : npt;
    const int rows = nodes * n;
    const long long graph0 = node0 / ni;   // the graph of the tile's first receiver
    const long long xbase = graph0 * n;    // its node 0: rows of x and hj
    const int q0 = (int)(node0 - graph0 * ni);   // the first receiver's slice row

    // ---- per row of the warp's, a lane each: receiver, sender, rij, r2, mask, efea ----
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
        const float* ef = efea + (node0 * n + r) * e;
        for (int k = 0; k < e; ++k) s_ef[r * e + k] = __ldg(ef + k);
      }
      s_f[r * 4 + 0] = d0;
      s_f[r * 4 + 1] = d1;
      s_f[r * 4 + 2] = d2;
      s_f[r * 4 + 3] = d0 * d0 + d1 * d1 + d2 * d2;
      s_m[r] = mij;
      s_rs[r] = make_int2(rl, sl);
    }
    __syncwarp();

    // ---- first layer over the warp's rows: a1 = silu(r2 wg + efea @ we + hi + hj + b1) ----
    for (int c4 = c4_0; c4 < CH; c4 += lpr) {
      const int c = 4 * c4;
      const float4 wg4 = reinterpret_cast<const float4*>(s_wg)[c4];
      const float4 b14 = reinterpret_cast<const float4*>(s_b1)[c4];
      for (int rr0 = rsub; rr0 < 16; rr0 += 8 * rstep) {
        float4 u[8], w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {      // eight rows' loads in flight at once
          const int rr = rr0 + m * rstep, r = r0 + rr;
          u[m] = w[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (rr < 16 && r < rows) {
            const int2 rs = s_rs[r];
            u[m] = load_cols(hi + (node0 + rs.x) * h, c, h, vec4);
            w[m] = load_cols(hj + (xbase + rs.y) * h, c, h, vec4);
          }
        }
        // every row's a1 into u before any store (the tile may alias the
        // fields for the compiler, and the rows then run one at a time)
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = r0 + rr0 + m * rstep;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // padding rows
          if (rr0 + m * rstep < 16 && r < rows) {
            const float r2 = s_f[r * 4 + 3];
            acc = make_float4(r2 * wg4.x, r2 * wg4.y, r2 * wg4.z, r2 * wg4.w);
            for (int k = 0; k < e; ++k) {
              const float v = s_ef[r * e + k];
              const float4 we4 = reinterpret_cast<const float4*>(s_we + k * hp)[c4];
              acc.x = fmaf(v, we4.x, acc.x);
              acc.y = fmaf(v, we4.y, acc.y);
              acc.z = fmaf(v, we4.z, acc.z);
              acc.w = fmaf(v, we4.w, acc.w);
            }
            acc.x = act(acc.x + u[m].x + w[m].x + b14.x);
            acc.y = act(acc.y + u[m].y + w[m].y + b14.y);
            acc.z = act(acc.z + u[m].z + w[m].z + b14.z);
            acc.w = act(acc.w + u[m].w + w[m].w + b14.w);
          }
          u[m] = acc;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int rr = rr0 + m * rstep;
          if (rr < 16) *reinterpret_cast<float4*>(a1 + (r0 + rr) * LD + c) = u[m];
        }
      }
    }
    __syncwarp();
    // ---- msg = silu(a1 @ W2 + b2), pass by pass over the warp's rows ----
    float run[32];
    for (int pass = 0; pass < NP; ++pass) {
      product_pass(run, a1 + r0 * LD, LD, ring, full, empty, S, q, NP);
      float* lo = msg + (r0 + g) * LD + pass * kPanel + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {        // every SiLU before any store, as above
        const float2 bias = *reinterpret_cast<const float2*>(s_b2 + pass * kPanel + 8 * j + 2 * t4);
        run[4 * j] = act(run[4 * j] + bias.x);
        run[4 * j + 1] = act(run[4 * j + 1] + bias.y);
        run[4 * j + 2] = act(run[4 * j + 2] + bias.x);
        run[4 * j + 3] = act(run[4 * j + 3] + bias.y);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(lo + 8 * j) = make_float2(run[4 * j], run[4 * j + 1]);
        *reinterpret_cast<float2*>(lo + 8 * LD + 8 * j) = make_float2(run[4 * j + 2], run[4 * j + 3]);
      }
    }
    consumers_sync<W>();

    // ---- tot_m[i] = sum_j mask[i,j] msg[i,j], j in order; 4 columns a thread ----
    for (int qq = tid; qq < nodes * CH; qq += kConsumers) {
      const int rl = qq / CH;
      const int c = 4 * (qq - rl * CH);
      if (c >= h) continue;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < n; ++j) {
        const float m = s_m[rl * n + j];
        const float4 v = *reinterpret_cast<const float4*>(msg + (rl * n + j) * LD + c);
        s.x += v.x * m;
        s.y += v.y * m;
        s.z += v.z * m;
        s.w += v.w * m;
      }
      float* out = totm + (node0 + rl) * h + c;
      if (vec4) {
        *reinterpret_cast<float4*>(out) = s;
      } else {
        const float sv[4] = {s.x, s.y, s.z, s.w};
        for (int t = 0; t < 4 && c + t < h; ++t) out[t] = sv[t];
      }
    }

    // ---- silu(msg @ Wc1 + bc1) . wc2 over each pass, per row ----
    for (int pass = 0; pass < NP; ++pass) {
      product_pass(run, msg + r0 * LD, LD, ring, full, empty, S, q, NP);
      float p_lo = 0.0f, p_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = pass * kPanel + 8 * j + 2 * t4;
        const float2 bias = *reinterpret_cast<const float2*>(s_bc1 + c);
        const float2 w2c = *reinterpret_cast<const float2*>(s_wc2 + c);
        p_lo = fmaf(act(run[4 * j] + bias.x), w2c.x, p_lo);
        p_lo = fmaf(act(run[4 * j + 1] + bias.y), w2c.y, p_lo);
        p_hi = fmaf(act(run[4 * j + 2] + bias.x), w2c.x, p_hi);
        p_hi = fmaf(act(run[4 * j + 3] + bias.y), w2c.y, p_hi);
      }
      quad_sum(p_lo, p_hi);
      if (t4 < 2)         // lane t4 = 0 takes row g, lane t4 = 1 row g + 8
        s_cw[(r0 + g + 8 * t4) * NP + pass] = t4 == 0 ? p_lo : p_hi;
    }
    __syncwarp();

    // ---- cw = the passes' sums in order + bc2; the masked force ----
    if (lane < 16) {
      const int r = r0 + lane;
      if (r < rows) {
        float cw = 0.0f;
        for (int p = 0; p < NP; ++p) cw += s_cw[r * NP + p];
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
    }
    consumers_sync<W>();

    // ---- tot_f[i] = sum_j (masked f)[i,j] / deg[i], j in order ----
    for (int qq = tid; qq < nodes * 3; qq += kConsumers) {
      const int rl = qq / 3;
      const int c = qq - rl * 3;
      float s = 0.0f;
      for (int j = 0; j < n; ++j) s += s_f[(rl * n + j) * 4 + c];
      totf[(node0 + rl) * 3 + c] = s / s_deg[(q0 + rl) % ni];
    }
    consumers_sync<W>();   // the next tile rewrites the fields and the tiles
  }
}

template <int W>
cudaError_t tiles_grid(const FwdPlan& p, int hp, int e, int* grid) {
  return persistent_grid(egnn_pairwise_fwd_tiles<W>, fwd_smem(p, hp, e), p.units, 1,
                         128 * W + 32, grid);
}

// The tile route's launch for one seed's num_nodes receivers of n nodes at
// padded width hp (see above). W = 2 where its tiles give every SM one; the
// tiles in shared memory where they fit, else in the block's slot; the most
// ring stages that fit, up to kMaxStages.
cudaError_t fwd_plan(long long num_nodes, int n, int hp, int e, FwdPlan* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long units2 = (num_nodes + 128 / n - 1) / (128 / n);
  const int order[2] = {units2 >= sms ? 2 : 1, units2 >= sms ? 1 : 2};
  *out = FwdPlan{};
  for (int w : order)
    for (int ts = 1; ts >= 0 && out->stages == 0; --ts)
      for (int s = kMaxStages; s >= 2 && out->stages == 0; --s) {
        const FwdPlan p{w, s, ts, 0, 0, 0};
        if (fwd_smem(p, hp, e) <= kSmemBytes) *out = p;
      }
  if (out->stages == 0) return cudaErrorInvalidValue;
  const int npt = 64 * out->warpgroups / n;
  out->units = (num_nodes + npt - 1) / npt;
  out->slot = out->tiles_shared ? 0 : round32(fwd_tile_floats(out->warpgroups, hp));
  return out->warpgroups == 2 ? tiles_grid<2>(*out, hp, e, &out->grid)
                              : tiles_grid<1>(*out, hp, e, &out->grid);
}

// Floats of a tile-route call's scratch: every seed's slabs, then its blocks'
// slots.
inline long long fwd_scratch(const FwdPlan& p, int hp, int k) {
  return (long long)k * (4LL * hp * hp + p.grid * p.slot);
}

cudaError_t launch_tiles(const float* x, const float* hi, const float* hj, const float* efea,
                         const float* mask, const float* wg, const float* we, const float* b1,
                         const float* w2, const float* b2, const float* wc1, const float* bc1,
                         const float* wc2, const float* bc2, float* totf, float* totm,
                         float* scratch, long long g, int n, int h, int hp, int e, int k,
                         int clip_edges, int ni, int first_row, cudaStream_t stream) {
  const long long num_nodes = g / k * ni;    // one seed's receivers
  FwdPlan p;
  cudaError_t err = fwd_plan(num_nodes, n, hp, e, &p);
  if (err != cudaSuccess) return err;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  float* slabs = scratch;
  float* tiles = slabs + (long long)k * 4 * hp * hp;
  egnn_fwd_split<<<dim3((unsigned)((2LL * hp * hp + 255) / 256), k), 256, 0, stream>>>(
      w2, wc1, slabs, h, hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem(p, hp, e);
  if (p.warpgroups == 2)
    egnn_pairwise_fwd_tiles<2><<<dim3(p.grid, k), 128 * 2 + 32, smem, stream>>>(
        x, hi, hj, efea, mask, wg, we, b1, slabs, b2, bc1, wc2, bc2, totf, totm, tiles, p,
        num_nodes, n, h, hp, e, clip_edges, ni, first_row);
  else
    egnn_pairwise_fwd_tiles<1><<<dim3(p.grid, k), 128 + 32, smem, stream>>>(
        x, hi, hj, efea, mask, wg, we, b1, slabs, b2, bc1, wc2, bc2, totf, totm, tiles, p,
        num_nodes, n, h, hp, e, clip_edges, ni, first_row);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the wrapper allocates for one forward call on the current
// device, at native width h: on the tile route every seed's split weights and
// padded vectors and, where the tiles leave shared memory, one slot per block
// of the launch's grid for each of the K seeds; 0 on the H = 64 kernel; -1
// for a shape the kernel does not take.
extern "C" long long egnn_pairwise_fwd_scratch_floats(long long g, int n, int h, int e, int k,
                                                      int ni) {
  const int hp = fwd_padded(h);
  if (h < 1 || bad_shape(g, n, hp, e, k) || bad_slice(n, ni, 0, k)) return -1;
  long long size = 0;
  const cudaError_t err = with_width(hp, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), FwdTiles>) {
      FwdPlan p;
      const cudaError_t status = fwd_plan(g / k * ni, n, hp, e, &p);
      size = fwd_scratch(p, hp, k);
      return status;
    } else {
      return h == hp ? cudaSuccess : cudaErrorInvalidValue;
    }
  });
  return err == cudaSuccess ? size : -1;
}

// Bytes of dynamic shared memory a block of the forward call of these shapes
// takes on the current device (for reports); -1 as the scratch size.
extern "C" long long egnn_pairwise_fwd_smem_bytes(long long g, int n, int h, int e, int k,
                                                  int ni) {
  const int hp = fwd_padded(h);
  if (h < 1 || bad_shape(g, n, hp, e, k) || bad_slice(n, ni, 0, k)) return -1;
  long long bytes = 0;
  const cudaError_t err = with_width(hp, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), FwdTiles>) {
      FwdPlan p;
      const cudaError_t status = fwd_plan(g / k * ni, n, hp, e, &p);
      bytes = (long long)fwd_smem(p, hp, e);
      return status;
    } else {
      bytes = (long long)(sizeof(float) * smem_floats<decltype(width)::value>());
      return cudaSuccess;
    }
  });
  return err == cudaSuccess ? bytes : -1;
}

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = every
// launch went out). Shapes at native width h: x [G,N,3], hj [G,N,h]; the
// receiver slice [i0, i0 + ni): hi [G,ni,h], efea [G,ni,N,E], mask [ni,N]
// (its rows of the [N,N] mask); wg/b1/b2/bc1/wc2 [K,h], we [K,E,h], w2/wc1
// [K,h,h] in [in,out] layout, bc2 [K]: K weight sets, G = K * B graphs,
// graph g on set g / B (K = 1: one set; K > 1 takes the whole graph, ni =
// N); outputs totf [G,ni,3], totm [G,ni,h]. The H = 64 kernel takes h = 64
// only (the wrapper zero-pads narrower widths to it); the tile route any h.
// hi, hj, w2 and wc1 16-byte aligned; scratch holds
// egnn_pairwise_fwd_scratch_floats floats (null where that is 0). All fp32,
// contiguous, on the current device.
extern "C" int egnn_pairwise_fwd(const float* x, const float* hi, const float* hj,
                                 const float* efea, const float* mask, const float* wg,
                                 const float* we, const float* b1, const float* w2,
                                 const float* b2, const float* wc1, const float* bc1,
                                 const float* wc2, const float* bc2, float* totf, float* totm,
                                 float* scratch, long long g, int n, int h, int e, int k,
                                 int clip_edges, int ni, int i0, void* stream) {
  const int hp = fwd_padded(h);
  if (h < 1 || bad_shape(g, n, hp, e, k) || bad_slice(n, ni, i0, k))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)with_width(hp, e, [&](auto width) {
    if constexpr (std::is_same_v<decltype(width), FwdTiles>)
      return launch_tiles(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1, bc1, wc2, bc2, totf,
                          totm, scratch, g, n, h, hp, e, k, clip_edges, ni, i0, s);
    else if (h != hp)
      return cudaErrorInvalidValue;
    else
      return launch<decltype(width)::value>(x, hi, hj, efea, mask, wg, we, b1, w2, b2, wc1,
                                            bc1, wc2, bc2, totf, totm, g, n, e, k, clip_edges,
                                            ni, i0, s);
  });
}
