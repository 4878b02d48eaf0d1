// Hopper pieces of #1's tile route (egnn_fused_fwd.cu), in inline PTX for
// sm_90a: the mbarriers and bulk copies of its ring of weight slabs, and
// wgmma's m64n64k8 TF32 product with A from registers and B from shared
// memory through a descriptor.
//
// A slab is one 64 x 64 block of a weight's B operand (B(k, n) = W[k][n],
// 64 output columns n over 64 rows k), stored K-major in wgmma's canonical
// layout without swizzle: 8 x 4 core matrices of 128 contiguous bytes (8
// rows n of 4 consecutive k each), element (n, k) at float
//   ((n / 8) * 16 + k / 4) * 32 + (n % 8) * 4 + k % 4,
// so that the two core matrices of a k step lie kLbo bytes apart along k and
// the 8-row groups kSbo bytes apart along n. The split pass writes slabs
// in this layout, big part then small part, and one bulk copy puts a slab
// into a ring stage as it is.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace egnn_tc {

constexpr int kPanel = 64;                        // output columns (and K rows) of a slab
constexpr int kPart = kPanel * kPanel;            // floats of one part (big or small)
constexpr int kSlab = 2 * kPart;                  // floats of a slab: big, then small
constexpr uint32_t kSlabBytes = 4 * kSlab;        // 32 KB: one bulk copy, one ring stage
constexpr uint32_t kLbo = 128;                    // bytes between a k step's two core matrices
constexpr uint32_t kSbo = 2048;                   // bytes between 8-row groups along n
constexpr uint32_t kStepBytes = 2 * kLbo;         // bytes from one k step to the next

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (the bulk
// copies) before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed. The
// spin is bounded: a protocol fault ends in __trap() after about 10 s of
// clocks, a launch error at the next synchronize rather than a hang.
constexpr long long kSpinCycles = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion is counted on bar's transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The descriptor of a slab part's k step at shared byte address addr: no
// swizzle (layout type 0), K-major, kLbo and kSbo (both in 16-byte units).
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most `pending` committed groups of products are in flight.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// Ties registers to this point of the program: the compiler neither moves
// their reads and writes across it nor keeps them elsewhere (the async
// products read and write them outside its view).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d = a b (accumulate = 0) or d += a b over one m64n64k8 TF32 step of the
// warpgroup: a the thread's A fragment (egnn_tf32.cuh's layout, rows of its
// warp), b the slab part's k step at desc, d in the C layout (d[4 j + i]:
// n8 tile j).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

}  // namespace egnn_tc
