// Inline-PTX wrappers for the Hopper-only kernels (flash_fwd_wgmma.cu,
// ssd_scan_wgmma.cu): mbarriers, the async-proxy fence, TMA tensor loads
// and stores, the shared-memory matrix descriptors of wgmma, the warpgroup
// products themselves with their fence / commit / wait, setmaxnreg, named
// barriers, and the thread-block cluster's distributed shared memory
// (a peer block's address, stores and mbarrier arrivals there, waits and
// fences at cluster scope, the cluster barrier).  Everything here needs sm_90a.
//
// wgmma m64nNk16 register layouts (PTX ISA, "Register fragment layout"),
// warp w of the warpgroup, g = lane / 4, t = lane % 4:
//
//   D (64 x N, f32):  d[4j + e]: row 16w + g + 8 (e >> 1),
//                     column 8j + 2t + (e & 1)
//   A (64 x 16, 16-bit, from registers): a0 (16w + g, 2t..2t+1)
//                     a1 (16w + g + 8, 2t..)  a2 (16w + g, 2t+8..)
//                     a3 (16w + g + 8, 2t+8..)
//
// so the accumulator of a product over two neighbouring 8-column blocks,
// packed to 16 bits, is the A operand of one k16 step of the next product
// (P V in attention), as with mma.sync (mma_sm90.cuh).
//
// Shared-memory operands are 128-byte swizzled tiles as TMA writes them
// with CU_TENSOR_MAP_SWIZZLE_128B: a box of 64 16-bit columns and R rows
// is R rows of 128 bytes, 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), and the tile 1024-byte aligned.
//   K-major operand (the reduction dimension contiguous: Q and K of Q K^T):
//     rows 128 bytes apart, 8-row groups SBO = 1024 bytes apart, LBO
//     unused; a k16 step inside the 128-byte row is +32 bytes of start.
//   MN-major operand (the output dimension contiguous: V of P V, "trans
//     b"): 8 rows along the reduction SBO = 1024 bytes apart, the next 64
//     output columns (the next box) LBO bytes apart; a k16 step is 16
//     rows, +2048 bytes of start.
//   tf32 operands are K-major only: a 128-byte row holds 32 of them, a k8
//     step is +32 bytes of start, as a k16 step of 16-bit ones.  The A
//     operand of a tf32 product from registers, warp w: a0 (16w + g, t)
//     a1 (16w + g + 8, t)  a2 (16w + g, t + 4)  a3 (16w + g + 8, t + 4).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace wgmma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (a TMA store of what it wrote)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread-block clusters ------------------------------------------- //
// the address of `p`, in this block's shared memory, in the shared memory
// of block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// two floats into a peer block's shared memory (`addr` from peer_addr)
__device__ __forceinline__ void st_peer_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}

// one float into a peer block's shared memory
__device__ __forceinline__ void st_peer_f32(uint32_t addr, float a) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(a)
               : "memory");
}

// arrive once on an mbarrier in a peer block's shared memory (`addr` from
// peer_addr), releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the writes that peers released
// before their arrivals (mbar_arrive_peer) are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// order this thread's earlier memory operations at cluster scope (before
// another thread's release, after a barrier between them)
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// every thread of every block of the cluster: arrive and wait
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---- TMA ---------------------------------------------------------------- //
// one box of a 4-d tensor map at (c0, c1, c2, c3), innermost first, into
// shared memory; the bytes complete a transaction of `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// one box from shared memory to the tensor at (c0, c1, c2, c3); the parts
// of the box outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- warpgroup registers and barriers ---------------------------------- //
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier `id` (1..15) over `threads` threads of the block: wait there
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// count this thread's arrival at barrier `id` and go on
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------ //
// descriptor of a 128-byte swizzled operand starting at shared address
// `addr` (bits 0-13 start >> 4, 16-29 LBO >> 4, 32-45 SBO >> 4, 62-63
// the layout: 1 = 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D32 WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
#define WGMMA_D64                                                           \
  WGMMA_D32, WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
#define WGMMA_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "  \
  "%29, %30, %31}"
#define WGMMA_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "  \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "  \
  "%57, %58, %59, %60, %61, %62, %63}"

// The products a kernel issues, by 16-bit input type:
//   ss_n64 / ss_n128: D (64 x N, f32) (+)= A (64 x 16) B (16 x N), A and
//            B K-major in shared memory; `accumulate` 0 overwrites D
//   rs_n64 / rs_n128: D (64 x N, f32) += A (64 x 16, registers) B (16 x N),
//            B MN-major in shared memory
template <typename T> struct Wgmma;

#define WGMMA_TYPE(CT, TY)                                                  \
  template <> struct Wgmma<CT> {                                            \
    __device__ __forceinline__ static void ss_n64(float (&d)[32],           \
                                                  uint64_t da, uint64_t db, \
                                                  int accumulate) {         \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
          WGMMA_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                         \
          : WGMMA_D32                                                       \
          : "l"(da), "l"(db), "r"(accumulate));                             \
    }                                                                       \
    __device__ __forceinline__ static void ss_n128(float (&d)[64],          \
                                                   uint64_t da, uint64_t db,\
                                                   int accumulate) {        \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
          WGMMA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                        \
          : WGMMA_D64                                                       \
          : "l"(da), "l"(db), "r"(accumulate));                             \
    }                                                                       \
    __device__ __forceinline__ static void rs_n64(float (&d)[32],           \
                                                  const uint32_t (&a)[4],   \
                                                  uint64_t db) {            \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
          WGMMA_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"         \
          : WGMMA_D32                                                       \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));   \
    }                                                                       \
    __device__ __forceinline__ static void rs_n128(float (&d)[64],          \
                                                   const uint32_t (&a)[4],  \
                                                   uint64_t db) {           \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
          WGMMA_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"         \
          : WGMMA_D64                                                       \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));   \
    }                                                                       \
  };

WGMMA_TYPE(__nv_bfloat16, "bf16")
WGMMA_TYPE(__half, "f16")

// tf32 product: D (64 x 64, f32) += A (64 x 8, tf32 in registers) B (8 x
// 64, tf32, K-major in shared memory)
struct WgmmaTf32 {
  __device__ __forceinline__ static void rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGMMA_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WGMMA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef WGMMA_TYPE
#undef WGMMA_R64
#undef WGMMA_R32
#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_D8

}  // namespace wgmma_sm90
