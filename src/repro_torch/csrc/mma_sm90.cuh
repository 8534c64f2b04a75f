// Inline-PTX wrappers for the tensor-core kernels (flash_fwd_mma.cu,
// ssd_scan_mma.cu): cp.async copies with commit/wait groups, ldmatrix,
// and the warp-level mma.sync products (m16n8k16 bf16/f16 and m16n8k8
// tf32, f32 accumulate).  Fragment layouts, with g = lane / 4 and
// t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16/k8"):
//
//   m16n8k16 A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)
//                              a2 (g, 2t+8..)    a3 (g+8, 2t+8..)
//   m16n8k16 B (16 x 8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   m16n8k8 tf32 A (16 x 8):   a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4)
//   m16n8k8 tf32 B (8 x 8):    b0 (k t, n g)  b1 (k t+4, n g)
//   C / D (16 x 8, f32):       c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
//
// The C fragment of two neighbouring n-tiles is, packed to 16 bits, the A
// fragment of one 16-deep k-step: a product's output feeds the next
// product from registers (P V in attention, M x in the SSD scan).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: global -> shared without registers ---------------------- //
// Copies `bytes` (4, 8 or 16) when `pred`, else writes that many zeros.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16, "cp.async size");
  const int n = pred ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(Bytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of `cols` 16-bit elements from global memory (row r at
// src + r * src_stride) into shared memory (row r at dst + r * dst_stride),
// VEC elements (8, 4, 2 or 1) a copy, by the block's `nthreads` threads;
// rows r >= `valid` are zero-filled.  Elements at and past `cols` in a
// shared row are left as they are (the kernels zero them once).  With
// VEC = 1 (a row of an odd length) the copy is an ordinary load and store.
// Each thread walks its copies with running (row, column) indices: no
// division in the loop, whose instructions would rival the copies'.
template <int VEC, typename T>
__device__ __forceinline__ void copy_rows_vec(T* dst, int dst_stride,
                                              const T* src,
                                              long long src_stride, int rows,
                                              int valid, int cols, int tid,
                                              int nthreads) {
  const int per_row = cols / VEC;
  if (per_row == 0) return;
  const int dr = nthreads / per_row, dc = nthreads - dr * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  while (r < rows) {
    const bool ok = r < valid;
    T* d = dst + r * dst_stride + c * VEC;
    const T* s = ok ? src + r * src_stride + c * VEC : src;
    if constexpr (VEC == 1) {
      *reinterpret_cast<uint16_t*>(d) =
          ok ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
    } else {
      cp_async<2 * VEC>(d, s, ok);
    }
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// copy_rows_vec with the copy width chosen at run time (`vec`, from
// copy_vec on the host)
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride,
                                          const T* src, long long src_stride,
                                          int rows, int valid, int cols,
                                          int vec, int tid, int nthreads) {
  switch (vec) {
    case 8:
      copy_rows_vec<8>(dst, dst_stride, src, src_stride, rows, valid, cols,
                       tid, nthreads);
      break;
    case 4:
      copy_rows_vec<4>(dst, dst_stride, src, src_stride, rows, valid, cols,
                       tid, nthreads);
      break;
    case 2:
      copy_rows_vec<2>(dst, dst_stride, src, src_stride, rows, valid, cols,
                       tid, nthreads);
      break;
    default:
      copy_rows_vec<1>(dst, dst_stride, src, src_stride, rows, valid, cols,
                       tid, nthreads);
  }
}

// The widest copy, in 16-bit elements, that every row start can take: the
// rows begin at multiples of `row_elems` from `base`.
inline int copy_vec(const void* base, long long row_elems) {
  for (int vec = 8; vec > 1; vec /= 2)
    if (row_elems % vec == 0 &&
        reinterpret_cast<uintptr_t>(base) % (2 * vec) == 0)
      return vec;
  return 1;
}

// ---- ldmatrix: four 8 x 8 tiles of 16-bit elements --------------------- //
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- mma.sync ----------------------------------------------------------- //
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 values rounded to nearest, lo in the low half
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <> struct Mma<__half> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static float to_f(__half v) {
    return __half2float(v);
  }
  __device__ __forceinline__ static __half from_f(float v) {
    return __float2half_rn(v);
  }
};

// f32 rounded to nearest tf32 (10 mantissa bits), as the tf32 mma reads it
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_sm90
