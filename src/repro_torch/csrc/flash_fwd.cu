// Hopper (sm_90a) kernel for the FlashAttention-2 forward on f32 inputs
// (repro_torch/kernels/flash_attention/kernel.py), on the CUDA cores, and
// the C entry points, loaded with ctypes: `flash_fwd_launch` sends f32 here
// and bf16 / f16 to a tensor-core kernel, by a rule decided before the
// launch (`wgmma_route`): wgmma and TMA (flash_fwd_wgmma.cu) for a head
// dim that is a multiple of 8 up to 128 with 16-byte aligned tensors,
// else mma.sync (flash_fwd_mma.cu); `flash_fwd_v1_launch` runs this
// kernel at any dtype and `flash_fwd_v2_launch` the mma.sync kernel at any
// 16-bit shape, to time them against the kernels that replaced them.  A
// launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at the call site.
//
// flash_fwd replaces src/repro/kernels/flash_attention/kernel.py
// flash_fwd_pallas / _fwd_kernel: out = softmax(q k^T * scale + mask) v
// and lse = m + log(l) per query row, with GQA (kv head = q head // G),
// causal and sliding-window masks from positions, non-square Sq != Skv and
// ragged lengths.
//
// Bound: operations.  At the serve path's shape (B=4, S=2048, Hq=Hkv=32,
// D=112, causal) the forward does ~1.2e11 FLOP for ~235 MB of q, k, v and
// out: ~0.12 ms on the bf16 tensor cores, ~1.8 ms on the f32 ALUs that
// this first kernel uses.
//
// Design: one block of 256 threads (16 x 16) per (64-row q tile, q head,
// batch); the kernel picks its own tiles (the reference's 1024-wide blocks
// are TPU choices).  The q tile sits in shared memory as f32; the loop
// walks 64-row kv tiles, skipping tiles wholly outside the causal/window
// mask as the Pallas kernel skips dead blocks.  Each thread owns a 4 x 4
// block of scores (rows ty + 16 r, keys tx + 16 c) and the same rows of
// the output accumulator (columns tx + 16 j, j < NJ, so head_dim 112 or
// any D <= 256 needs no power of two).  Per kv tile: K lands transposed
// in shared memory and Q K^T is a register-blocked f32 loop; the online
// softmax (m, l, and the rescale of the accumulator) runs in registers
// with the row max and sum reduced over the 16 lanes of a row; p is cast
// to the input dtype (as the reference's brick scan casts it) into shared
// memory; V then reuses K's buffer for P V.  Masked scores are -1e30, not
// -inf, and l is clamped at 1e-37, so rows with nothing to attend give the
// reference's finite numbers.

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// a row stride >= cols that is 16 mod 32 words
__host__ __device__ __forceinline__ int pad_stride(int cols) {
  return ((cols + 15) / 32) * 32 + 16;
}

__host__ __device__ __forceinline__ int kv_buffer(int D) {
  const int kt = D * pad_stride(kBK), v = kBK * pad_stride(D);
  return kt > v ? kt : v;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                 int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid - (tid / 16) * 16;

  const int sD = pad_stride(D), sK = pad_stride(kBK);
  float* Qs = smem;                 // kBQ x sD          q tile [r][d]
  float* KV = Qs + kBQ * sD;        // K^T [d][c], then V [c][d]
  float* Ps = KV + kv_buffer(D);    // kBQ x sK          p tile [r][c]

  const long long qrow = (long long)Hq * D;    // one position of q / out
  const long long kvrow = (long long)Hkv * D;  // one position of k / v
  const T* qb = q + (long long)b * Sq * qrow + (long long)h * D;
  const T* kb = k + (long long)b * Skv * kvrow + (long long)kvh * D;
  const T* vb = v + (long long)b * Skv * kvrow + (long long)kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - (e / D) * D;
    const int qpos = q0 + r;
    Qs[r * sD + d] = qpos < Sq ? to_f(qb[(long long)qpos * qrow + d]) : 0.f;
  }

  // kv tiles alive under the mask for some row of this q tile
  int k_begin = 0, k_end = Skv;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  if (window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int kt_lo = k_begin / kBK;
  const int kt_hi = (k_end + kBK - 1) / kBK;

  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[r][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // KV and Ps are free
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - (e / D) * D;
      const int kpos = k0 + c;
      KV[d * sK + c] =
          kpos < Skv ? to_f(kb[(long long)kpos * kvrow + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * sD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = KV[d * sK + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float rowmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool live = kpos < Skv;
        if (causal) live = live && kpos <= qpos;
        if (window) live = live && kpos > qpos - window;
        s[r][c] = live ? s[r][c] * scale : kNegInf;
        rowmax = fmaxf(rowmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[r], rowmax);
      float rowsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        rowsum += p;
        Ps[(ty + 16 * r) * sK + tx + 16 * c] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rowsum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[r][j] *= corr;
      m[r] = m_new;
    }
    __syncthreads();  // K^T fully read; Ps written

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - (e / D) * D;
      const int kpos = k0 + c;
      KV[c * sD + d] =
          kpos < Skv ? to_f(vb[(long long)kpos * kvrow + d]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty + 16 * r) * sK + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (16 * j < D) {
          const float vv = KV[c * sD + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) o[r][j] += pv[r] * vv;
        }
      }
    }
  }

  T* ob = out + (long long)b * Sq * qrow + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
    if (qpos >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[(long long)qpos * qrow + d] = from_f<T>(o[r][j] / lc);
    }
    if (tx == 0) lse[((long long)b * Sq + qpos) * Hq + h] = m[r] + logf(lc);
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
              int causal, int window, float scale, cudaStream_t stream) {
  const size_t floats = (size_t)kBQ * pad_stride(D) + kv_buffer(D)
      + (size_t)kBQ * pad_stride(kBK);
  const size_t bytes = floats * sizeof(float);
  // raise the block's shared-memory ceiling once per instantiation (and
  // never inside a CUDA graph capture, which replays launches only)
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, Sq, Skv,
      Hq, Hkv, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
           int window, float scale, cudaStream_t st) {
  if (D <= 16)
    return launch_nj<T, 1>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, scale, st);
  if (D <= 32)
    return launch_nj<T, 2>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, scale, st);
  if (D <= 64)
    return launch_nj<T, 4>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, scale, st);
  if (D <= 128)
    return launch_nj<T, 8>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, scale, st);
  if (D <= 256)
    return launch_nj<T, 16>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                            causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the tensor-core routes for bf16 and f16: wgmma and TMA
// (flash_fwd_wgmma.cu), mma.sync (flash_fwd_mma.cu)
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                    int D, int causal, int window, int dtype,
                    float scale, cudaStream_t st);
int flash_fwd_mma(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                  int causal, int window, int dtype, float scale,
                  cudaStream_t st);

// The rule of kernel.py's flash_route: a head dim that a tensor map and
// wgmma take (a multiple of 8 up to 128) and base pointers that a tensor
// map takes (16-byte aligned).
static bool wgmma_route(int D, const void* q, const void* k, const void* v,
                        const void* out) {
  if (D % 8 != 0 || D > 128) return false;
  for (const void* p : {q, k, v, out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16 (q, k, v and out); lse is f32.  f32 runs
// the CUDA-core kernel above; bf16 and f16 the wgmma kernel where
// wgmma_route holds, else the mma.sync kernel.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                     int D, int causal, int window, int dtype,
                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D, causal,
                         window, scale, st);
  if (wgmma_route(D, q, k, v, out))
    return flash_fwd_wgmma(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, dtype, scale, st);
  return flash_fwd_mma(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D, causal,
                       window, dtype, scale, st);
}

// The mma.sync kernel (flash_fwd_mma.cu) at any 16-bit shape: the
// yardstick that the wgmma kernel is timed against.  Nothing on a model
// path calls it.
int flash_fwd_v2_launch(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Skv, int Hq,
                        int Hkv, int D, int causal, int window, int dtype,
                        float scale, void* stream) {
  return flash_fwd_mma(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D, causal,
                       window, dtype, scale, (cudaStream_t)stream);
}

// The CUDA-core kernel above at any dtype: the yardstick that the
// tensor-core routes are timed against.  Nothing on a model path calls it.
int flash_fwd_v1_launch(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Skv, int Hq,
                        int Hkv, int D, int causal, int window, int dtype,
                        float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D, causal,
                           window, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                                   causal, window, scale, st);
    case 2:
      return launch<__half>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                            causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
