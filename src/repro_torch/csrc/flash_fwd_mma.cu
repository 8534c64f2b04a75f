// Tensor-core kernel (mma.sync, sm_80's instruction set, built for
// sm_90a) for the FlashAttention-2 forward on bf16 and f16 inputs
// (repro_torch/kernels/flash_attention/kernel.py, route `flash_fwd.mma`).
// `flash_fwd_launch` (flash_fwd.cu) sends here the 16-bit inputs that the
// wgmma kernel (flash_fwd_wgmma.cu) does not take: a head dim that is not
// a multiple of 8 or passes 128 (gemma3's 240), or a base pointer off 16
// bytes; `flash_fwd_v2_launch` runs it at any 16-bit shape, to time it
// against the wgmma kernel.  This file has no C entry point of its own.
//
// flash_fwd replaces src/repro/kernels/flash_attention/kernel.py
// flash_fwd_pallas / _fwd_kernel: out = softmax(q k^T * scale + mask) v
// and lse = m + log(l) per query row, GQA (kv head = q head // G), causal
// and sliding-window masks from positions, Sq != Skv, ragged lengths.
//
// Bound: operations.  At the serve path's shape (B=4, S=2048, Hq=Hkv=32,
// D=112, causal) the live (query, key) pairs need ~1.2e11 FLOP, ~0.12 ms
// on the bf16 tensor cores, against ~0.07 ms to move q, k, v and out once.
//
// Design (FlashAttention-2 on mma.sync):
// - one block of 4 warps per (64-row q tile, q head, batch); each warp
//   owns 16 query rows.  The q tile is the slowest grid axis and runs
//   from the last tile down, so under the causal mask the heaviest blocks
//   start first and the short ones fill the tail.
// - D is padded to DP = 16 KD (KD in 1, 2, 4, 7, 8, 16) with zero columns
//   in shared memory; rows are DP + 8 elements apart (an odd number of
//   16-byte units), so the eight rows an ldmatrix phase reads fall in
//   eight different bank groups.  Copies are cp.async of 16 bytes where
//   every row start is 16-byte aligned, else 8, 4, or plain 2-byte copies
//   (any D <= 256); rows past Sq or Skv are zero-filled.
// - q is loaded once and kept as mma A fragments in registers.  K and V
//   tiles of 64 rows go through a 2-stage cp.async ring: tile i + 1 is in
//   flight while tile i is multiplied.  At D=112 a block holds 75 KB and
//   168 registers a thread: three blocks an SM.
// - S = Q K^T by mma.sync m16n8k16 with f32 accumulation: products of
//   16-bit inputs are exact in f32, so the scores are the plain version's
//   f32 scores up to summation order.  The scale is applied in f32 after
//   the product (folded with log2 e, for exp2).  Masked entries are -1e30
//   (in the log2 domain), tiles wholly outside the mask are never visited,
//   and only tiles that cross a mask edge test positions.
// - The online softmax stays in registers: row max over the row's four
//   lanes, l summed from the f32 p (per lane, reduced once at the end).
//   p is rounded to the input dtype straight into the A fragments of the
//   P V product (the score fragments are the A layout), and V is read with
//   ldmatrix.trans: the plain version's order of rounding.  l is clamped
//   at 1e-37, so a row with no live key gets finite numbers and lse below
//   -1e29, as the plain version's do.
// - The output tile is staged through the q tile's shared memory and
//   written with the same wide copies.
// wgmma with TMA and warp specialisation is flash_fwd_wgmma.cu (v3), which
// takes every head dim the card serves or trains (64, 112, 128).

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg2 = -1e30f * kLog2e;  // masked score, log2 domain

template <typename T>
__device__ __forceinline__ void copy_out(T* dst, const T* src, int vec) {
  switch (vec) {
    case 8: *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src); break;
    case 4: *reinterpret_cast<uint2*>(dst) =
                *reinterpret_cast<const uint2*>(src); break;
    case 2: *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src); break;
    default: *reinterpret_cast<uint16_t*>(dst) =
                 *reinterpret_cast<const uint16_t*>(src);
  }
}

// up to D=112, at most 168 registers a thread, so three blocks share an SM
// (at D=112 the compiler would take 172 and leave room for two); wider
// heads keep their registers, since capping them spills
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads, KD <= 7 ? 3 : 2)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int Hq,
                     int Hkv, int D, int causal, int window,
                     float scale_log2, int vec) {
  constexpr int DP = 16 * KD;  // padded head dim
  constexpr int SD = DP + 8;   // shared row stride, elements
  constexpr int NT = 2 * KD;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kBQ x SD
  T* Ks = Qs + kBQ * SD;                   // 2 stages x kBK x SD
  T* Vs = Ks + 2 * kBK * SD;               // 2 stages x kBK x SD

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const long long qrow = (long long)Hq * D;    // one position of q / out
  const long long kvrow = (long long)Hkv * D;  // one position of k / v
  const T* qb = q + (long long)b * Sq * qrow + (long long)h * D;
  const T* kb = k + (long long)b * Skv * kvrow + (long long)kvh * D;
  const T* vb = v + (long long)b * Skv * kvrow + (long long)kvh * D;

  // the pad columns [D, DP) of all five tiles, zeroed once
  if (D < DP) {
    const int w = DP - D;
    for (int e = tid; e < 5 * kBQ * w; e += kThreads) {
      const int r = e / w, c = D + (e - r * w);
      reinterpret_cast<uint16_t*>(Qs)[r * SD + c] = 0;
    }
  }

  // kv tiles alive under the mask for some row of this q tile
  int k_begin = 0, k_end = Skv;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  if (window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int kt_lo = k_begin / kBK;
  const int kt_hi = (k_end + kBK - 1) / kBK;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    copy_rows(Ks + stage * kBK * SD, SD, kb + k0 * kvrow, kvrow, kBK,
              Skv - k0, D, vec, tid, kThreads);
    copy_rows(Vs + stage * kBK * SD, SD, vb + k0 * kvrow, kvrow, kBK,
              Skv - k0, D, vec, tid, kThreads);
  };
  copy_rows(Qs, SD, qb + q0 * qrow, qrow, kBQ, Sq - q0, D, vec, tid,
            kThreads);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  float o[NT][4], m[2] = {kNeg2, kNeg2}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0, row0 + 8
  cp_async_wait<0>();
  __syncthreads();  // q and the first kv tile landed
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], Qs + (16 * warp + (lane & 15)) * SD + 16 * kk
                            + (lane >> 4) * 8);

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int stage = i & 1;
    if (i > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile kt landed; every warp is done with kt - 1
    }
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    const T* Kt = Ks + stage * kBK * SD;
    const T* Vt = Vs + stage * kBK * SD;

    // ---- S = Q K^T: 16 rows x 64 keys per warp ------------------------ //
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * SD
                            + 16 * kk + ((lane >> 3) & 1) * 8);
        Mma<T>::run(s[2 * jp], qf[kk], bf[0], bf[1]);
        Mma<T>::run(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // ---- scale and mask ----------------------------------------------- //
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0) ||
                      (window && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          bool live = kpos < Skv;
          if (causal) live = live && kpos <= qpos;
          if (window) live = live && kpos > qpos - window;
          x = live ? x : kNeg2;
        }
        s[j][e] = x;
      }
    }

    // ---- online softmax (rows row0 and row0 + 8) ---------------------- //
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // ---- O += P V: p rounded to T into A fragments -------------------- //
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kc][0], s[2 * kc][1]),
          Mma<T>::pack(s[2 * kc][2], s[2 * kc][3]),
          Mma<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          Mma<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int jp = 0; jp < KD; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, Vt + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * SD
                    + 16 * jp + (lane >> 4) * 8);
        Mma<T>::run(o[2 * jp], pa, bf[0], bf[1]);
        Mma<T>::run(o[2 * jp + 1], pa, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: out = o / l through the warp's q rows, lse = m + log l - //
  float inv[2], lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-37f);
    inv[r] = 1.f / lc[r];
  }
  T* Ow = Qs + 16 * warp * SD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(Ow + g * SD + 8 * j + 2 * t) =
        Mma<T>::pack(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * SD + 8 * j + 2 * t) =
        Mma<T>::pack(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  T* ob = out + (long long)b * Sq * qrow + (long long)h * D;
  const int per_row = D / vec;
  for (int e = lane; e < 16 * per_row; e += 32) {
    const int rr = e / per_row, c = (e - rr * per_row) * vec;
    const int qpos = q0 + 16 * warp + rr;
    if (qpos < Sq) copy_out(ob + qpos * qrow + c, Ow + rr * SD + c, vec);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos < Sq)
        lse[((long long)b * Sq + qpos) * Hq + h] = m[r] * kLn2 + logf(lc[r]);
    }
  }
}

template <typename T, int KD>
int launch_kd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
              int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = (size_t)5 * kBQ * (16 * KD + 8) * sizeof(T);
  // raise the block's shared-memory ceiling once per instantiation (and
  // never inside a CUDA graph capture, which replays launches only)
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  if (B > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
  int vec = 8;
  for (const void* p : {q, k, v, (const void*)out}) {
    const int w = copy_vec(p, D);
    vec = w < vec ? w : vec;
  }
  const dim3 grid(Hq, B, n_qt);
  const float scale_log2 = scale * kLog2e;
  flash_fwd_mma_kernel<T, KD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, Sq, Skv,
      Hq, Hkv, D, causal, window, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
           int window, float scale, cudaStream_t st) {
#define FLASH_MMA_KD(KD)                                                   \
  if (D <= 16 * KD)                                                        \
    return launch_kd<T, KD>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,     \
                            causal, window, scale, st);
  FLASH_MMA_KD(1)
  FLASH_MMA_KD(2)
  FLASH_MMA_KD(4)
  FLASH_MMA_KD(7)
  FLASH_MMA_KD(8)
  FLASH_MMA_KD(16)
#undef FLASH_MMA_KD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tensor-core route of flash_fwd_launch (flash_fwd.cu): dtype 1 bf16,
// 2 f16; anything else is refused.
int flash_fwd_mma(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                  int causal, int window, int dtype, float scale,
                  cudaStream_t st) {
  switch (dtype) {
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
