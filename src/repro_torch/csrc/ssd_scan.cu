// Hopper (sm_90a) kernel for the Mamba2 SSD chunked scan on f32 inputs
// (repro_torch/kernels/ssd/kernel.py), on the CUDA cores, and the C entry
// points, loaded with ctypes: `ssd_scan_launch` sends f32 and f16 here and
// bf16 to a tensor-core kernel, wgmma and TMA (ssd_scan_wgmma.cu) where
// its shape rule holds, else mma.sync (ssd_scan_mma.cu);
// `ssd_scan_v2_launch` runs the mma.sync kernel at any bf16 shape and
// `ssd_scan_v1_launch` this kernel at any dtype, to time the kernels
// against each other.  A launch runs on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported
// at the call site.
//
// ssd_scan replaces src/repro/kernels/ssd/kernel.py ssd_pallas /
// _ssd_kernel.  With cum the inclusive cumsum of dt*A over a chunk of L
// steps, every chunk computes, in f32:
//
//   y     = ((C B^T) .* tril exp(cum_i - cum_j)) (x dt) + (C St) .* exp(cum)
//   state = state * exp(cum_L) + ((x dt) .* exp(cum_L - cum))^T B
//
// Bound: operations.  At the serve path's shape (B=4, S=2048, H=112,
// P=N=64, L=256) the scan reads and writes ~250 MB but does ~5e10 FLOP of
// f32 products inside the chunks; on the f32 ALUs (67 TFLOP/s) that is
// ~1 ms, against ~0.08 ms on the bf16 tensor cores.
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside
// the block: one block of 256 threads per (batch, head) walks the chunks
// in order with the (P, N) state in shared memory (stored transposed,
// [n][p]).  The Pallas kernel keeps the whole L x L decayed C B^T of a
// chunk in VMEM (256 KB at L=256), more than a block's 227 KB, so the
// chunk is cut into 64-row tiles: for each tile of output rows i, the
// C B^T tiles of the rows j <= i are formed one at a time in shared
// memory, decayed, masked and multiplied into the tile's y accumulators,
// which stay in registers (4 rows x up to 8 column groups per thread).
// The state update then streams the chunk's B and x dt tiles once more.
// All products are written out as register-blocked loops over shared
// memory; row strides are padded to 16 mod 32 words so the two half-warps
// of a warp hit different banks.  Steps past S carry dt = 0 (decay 1, no
// contribution), so a ragged final chunk leaves the reference's state.
//
// Occupancy: one block per (batch, head) is 112 blocks at B=1 for 132 SMs
// and 448 at B=4 (the mma.sync kernel splits P across blocks, the wgmma
// kernel runs one block a chunk).

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // chunk rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxCols = 8;    // column groups of 16 per thread (P <= 128)

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

// Load the chunk rows [j0, j0 + kTile) of B (transposed into Bt[n][j]) and
// of x * dt (into Xs[j][p]); with `to_end`, x * dt is also weighted by
// exp(cum_L - cum_j) for the state update.  Rows past the chunk or past S
// are zero.
template <typename T>
__device__ __forceinline__ void load_b_x(
    const T* __restrict__ Bb, const T* __restrict__ xb,
    const float* __restrict__ dtb, const float* cum, float a_last,
    bool to_end, int t0, int j0, int L, int S, int H, int P, int N,
    long long rowB, long long rowX, int sT, int sP, float* Bt, float* Xs) {
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int j = e / N, n = e - (e / N) * N;
    const int t = t0 + j0 + j;
    float v = 0.f;
    if (j0 + j < L && t < S) v = to_f(Bb[(long long)t * rowB + n]);
    Bt[n * sT + j] = v;
  }
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int j = e / P, p = e - (e / P) * P;
    const int t = t0 + j0 + j;
    float v = 0.f;
    if (j0 + j < L && t < S) {
      v = to_f(xb[(long long)t * rowX + p]) * dtb[(long long)t * H];
      if (to_end) v *= expf(a_last - cum[j0 + j]);
    }
    Xs[j * sP + p] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ fin, int S, int H, int P, int G, int N,
                int L) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid - (tid / 16) * 16;

  const int sN = pad_stride(N), sP = pad_stride(P), sT = pad_stride(kTile);
  const int n_tiles = (L + kTile - 1) / kTile;
  const int Lp = n_tiles * kTile;
  float* cum = smem;              // Lp      inclusive cumsum of dt*A
  float* Cs = cum + Lp;           // kTile x sN   C tile [i][n]
  float* Bt = Cs + kTile * sN;    // N x sT       B tile [n][j]
  float* Xs = Bt + N * sT;        // kTile x sP   x*dt tile [j][p]
  float* Ms = Xs + kTile * sP;    // kTile x sT   decayed C B^T tile [i][j]
  float* St = Ms + kTile * sT;    // N x sP       state [n][p]

  const float a = A[h];
  const long long rowX = (long long)H * P;  // one time step of x and y
  const long long rowB = (long long)G * N;  // one time step of B and C
  const T* xb = x + (long long)b * S * rowX + (long long)h * P;
  T* yb = y + (long long)b * S * rowX + (long long)h * P;
  const float* dtb = dt + (long long)b * S * H + h;
  const T* Bb = Bm + (long long)b * S * rowB + (long long)g * N;
  const T* Cb = Cm + (long long)b * S * rowB + (long long)g * N;

  for (int e = tid; e < N * sP; e += kThreads) St[e] = 0.f;
  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    // ---- cum: inclusive scan of dt*a (zero past the chunk and past S) --
    __syncthreads();
    for (int i = tid; i < Lp; i += kThreads) {
      const int t = t0 + i;
      cum[i] = (i < L && t < S) ? dtb[(long long)t * H] * a : 0.f;
    }
    __syncthreads();
    if (tid < 32) {
      const int seg = Lp / 32;
      float run = 0.f;
      for (int k = 0; k < seg; ++k) {
        run += cum[tid * seg + k];
        cum[tid * seg + k] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int k = 0; k < seg; ++k) cum[tid * seg + k] += excl;
    }
    __syncthreads();
    const float a_last = cum[L - 1];

    // ---- y, one 64-row tile at a time --------------------------------- //
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // Cs is free
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int i = e / N, n = e - (e / N) * N;
        const int t = t0 + i0 + i;
        float v = 0.f;
        if (i0 + i < L && t < S) v = to_f(Cb[(long long)t * rowB + n]);
        Cs[i * sN + n] = v;
      }
      __syncthreads();

      // inter-chunk: acc[r][q] = exp(cum_i) * sum_n C[i][n] St[n][p]
      float acc[4][kMaxCols];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * sN + n];
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) {
          if (16 * q < P) {
            const float s = St[n * sP + tx + 16 * q];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][q] += cv[r] * s;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d0 = expf(cum[i0 + ty + 16 * r]);
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) acc[r][q] *= d0;
      }

      // intra-chunk: the tiles j <= i of the decayed C B^T, times x dt
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // Bt, Xs and Ms are free
        load_b_x<T>(Bb, xb, dtb, cum, a_last, false, t0, j0, L, S, H, P, N,
                    rowB, rowX, sT, sP, Bt, Xs);
        __syncthreads();
        float cb[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * sN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bt[n * sT + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) cb[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            Ms[(ty + 16 * r) * sT + tx + 16 * q] =
                (j <= i) ? cb[r][q] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          float mv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty + 16 * r) * sT + j];
#pragma unroll
          for (int q = 0; q < kMaxCols; ++q) {
            if (16 * q < P) {
              const float xv = Xs[j * sP + tx + 16 * q];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][q] += mv[r] * xv;
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const int t = t0 + i;
        if (i < L && t < S) {
#pragma unroll
          for (int q = 0; q < kMaxCols; ++q) {
            const int p = tx + 16 * q;
            if (p < P) yb[(long long)t * rowX + p] = from_f<T>(acc[r][q]);
          }
        }
      }
    }

    // ---- state = state * exp(cum_L) + sum_j B[j] (x dt)[j] exp(...) -- //
    __syncthreads();  // every y tile has read the incoming state
    const float decay = expf(a_last);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e - (e / P) * P;
      St[n * sP + p] *= decay;
    }
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      load_b_x<T>(Bb, xb, dtb, cum, a_last, true, t0, j0, L, S, H, P, N,
                  rowB, rowX, sT, sP, Bt, Xs);
      __syncthreads();
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, p = e - (e / P) * P;
        float s = 0.f;
        for (int j = 0; j < kTile; ++j) s += Bt[n * sT + j] * Xs[j * sP + p];
        St[n * sP + p] += s;
      }
    }
  }

  __syncthreads();
  float* fb = fin + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - (e / N) * N;
    fb[e] = St[n * sP + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* fin, int B, int S, int H, int P,
           int G, int N, int L, cudaStream_t stream) {
  const int n_tiles = (L + kTile - 1) / kTile;
  const size_t floats = (size_t)n_tiles * kTile + (size_t)kTile * pad_stride(N)
      + (size_t)N * pad_stride(kTile) + (size_t)kTile * pad_stride(P)
      + (size_t)kTile * pad_stride(kTile) + (size_t)N * pad_stride(P);
  const size_t bytes = floats * sizeof(float);
  // raise the block's shared-memory ceiling once per instantiation (and
  // never inside a CUDA graph capture, which replays launches only)
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  ssd_scan_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)fin, S, H, P, G, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// the tensor-core routes for bf16: wgmma and TMA (ssd_scan_wgmma.cu),
// mma.sync (ssd_scan_mma.cu)
int ssd_scan_wgmma_chunk(int P, int N, int S, int L);
int ssd_scan_wgmma(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* fin, int B,
                   int S, int H, int P, int G, int N, int L,
                   cudaStream_t st);
int ssd_scan_mma(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fin, int B, int S, int H,
                 int P, int G, int N, int L, cudaStream_t st);

// The rule of kernel.py's ssd_route: a shape the wgmma kernel takes
// (ssd_scan_wgmma_chunk) and x, Bm, Cm and y 16-byte aligned, what a
// tensor map takes.
static bool wgmma_route(int P, int N, int S, int L, const void* x,
                        const void* Bm, const void* Cm, const void* y) {
  if (ssd_scan_wgmma_chunk(P, N, S, L) == 0) return false;
  for (const void* p : {x, Bm, Cm, y})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16 (x, Bm, Cm and y); dt, A and fin are f32.
// bf16 runs the wgmma kernel where wgmma_route holds, else the mma.sync
// kernel; f32 and f16 the CUDA-core kernel above, which keeps M = C B^T
// exp(segsum) dt in f32.  The tensor-core kernels round M to the input
// dtype, and an f16 M overflows above 65504 where the reference's f32 M
// stays finite; bf16 keeps the f32 range.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* fin,
                    int B, int S, int H, int P, int G, int N, int L,
                    int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L, st);
    case 1:
      if (wgmma_route(P, N, S, L, x, Bm, Cm, y))
        return ssd_scan_wgmma(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                              st);
      return ssd_scan_mma(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L, st);
    case 2:
      return launch<__half>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The mma.sync kernel (ssd_scan_mma.cu) at any bf16 shape: the yardstick
// that the wgmma kernel is timed against.  Nothing on a model path calls
// it.
int ssd_scan_v2_launch(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* fin,
                       int B, int S, int H, int P, int G, int N, int L,
                       int dtype, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return ssd_scan_mma(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                      (cudaStream_t)stream);
}

// The CUDA-core kernel above at any dtype: the yardstick that the
// tensor-core route is timed against.  Nothing on the serve path calls it.
int ssd_scan_v1_launch(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* fin,
                       int B, int S, int H, int P, int G, int N, int L,
                       int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G,
                                   N, L, st);
    case 2:
      return launch<__half>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
