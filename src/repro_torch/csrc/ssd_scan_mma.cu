// Hopper (sm_90a) tensor-core kernel for the Mamba2 SSD chunked scan on
// bf16 inputs (repro_torch/kernels/ssd/kernel.py).
// `ssd_scan_launch` (ssd_scan.cu) sends dtype 1 (bf16) here and f32 and
// f16 to the CUDA-core kernel there; this file has no C entry point of its
// own.
//
// ssd_scan replaces src/repro/kernels/ssd/kernel.py ssd_pallas /
// _ssd_kernel.  With cum the inclusive cumsum of dt*A over a chunk of L
// steps, every chunk computes
//
//   M_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j        (j <= i, else 0)
//   y     = M x + (C state^T) .* exp(cum_i)
//   state = state * exp(cum_L) + ((dt exp(cum_L - cum)) .* x)^T B
//
// Bound: bytes at the serve path's shape (B=4, S=2048, H=112, P=N=64,
// L=256): ~250 MB of x, dt, B, C, y and state, ~0.07 ms, against ~5e10
// FLOP, ~0.05 ms on the bf16 tensor cores.
//
// Design:
// - one block of 4 warps per (batch, head, P-slice of 16, 32 or 64
//   columns: the narrowest that holds P, at most 64).  y[:, p] and
//   state[p, :] depend only on column p of x, so the slices are
//   independent; C B^T is computed once per slice.  At the serve shape
//   (P=64) one slice holds a head: 448 blocks at B=4.  Slices of 32 (896
//   blocks) fill the card better but compute C B^T twice a head, and ran
//   slower on the card.  The block walks its chunks in order with its
//   (P-slice x N) state in f32 in shared memory.
// - a chunk is cut into 64-row tiles.  For output tile i, every source
//   tile j <= i is one step: C_i B_j^T, the decay and dt folded into M,
//   masked on the diagonal tile, and M x_j accumulated; the last output
//   tile's steps also accumulate the state update, so a chunk of T tiles
//   reads B and x T(T+1)/2 times and needs no pass of its own for the
//   state.  Each warp owns 16 output rows (and, for the state, 16 p rows
//   and all, half or a quarter of n).
// - C, B and x tiles go through a 2-stage cp.async ring: the next step's
//   tiles are in flight while this one computes.  Rows past L or S are
//   zero-filled; steps past S carry dt = 0.  N is padded to 16, 32, 64 or
//   128 (a compile-time width, so the products' loops unroll) and the
//   slice to 16, 32 or 64 with zero columns in shared memory (P = N = 8
//   works).  Row strides are an odd number of 16-byte units, so ldmatrix
//   is free of bank conflicts.  About 74 KB a block at P=N=64, L=256.
// - products: C_i B_j^T is mma.sync m16n8k16 in the input dtype with f32
//   accumulation (exact inputs); its f32 fragments are scaled into M and
//   packed straight into the A fragments of M x_j (x exact, read with
//   ldmatrix.trans).  C state^T and the state update take the f32 operands
//   through tf32 mma.sync m16n8k8 (C and B are exact in tf32).
// - rounding points (the plain version is f32 throughout): M is rounded to
//   bf16, whose range is f32's, so M cannot overflow (an f16 M would above
//   65504, which is why f16 takes the CUDA-core kernel); the state, as the
//   right operand of
//   C state^T, and the decay-scaled (dt exp(cum_L - cum_j) x_j) of the
//   state update are rounded to tf32.  The state itself is carried in f32.
//   tests/test_torch_flash_ssd.py emulates these rounding points on the
//   CPU (B=1, S=1024, H=4, P=N=64, chunk 256, bf16 inputs) and holds them
//   within 1e-2 of max|y| and of max|state| of the f32 quadratic form;
//   tf32 keeps the f32 range, so a large state cannot overflow either.
// - the difference form exp(cum_i - cum_j) is kept; the factored form
//   exp(cum_i) exp(-cum_j) overflows on long chunks.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kTile = 64;      // chunk rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows

// the f32 bits of a 16-bit input: a valid tf32 operand as it is
template <typename T>
__device__ __forceinline__ uint32_t tf32_of(T v) {
  return __float_as_uint(Mma<T>::to_f(v));
}

struct Step {
  int c, it, jt;  // chunk, output tile, source tile (jt <= it)
};

// the step after `s`, false after the last one
__device__ __forceinline__ bool next_step(Step& s, int S, int L) {
  if (s.jt < s.it) {
    ++s.jt;
    return true;
  }
  const int Lc = min(L, S - s.c * L);
  if ((s.it + 1) * kTile < Lc) {
    ++s.it;
    s.jt = 0;
    return true;
  }
  if ((s.c + 1) * L < S) {
    ++s.c;
    s.it = s.jt = 0;
    return true;
  }
  return false;
}

template <typename T, int PS, int NK>
__global__ void __launch_bounds__(kThreads)
ssd_scan_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ fin, int S, int H, int P, int G,
                    int N, int L, int vec_x, int vec_bc) {
  constexpr int MT = PS / 16;  // 16-row p tiles of the state, 1 to 4
  constexpr int NG = 4 / MT;   // warps sharing a p tile, split over n
  constexpr int UN = 16 / NG;  // most 8-wide n tiles a warp updates
  constexpr int SX = PS + 8;   // x tile row stride, elements
  constexpr int PT = PS / 8;   // 8-wide p tiles of y
  constexpr int NP = 16 * NK;  // padded N
  constexpr int SN = NP + 8;   // C / B tile row stride, elements
  constexpr int SS = NP + 4;   // state row stride, floats
  const int Lp = (L + kTile - 1) / kTile * kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);  // 2 stages x kTile x SN
  T* Bs = Cs + 2 * kTile * SN;             // 2 stages x kTile x SN
  T* Xs = Bs + 2 * kTile * SN;             // 2 stages x kTile x SX
  float* St = reinterpret_cast<float*>(Xs + 2 * kTile * SX);  // PS x SS
  float* cum = St + PS * SS;  // Lp: inclusive cumsum of dt*A
  float* dtv = cum + Lp;      // Lp: dt (0 past the chunk)
  float* wv = dtv + Lp;       // Lp: dt exp(cum_L - cum)

  const int nps = (P + PS - 1) / PS;
  const int ps = blockIdx.x % nps;
  const int bh = blockIdx.x / nps;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int grp = h / (H / G);
  const int p0 = ps * PS;
  const int pw = min(PS, P - p0);  // live columns of this slice
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const float a = A[h];
  const long long rowX = (long long)H * P;  // one time step of x and y
  const long long rowB = (long long)G * N;  // one time step of B and C
  const T* xb = x + (long long)b * S * rowX + (long long)h * P + p0;
  T* yb = y + (long long)b * S * rowX + (long long)h * P + p0;
  const float* dtb = dt + (long long)b * S * H + h;
  const T* Bb = Bm + (long long)b * S * rowB + (long long)grp * N;
  const T* Cb = Cm + (long long)b * S * rowB + (long long)grp * N;

  // zero the pad columns (never written by the copies) and the state
  uint16_t* raw = reinterpret_cast<uint16_t*>(Cs);
  if (N < NP) {
    const int w = NP - N;
    for (int e = tid; e < 4 * kTile * w; e += kThreads) {
      const int r = e / w;
      raw[r * SN + N + (e - r * w)] = 0;
    }
  }
  if (pw < PS) {
    const int w = PS - pw;
    uint16_t* rx = reinterpret_cast<uint16_t*>(Xs);
    for (int e = tid; e < 2 * kTile * w; e += kThreads) {
      const int r = e / w;
      rx[r * SX + pw + (e - r * w)] = 0;
    }
  }
  for (int e = tid; e < PS * SS; e += kThreads) St[e] = 0.f;

  // the tiles of step s into ring stage `stage` (C into `cstage` when the
  // step starts an output tile)
  auto issue = [&](const Step& s, int stage, int cstage) {
    const int t0 = s.c * L;
    const int Lc = min(L, S - t0);
    const int j0 = s.jt * kTile;
    copy_rows(Bs + stage * kTile * SN, SN, Bb + (t0 + j0) * rowB, rowB,
              kTile, Lc - j0, N, vec_bc, tid, kThreads);
    copy_rows(Xs + stage * kTile * SX, SX, xb + (t0 + j0) * rowX, rowX,
              kTile, Lc - j0, pw, vec_x, tid, kThreads);
    if (s.jt == 0) {
      const int i0 = s.it * kTile;
      copy_rows(Cs + cstage * kTile * SN, SN, Cb + (t0 + i0) * rowB, rowB,
                kTile, Lc - i0, N, vec_bc, tid, kThreads);
    }
  };

  Step issued = {0, 0, 0};  // the last step whose tiles were issued
  issue(issued, 0, 0);
  cp_async_commit();
  int n_step = 0, n_itile = 0;  // steps and output tiles so far

  const int r_lo = 16 * warp + g;  // this lane's tile rows: r_lo, r_lo + 8
  const int mt = warp % MT, ng = warp / MT;  // the state rows / n tiles
  float upd[UN][4];
#pragma unroll
  for (int u = 0; u < UN; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) upd[u][e] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int Lc = min(L, S - t0);
    const int n_tiles = (Lc + kTile - 1) / kTile;

    // ---- cum, dt and the state weights of this chunk ------------------ //
    for (int i = tid; i < Lp; i += kThreads) {
      const float d = i < Lc ? dtb[(long long)(t0 + i) * H] : 0.f;
      dtv[i] = d;
      cum[i] = d * a;
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
    const float a_last = cum[Lc - 1];
    for (int i = tid; i < Lp; i += kThreads)
      wv[i] = dtv[i] * expf(a_last - cum[i]);

    for (int it = 0; it < n_tiles; ++it, ++n_itile) {
      const int i0 = it * kTile;
      const bool last_tile = it == n_tiles - 1;
      float acc[PT][4];
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      for (int jt = 0; jt <= it; ++jt, ++n_step) {
        const int j0 = jt * kTile;
        cp_async_wait<0>();
        __syncthreads();  // this step's tiles landed; the last step is done
        if (next_step(issued, S, L))
          issue(issued, (n_step + 1) & 1, (n_itile + (issued.jt == 0)) & 1);
        cp_async_commit();
        const T* Ct = Cs + (n_itile & 1) * kTile * SN;
        const T* Bt = Bs + (n_step & 1) * kTile * SN;
        const T* Xt = Xs + (n_step & 1) * kTile * SX;

        if (jt == 0) {
          // ---- inter-chunk: acc = (C state^T) .* exp(cum_i), tf32 ----- //
#pragma unroll
          for (int n0 = 0; n0 < NP; n0 += 8) {
            const uint32_t af[4] = {
                tf32_of(Ct[r_lo * SN + n0 + t]),
                tf32_of(Ct[(r_lo + 8) * SN + n0 + t]),
                tf32_of(Ct[r_lo * SN + n0 + t + 4]),
                tf32_of(Ct[(r_lo + 8) * SN + n0 + t + 4])};
#pragma unroll
            for (int j = 0; j < PT; ++j)
              mma_tf32(acc[j], af, tf32(St[(8 * j + g) * SS + n0 + t]),
                       tf32(St[(8 * j + g) * SS + n0 + t + 4]));
          }
          const float d0 = expf(cum[i0 + r_lo]);
          const float d1 = expf(cum[i0 + r_lo + 8]);
#pragma unroll
          for (int j = 0; j < PT; ++j) {
            acc[j][0] *= d0;
            acc[j][1] *= d0;
            acc[j][2] *= d1;
            acc[j][3] *= d1;
          }
        }

        // ---- intra-chunk: M = C_i B_j^T decayed, acc += M x_j --------- //
        // on the diagonal tile, source rows past this warp's are masked
        const int jp_max = jt == it ? warp : 3;
        float cb[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < NP; k0 += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, Ct + (16 * warp + (lane & 15)) * SN + k0
                              + (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp > jp_max) break;
            uint32_t bf[4];
            ldmatrix_x4(bf, Bt + (16 * jp + (lane & 7) + ((lane >> 4) << 3))
                                     * SN + k0 + ((lane >> 3) & 1) * 8);
            Mma<T>::run(cb[2 * jp], af, bf[0], bf[1]);
            Mma<T>::run(cb[2 * jp + 1], af, bf[2], bf[3]);
          }
        }
        const float ci[2] = {cum[i0 + r_lo], cum[i0 + r_lo + 8]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = 8 * j + 2 * t + (e & 1);  // tile-local source
            const float mv = cb[j][e] * __expf(ci[e >> 1] - cum[j0 + jl]) *
                             dtv[j0 + jl];
            cb[j][e] = (jt < it || jl <= r_lo + 8 * (e >> 1)) ? mv : 0.f;
          }
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          if (kc > jp_max) break;
          const uint32_t ma[4] = {
              Mma<T>::pack(cb[2 * kc][0], cb[2 * kc][1]),
              Mma<T>::pack(cb[2 * kc][2], cb[2 * kc][3]),
              Mma<T>::pack(cb[2 * kc + 1][0], cb[2 * kc + 1][1]),
              Mma<T>::pack(cb[2 * kc + 1][2], cb[2 * kc + 1][3])};
#pragma unroll
          for (int pp = 0; pp < PS / 16; ++pp) {
            uint32_t bf[4];
            ldmatrix_x4_trans(
                bf, Xt + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * SX
                        + 16 * pp + (lane >> 4) * 8);
            Mma<T>::run(acc[2 * pp], ma, bf[0], bf[1]);
            Mma<T>::run(acc[2 * pp + 1], ma, bf[2], bf[3]);
          }
        }

        // ---- state update from the last output tile's steps, tf32 ----- //
        if (last_tile) {
          const int pr = 16 * mt + g;
#pragma unroll
          for (int ks = 0; ks < kTile / 8; ++ks) {
            const int jl = 8 * ks + t;
            const float w0 = wv[j0 + jl], w1 = wv[j0 + jl + 4];
            const uint32_t af[4] = {
                tf32(w0 * Mma<T>::to_f(Xt[jl * SX + pr])),
                tf32(w0 * Mma<T>::to_f(Xt[jl * SX + pr + 8])),
                tf32(w1 * Mma<T>::to_f(Xt[(jl + 4) * SX + pr])),
                tf32(w1 * Mma<T>::to_f(Xt[(jl + 4) * SX + pr + 8]))};
#pragma unroll
            for (int u = 0; u < UN; ++u) {
              const int nt = ng + NG * u;
              if (8 * nt < NP)
                mma_tf32(upd[u], af, tf32_of(Bt[jl * SN + 8 * nt + g]),
                         tf32_of(Bt[(jl + 4) * SN + 8 * nt + g]));
            }
          }
        }
      }

      // ---- y rows of this output tile --------------------------------- //
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int il = i0 + r_lo + 8 * r;
        if (il >= Lc) continue;
        T* yr = yb + (long long)(t0 + il) * rowX;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = 8 * j + 2 * t;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          if (vec_x >= 2 && p + 1 < pw) {
            *reinterpret_cast<uint32_t*>(yr + p) = Mma<T>::pack(v0, v1);
          } else {
            if (p < pw) yr[p] = Mma<T>::from_f(v0);
            if (p + 1 < pw) yr[p + 1] = Mma<T>::from_f(v1);
          }
        }
      }
    }

    // ---- state = state * exp(cum_L) + update -------------------------- //
    __syncthreads();  // every warp has read the incoming state
    const float decay = expf(a_last);
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int nt = ng + NG * u;
      if (8 * nt >= NP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& s = St[(16 * mt + g + 8 * (e >> 1)) * SS + 8 * nt + 2 * t
                      + (e & 1)];
        s = s * decay + upd[u][e];
        upd[u][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* fb = fin + ((long long)b * H + h) * P * N + (long long)p0 * N;
  for (int e = tid; e < pw * N; e += kThreads) {
    const int p = e / N, n = e - (e / N) * N;
    fb[e] = St[p * SS + n];
  }
}

template <typename T, int PS, int NK>
int launch_ps(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* fin, int B, int S, int H, int P,
              int G, int N, int L, cudaStream_t stream) {
  const int NP = 16 * NK;
  const int Lp = (L + kTile - 1) / kTile * kTile;
  const size_t bytes = sizeof(T) * (size_t)2 * kTile * (2 * (NP + 8) + PS + 8)
      + sizeof(float) * ((size_t)PS * (NP + 4) + 3 * (size_t)Lp);
  // raise the block's shared-memory ceiling once per instantiation (and
  // never inside a CUDA graph capture, which replays launches only)
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_mma_kernel<T, PS, NK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const int vec_x = std::min(copy_vec(x, P), copy_vec(y, P));
  const int vec_bc = std::min(copy_vec(Bm, N), copy_vec(Cm, N));
  const long long blocks = (long long)B * H * ((P + PS - 1) / PS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_scan_mma_kernel<T, PS, NK><<<(unsigned)blocks, kThreads, bytes,
                                   stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)fin, S, H, P, G, N, L, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

template <typename T, int PS>
int launch_nk(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* fin, int B, int S, int H, int P,
              int G, int N, int L, cudaStream_t st) {
#define SSD_MMA_NK(NK)                                                     \
  if (N <= 16 * NK)                                                        \
    return launch_ps<T, PS, NK>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G,  \
                                N, L, st);
  SSD_MMA_NK(1)
  SSD_MMA_NK(2)
  SSD_MMA_NK(4)
  SSD_MMA_NK(8)
#undef SSD_MMA_NK
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* fin, int B, int S, int H, int P,
           int G, int N, int L, cudaStream_t st) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  if (P <= 16)
    return launch_nk<T, 16>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                            st);
  if (P <= 32)
    return launch_nk<T, 32>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                            st);
  return launch_nk<T, 64>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L, st);
}

}  // namespace

// The tensor-core route of ssd_scan_launch (ssd_scan.cu), bf16 only.
int ssd_scan_mma(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fin, int B, int S, int H,
                 int P, int G, int N, int L, cudaStream_t st) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, L,
                               st);
}
