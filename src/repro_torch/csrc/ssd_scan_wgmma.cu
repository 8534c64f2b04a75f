// Hopper (sm_90a) kernel for the Mamba2 SSD chunked scan on bf16 inputs
// whose P and N are multiples of 8 up to 128, whose chunk is a multiple of
// 64 up to 256 (or one chunk of S rounded up to 64), and whose x, B, C and
// y start 16-byte aligned (repro_torch/kernels/ssd/kernel.py, route
// `ssd_scan.wgmma`): wgmma on the tensor cores, TMA loads and stores, and
// the chunks' states scanned across a thread-block cluster.
// `ssd_scan_launch` (ssd_scan.cu) sends those inputs here, any other bf16
// shape to the mma.sync kernel (ssd_scan_mma.cu) and f32 and f16 to the
// CUDA-core kernel (ssd_scan.cu); this file has no C entry point of its
// own.
//
// ssd_scan replaces src/repro/kernels/ssd/kernel.py ssd_pallas /
// _ssd_kernel.  With cum the inclusive cumsum of dt*A over a chunk of L
// steps, every chunk computes
//
//   M_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j        (j <= i, else 0)
//   y     = M x + (C state_in^T) .* exp(cum_i)
//   state_out = state_in * exp(cum_L) + ((dt exp(cum_L - cum)) .* x)^T B
//
// Only the last two terms need the incoming state, and the part chained
// from chunk to chunk is one (P x N) f32 multiply-add a chunk.
//
// Bound: bytes at zamba2's prefill (B=4, S=2048, H=112, P=N=64, L=256):
// 247 MB of x, dt, B, C, y and the final state, 0.074 ms, against 4.5e10
// FLOP, 0.046 ms on the bf16 tensor cores.
//
// Design:
// - Parallel over chunks.  The Pallas grid's sequential chunk axis, which
//   the mma.sync kernel walked in one block per (batch, head), becomes a
//   grid axis: one block of two warpgroups per (chunk slot, head and
//   64-column slice of P, batch), in clusters of 8 blocks along the chunks
//   (one block where S is one chunk): 3,584 blocks at zamba2's prefill
//   where the mma.sync kernel ran 448, 448 at a (2, 2) train rank's B=1
//   H=56 where it ran 56.  Block r takes chunks r, r + 8, ... in rounds
//   (S > 8 L); a slot past the last chunk still scans its rows (below).
//   y[:, p] and state[p, :] depend on column p of x alone, so P > 64 is
//   two independent slices, each forming its own C B^T.
// - The states across the cluster, each round: (a) every block sends rows
//   [8k, 8k + 8) of its chunk's update, and its decay exp(cum_L), to
//   block k through distributed shared memory (st.shared::cluster), and
//   the 32 threads that hold them arrive on block k's mbarrier (release
//   at cluster scope); (b) block k scans its rows over the round's chunks
//   in order, state = state * decay + update in f32, keeping the entering
//   state of each and carrying the last into the next round (the chunk at
//   S's end: the final state, written from there), and tells every block
//   it has read its slices; (c) it sends each chunk's entering rows back
//   to the chunk's block, rounded to tf32, in the K-major layout of
//   y_off's operand, and arrives on that block's mbarrier.  No global
//   flag, counter or scratch.  Why not a chain from block c to c + 1 (as
//   the TPU's sequential grid would have it): a hop cost ~1.6 us (16 KB of
//   remote stores, the release's drain, the wake-up), 11 us of a 23 us
//   block at zamba2's shapes, as slow as mma.sync (0.72 ms at the
//   prefill); cluster barriers (barrier.cluster) in place of the
//   mbarriers cost ~0.6-0.9 us each and hold every thread (0.468 ms).
// - Per block and round: (1) thread 0 loads the chunk's C, B and x tiles
//   (64 rows x 64 columns of 128-byte swizzled boxes) by TMA through 4-d
//   tensor maps over (B, S, G|H, N|P); rows past S and columns past N or
//   P read as TMA's zero fill.  dt is a 4-byte column per head, less than
//   a box's 16-byte inner extent, so the 256 threads read it themselves;
//   steps past S carry dt = 0, as in ssd_pallas's padding.  (2) cum =
//   cumsum(dt A) by a block scan, and the update's weights dt exp(cum_L -
//   cum).  (3) Warpgroup 0 forms the chunk's update with wgmma, 64
//   columns of N at a time, and sends it on (4a); (4) it scans.  (5) y in
//   64-row tiles taken from the last down, warpgroups 1, 1, 0, 0: N <= 64,
//   warpgroup 1 forms the heaviest tile's y_diag (4 of the 10 tile pairs
//   at L = 256) while warpgroup 0 does (3) and (4), and both form y_off
//   and then y_diag of their other tiles once the entering state is in
//   (y_diag before the wait is a second accumulator across the wait: two
//   early tiles spilled, one fits).  N = 128: both warpgroups scan, then
//   tiles 0, 1, 1, 0.  (6) Each tile of y is staged in its C tile's first
//   box and stored by TMA, which clips the rows past S and the columns
//   past P.
// - Products, all wgmma with f32 accumulators, a compile-time count of
//   k steps each (ptxas serialises wgmma in loops of run-time length):
//   * S = C_i B_j^T: m64n64k16, both operands K-major in shared memory,
//     4 or 8 k16 steps; exact products of bf16 inputs.  Scaled by
//     exp(cum_i - cum_j) dt_j, the difference of the log2(e)-scaled cums
//     in one ex2 (the factored exp(cum_i) exp(-cum_j) overflows on long
//     chunks), masked on the diagonal tile only, packed to bf16 into the
//     A registers of
//   * y += M x_j: m64n64k16, x through its MN-major ("transposed")
//     descriptor, as V in flash_fwd_wgmma.cu.
//   * update = (w .* x)^T B: m64n64/128k16, A = bf16(w_j x_jp) in
//     registers (x^T by ldmatrix.trans, scaled by w in f32, rounded once),
//     B through its MN-major descriptor.  wgmma's tf32 takes K-major
//     operands only, and B lands MN-major, so this product is bf16.
//   * y_off = C state_in^T: tf32 m64n64k8, A = C in registers (bf16 is
//     exact in tf32), B = the entering state in tf32, K-major, 8 or 16 k8
//     steps.
//   Tried and dropped (zamba2's prefill, tools/ssd_turns.py): issuing
//   S_{j+1} under the scaling of S_j (two S buffers: 0.58 against 0.47
//   ms); S of two source tiles in one m64n128 product (0.462 against
//   0.468); warpgroup 1 in the scan (0.430 against 0.427).
// - Rounding points (the plain version is f32 throughout): M and w .* x
//   rounded to bf16; the entering state, as y_off's operand, to tf32; the
//   state itself is carried in f32 by the scan; y rounded to bf16.
//   tests/test_torch_ssd_wgmma.py emulates these points on the CPU and
//   holds them within 1e-2 of max|y| and of max|state| of the f32
//   quadratic form.
// - Shared memory, P = N = 64, L = 256: C, B and x 32 KB each, the state
//   16 KB (the update slices of step (a), then the entering state of step
//   (c)), cum, dt and weights 4 KB: ~118 KB, one block an SM (two would
//   need 114 KB each); N = 128: ~197 KB.  Registers (ptxas -v): 242 and
//   239 (N = 64, 128), no spills, no serialised wgmma.

#include <cstdint>
#include <initializer_list>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;
using T16 = __nv_bfloat16;

constexpr int kTile = 64;                  // chunk rows a tile, a wgmma M
constexpr int kMaxTiles = 4;               // chunk <= 256
constexpr int kThreads = 256;              // two warpgroups
constexpr int kBoxBytes = kTile * 128;     // 64 rows of 64 bf16 columns
constexpr int kCluster = 8;                // blocks a cluster (n_chunks > 1)
constexpr int kSmemLimit = 232448;         // a block's shared memory
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU alone (no denormal results)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Small {
  float cum[kMaxTiles * kTile];   // inclusive cumsum of dt*A
  float cum2[kMaxTiles * kTile];  // cum log2(e)
  float dtv[kMaxTiles * kTile];   // dt (0 past the chunk)
  float wv[kMaxTiles * kTile];    // dt exp(cum_L - cum): the update's weights
  float warp_sum[kThreads / 32];
  float decay[kCluster];          // exp(cum_L) of the round's chunks
  uint64_t load_full;             // the round's TMA loads landed
  uint64_t uin_full;              // the round's update slices landed
  uint64_t st_free;               // every block has read its slices
  uint64_t st_full;               // this chunk's entering state landed
};

// shared memory of a block: C, B and x tiles, the (64 x NP) f32 state,
// Small; 1024 for the alignment
template <int NB>
constexpr size_t smem_bytes(int tiles) {
  return 1024 + (size_t)tiles * (2 * NB + 1) * kBoxBytes
         + (size_t)64 * 64 * NB * 4 + sizeof(Small);
}

// byte offset of state element (p, n) in its K-major tf32 layout: boxes
// of 32 n (128 bytes a row), 64 rows of p, 16-byte chunks swizzled by p % 8
__device__ __forceinline__ uint32_t st_off(int p, int n) {
  return (n >> 5) * (64 * 128) + p * 128 + ((((n & 31) >> 2) ^ (p & 7)) << 4)
         + (n & 3) * 4;
}

// byte offset, in the scanning block's buffer, of element (row, n) of the
// update slice that the block in slot s sent: [s][RS rows][NP], 8-column
// groups swizzled by row % 8 (the eight rows a warp writes at once fall
// on different banks)
template <int RS, int NP>
__device__ __forceinline__ uint32_t slice_off(int s, int row, int n) {
  return ((s * RS + row) * NP + ((((n >> 3) ^ row) & (NP / 8 - 1)) << 3)
          + (n & 7)) * 4;
}

// two bf16 (lo, hi) scaled by (w0, w1) in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t v, float w0, float w1) {
  return mma_sm90::Mma<T16>::pack(__uint_as_float(v << 16) * w0,
                                  __uint_as_float(v & 0xffff0000u) * w1);
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc,
                      const __grid_constant__ CUtensorMap ty,
                      const float* __restrict__ dt,
                      const float* __restrict__ A, float* __restrict__ fin,
                      int S, int H, int P, int G, int N, int L) {
  constexpr int NP = 64 * NB;  // the padded N
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int T = L / kTile;
  // boxes: C [T][NB] (y is staged in a tile's first); B [NB][T], so the
  // rows of neighbouring tiles are contiguous; x [T]
  uint8_t* Cs = base;
  uint8_t* Bs = Cs + T * NB * kBoxBytes;
  uint8_t* Xs = Bs + T * NB * kBoxBytes;
  uint8_t* St = Xs + T * kBoxBytes;         // 64 x NP f32, st_off layout
  Small& sm = *reinterpret_cast<Small*>(St + 64 * NP * 4);

  const int CL = gridDim.x, r = blockIdx.x;  // cluster rank: the chunk slot
  const int nps = (P + 63) / 64;             // 64-column slices of P
  const int h = blockIdx.y / nps, p0 = 64 * (blockIdx.y % nps);
  const int b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_chunks = (S + L - 1) / L;
  const int n_rounds = (n_chunks + CL - 1) / CL;
  // the final state's rows of this slice (computed where it is written)
  auto final_row = [&](int p) {
    return fin + (((long long)b * H + h) * P + p0 + p) * N;
  };

  // N <= 64: warpgroup 1 forms its heaviest tile's y_diag while warpgroup
  // 0 forms the update and scans the states (kEarly); N = 128: both scan
  // and then form y, as the early accumulators would not fit beside the
  // rest
  constexpr bool kEarly = NB == 1;
  constexpr int kScan = kEarly ? 128 : kThreads;  // the scanning threads
  // the scan of this block's slice: rows [r RS, (r + 1) RS) of the state,
  // SJ column pairs a scanning thread, their carry from round to round
  constexpr int RS = 64 / kCluster;
  constexpr int SJ = RS * NP / 2 / kScan;
  float carry[SJ][2];
#pragma unroll
  for (int j = 0; j < SJ; ++j) carry[j][0] = carry[j][1] = 0.f;

  if (tid == 0) {
    mbar_init(&sm.load_full, 1);
    mbar_init(&sm.uin_full, kCluster * 32);
    mbar_init(&sm.st_free, kCluster);
    mbar_init(&sm.st_full, kCluster);
    mbar_fence_init();
  }
  __syncthreads();
  if (CL > 1) cluster_sync_all();  // every block's barriers exist

  for (int round = 0; round < n_rounds; ++round) {
    const int c = round * CL + r;  // this block's chunk
    const bool live = c < n_chunks;
    const int n_live = min(CL, n_chunks - round * CL);  // the round's chunks
    const bool has_state = c > 0;
    const int t0 = c * L;
    const int Lc = live ? min(L, S - t0) : 0;
    const int Tl = (Lc + kTile - 1) / kTile;  // tiles holding a step
    const uint32_t par = round & 1;
    // the slices that no chunk sends this round count as arrived
    if (CL > 1 && tid < (kCluster - n_live) * 32) mbar_arrive(&sm.uin_full);

    // ---- (1) the chunk's tiles by TMA ---------------------------------- //
    if (tid == 0 && live) {
      mbar_expect_tx(&sm.load_full, Tl * (2 * NB + 1) * kBoxBytes);
      for (int i = 0; i < Tl; ++i) {
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(Cs + (i * NB + nb) * kBoxBytes, &tc, &sm.load_full,
                      64 * nb, grp, t0 + i * kTile, b);
          tma_load_4d(Bs + (nb * T + i) * kBoxBytes, &tb, &sm.load_full,
                      64 * nb, grp, t0 + i * kTile, b);
        }
        tma_load_4d(Xs + i * kBoxBytes, &tx, &sm.load_full, p0, h,
                    t0 + i * kTile, b);
      }
    }

    // ---- (2) cum, dt and the update's weights, one step a thread -------- //
    if (live) {
      const float d = tid < Lc ? dt[((long long)b * S + t0 + tid) * H + h]
                               : 0.f;
      float v = d * A[h];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) sm.warp_sum[tid >> 5] = v;
      __syncthreads();
      for (int k = 0; k < (tid >> 5); ++k) v += sm.warp_sum[k];
      sm.cum[tid] = v;
      sm.cum2[tid] = v * kLog2e;
      sm.dtv[tid] = d;
      __syncthreads();
      sm.wv[tid] = d * expf(sm.cum[L - 1] - v);  // cum[L-1] = cum_L
      __syncthreads();
      mbar_wait(&sm.load_full, par);
    }

    // ---- the y work on one 64-row tile i ------------------------------- //
    // y_diag: acc += M x_j over the source tiles j <= i, M = (C_i B_j^T)
    // exp(cum_i - cum_j) dt_j (the difference of the log2(e)-scaled cums in
    // one ex2), masked on the diagonal tile, packed to bf16 into the A
    // registers of M x_j
    auto y_diag = [&](int i, float (&acc)[32]) {
      const uint32_t cts = smem_u32(Cs + i * NB * kBoxBytes);
      const int il = 16 * warp + g;  // and il + 8
      const float ci[2] = {sm.cum2[i * kTile + il],
                           sm.cum2[i * kTile + il + 8]};
      for (int jt = 0; jt <= i; ++jt) {
        float sv[32];
        const uint32_t bts = smem_u32(Bs + jt * kBoxBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          const uint64_t da =
              desc_sw128(cts + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16,
                         1024);
          const uint64_t db = desc_sw128(
              bts + (kk >> 2) * T * kBoxBytes + (kk & 3) * 32, 16, 1024);
          Wgmma<T16>::ss_n64(sv, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sv);
        const bool diag = jt == i;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int jl = 8 * q + 2 * t;  // and jl + 1
          const float2 cj = *reinterpret_cast<const float2*>(
              sm.cum2 + jt * kTile + jl);
          const float2 dj = *reinterpret_cast<const float2*>(
              sm.dtv + jt * kTile + jl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m = sv[4 * q + e]
                * ex2(ci[e >> 1] - (e & 1 ? cj.y : cj.x))
                * (e & 1 ? dj.y : dj.x);
            const bool keep = !diag || jl + (e & 1) <= il + 8 * (e >> 1);
            sv[4 * q + e] = keep ? m : 0.f;
          }
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          pa[kc][0] = mma_sm90::Mma<T16>::pack(sv[8 * kc], sv[8 * kc + 1]);
          pa[kc][1] =
              mma_sm90::Mma<T16>::pack(sv[8 * kc + 2], sv[8 * kc + 3]);
          pa[kc][2] =
              mma_sm90::Mma<T16>::pack(sv[8 * kc + 4], sv[8 * kc + 5]);
          pa[kc][3] =
              mma_sm90::Mma<T16>::pack(sv[8 * kc + 6], sv[8 * kc + 7]);
        }
        const uint32_t xts = smem_u32(Xs + jt * kBoxBytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          Wgmma<T16>::rs_n64(acc, pa[kc],
                             desc_sw128(xts + kc * 2048, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
    };
    // y_off: tmp = (C_i state^T) exp(cum_i) with the entering state, tf32:
    // A = C from shared memory (rows 16 warp + g (+8), columns 8 ks + t
    // (+4)), 8 k8 steps (a 64-column box of C) a group
    auto y_off = [&](int i, float (&tmp)[32]) {
      const uint8_t* ct = Cs + i * NB * kBoxBytes;
      const uint32_t sts = smem_u32(St);
#pragma unroll
      for (int e = 0; e < 32; ++e) tmp[e] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t ca[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint16_t* cp = reinterpret_cast<const uint16_t*>(
              ct + nb * kBoxBytes + (16 * warp + g) * 128 + ((ks ^ g) << 4));
          ca[ks][0] = (uint32_t)cp[t] << 16;
          ca[ks][1] = (uint32_t)cp[512 + t] << 16;
          ca[ks][2] = (uint32_t)cp[t + 4] << 16;
          ca[ks][3] = (uint32_t)cp[512 + t + 4] << 16;
        }
        fence_regs(tmp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int kk = 8 * nb + ks;
          WgmmaTf32::rs_n64(
              tmp, ca[ks],
              desc_sw128(sts + (kk >> 2) * (64 * 128) + (kk & 3) * 32, 16,
                         1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tmp);
      }
      const int row = i * kTile + 16 * warp + g;
      const float e0 = expf(sm.cum[row]), e1 = expf(sm.cum[row + 8]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        tmp[4 * q] *= e0;
        tmp[4 * q + 1] *= e0;
        tmp[4 * q + 2] *= e1;
        tmp[4 * q + 3] *= e1;
      }
    };
    // stage y in the tile's first C box, swizzled as the y map's box, and
    // store it by TMA (every wgmma that read C_i has completed)
    auto store = [&](int i, const float (&acc)[32]) {
      const int rr = 16 * warp + g;
      uint8_t* ct = Cs + i * NB * kBoxBytes;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint8_t* p = ct + ((q ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(p + rr * 128) =
            mma_sm90::Mma<T16>::pack(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<uint32_t*>(p + (rr + 8) * 128) =
            mma_sm90::Mma<T16>::pack(acc[4 * q + 2], acc[4 * q + 3]);
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (wt == 0) {
        tma_store_4d(&ty, ct, p0, h, t0 + i * kTile, b);
        tma_store_commit();
      }
    };
    // the entering state is in St (a single chunk has none)
    auto wait_state = [&] {
      if (CL > 1) {
        mbar_wait_cluster(&sm.st_full, par);
        fence_proxy_async();  // written by peers, read by wgmma
      }
    };

    // the tile this warpgroup takes k-th (below)
    auto tile = [&](int k) {
      const int pos = kEarly ? (wg == 1 ? k : 2 + k)
                             : (wg == 0 ? 3 * k : 1 + k);
      return Tl - 1 - pos;
    };
    // ---- (3), (4a) the chunk's state update, warpgroup 0, 64 columns of N
    // at a time, each sent on as it is formed: rows [k RS, (k + 1) RS) to
    // block k, into slot r (one chunk: written as the final state) ------ //
    auto update = [&](int nh) {
      const float decay = expf(sm.cum[L - 1]);
      float upd[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) upd[e] = 0.f;
      for (int jt = 0; jt < Tl; ++jt) {
        // A = bf16(w_j x_jp)^T: ldmatrix.trans of x rows j (matrix q of
        // lane l: rows j0 + 8 (q >> 1) + l % 8, p chunk 2 warp + (q & 1))
        uint32_t af[4][4];
        const uint8_t* xt = Xs + jt * kBoxBytes;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int j = 16 * kc + (lane & 7) + 8 * (lane >> 4);
          const int pc = 2 * warp + ((lane >> 3) & 1);
          const float* w = sm.wv + jt * kTile + 16 * kc + 2 * t;
          const float w0 = w[0], w1 = w[1], w2 = w[8], w3 = w[9];
          uint32_t ra[4];
          mma_sm90::ldmatrix_x4_trans(
              ra, xt + j * 128 + ((pc ^ (j & 7)) << 4));
          af[kc][0] = scale2(ra[0], w0, w1);
          af[kc][1] = scale2(ra[1], w0, w1);
          af[kc][2] = scale2(ra[2], w2, w3);
          af[kc][3] = scale2(ra[3], w2, w3);
        }
        const uint32_t bt = smem_u32(Bs + (nh * T + jt) * kBoxBytes);
        fence_regs(upd);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          Wgmma<T16>::rs_n64(upd, af[kc],
                             desc_sw128(bt + kc * 2048, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(upd);
      }
      if (CL == 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int p = 16 * warp + g + 8 * hr;
            const int n = 64 * nh + 8 * q + 2 * t;
            if (p0 + p < P && n < N)
              *reinterpret_cast<float2*>(final_row(p) + n) =
                  make_float2(upd[4 * q + 2 * hr], upd[4 * q + 2 * hr + 1]);
          }
        return;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = 16 * warp + g + 8 * hr;  // slice p / RS, row p % RS
        const uint32_t peer = peer_addr(St, p / RS);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          st_peer_v2(
              peer + slice_off<RS, NP>(r, p % RS, 64 * nh + 8 * q + 2 * t),
              upd[4 * q + 2 * hr], upd[4 * q + 2 * hr + 1]);
        // the 32 threads that hold slice p / RS arrive on its uin_full
        // once they wrote it
        if (nh == NB - 1) {
          st_peer_f32(peer_addr(&sm.decay[r], p / RS), decay);
          mbar_arrive_peer(peer_addr(&sm.uin_full, p / RS));
        }
      }
    };
    if (live && wg == 0) {
      if constexpr (NB == 1) {
        update(0);
      } else {
#pragma unroll 1
        for (int nh = 0; nh < NB; ++nh) update(nh);
      }
    }

    if (CL > 1 && (!kEarly || wg == 0)) {
      // ---- (4) the states across the cluster ------------------------- //
      // b: this block scans its rows over the round's chunks in order:
      // the state entering chunk s of the round is the carry before it
      mbar_wait_cluster(&sm.uin_full, par);
      float entering[SJ][kCluster][2];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int e = 2 * (tid + kScan * j);
        const int row = e / NP, n = e % NP;
#pragma unroll
        for (int sl = 0; sl < kCluster; ++sl) {
          if (sl >= n_live) break;
          const float2 u = *reinterpret_cast<const float2*>(
              St + slice_off<RS, NP>(sl, row, n));
          const float dk = sm.decay[sl];
          entering[j][sl][0] = carry[j][0];
          entering[j][sl][1] = carry[j][1];
          carry[j][0] = carry[j][0] * dk + u.x;
          carry[j][1] = carry[j][1] * dk + u.y;
        }
        const int p = r * RS + row;
        if (round == n_rounds - 1 && p0 + p < P && n < N)
          *reinterpret_cast<float2*>(final_row(p) + n) =
              make_float2(carry[j][0], carry[j][1]);
      }
      // every block tells every block that its slices are read; c waits
      // for that before it overwrites them with the entering states
      named_sync(3, kScan);
      if (tid < kCluster) mbar_arrive_peer(peer_addr(&sm.st_free, tid));
      mbar_wait_cluster(&sm.st_free, par);
      // c: the entering states back to their chunks' blocks, rounded to
      // tf32 as y_off's operand, in its K-major layout
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int e = 2 * (tid + kScan * j);
        const int p = r * RS + e / NP, n = e % NP;
#pragma unroll
        for (int sl = 0; sl < kCluster; ++sl) {
          if (sl >= n_live) break;
          st_peer_v2(peer_addr(St, sl) + st_off(p, n),
                     __uint_as_float(mma_sm90::tf32(entering[j][sl][0])),
                     __uint_as_float(mma_sm90::tf32(entering[j][sl][1])));
        }
      }
      fence_cluster();
      named_sync(3, kScan);
      if (tid < n_live) mbar_arrive_peer(peer_addr(&sm.st_full, tid));
    }

    // ---- (5, 6) y -------------------------------------------------------- //
    // the live tiles from the last down: warpgroups 1, 1, 0, 0 (kEarly:
    // warpgroup 1 skipped (3) and (4) and forms the heaviest tile's y_diag
    // before the state arrives), else 0, 1, 1, 0; y_off into the
    // accumulators, then y_diag added on
    if (live) {
      float acc[32];
      int k0 = 0;
      if (kEarly && wg == 1) {
        float early[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) early[e] = 0.f;
        y_diag(tile(0), early);
        if (has_state) {
          wait_state();
          y_off(tile(0), acc);
#pragma unroll
          for (int e = 0; e < 32; ++e) early[e] += acc[e];
        }
        store(tile(0), early);
        k0 = 1;
      } else if (has_state) {
        wait_state();
      }
      for (int k = k0; k < 2; ++k) {
        const int i = tile(k);
        if (i < 0) break;
        if (has_state) {
          y_off(i, acc);
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        }
        y_diag(i, acc);
        store(i, acc);
      }
    }

    // ---- end of round: shared memory is free for the next one ---------- //
    if (wt == 0) tma_store_wait_read();
    fence_proxy_async();  // generic reads before the next round's TMA writes
    __syncthreads();
    if (n_rounds > 1) cluster_sync_all();  // St and the barriers' phases
  }
  if (CL > 1) cluster_sync_all();  // no block exits while a peer writes
}

// ---- tensor maps (host), as flash_fwd_wgmma.cu's ------------------------- //
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found once at run time: the
// library links against the runtime alone
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over a (B, S, H, D) tensor of 16-bit elements, boxes of 64
// columns x 1 head x `rows` positions x 1 batch, 128-byte swizzled, zeros
// out of bounds
bool tensor_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType ty,
                const void* base, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, ty, 4, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* fin, int B, int S, int H, int P,
           int G, int N, int L, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tb, tc, ty;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map(&tx, encode, bf, x, B, S, H, P, kTile) ||
      !tensor_map(&tb, encode, bf, Bm, B, S, G, N, kTile) ||
      !tensor_map(&tc, encode, bf, Cm, B, S, G, N, kTile) ||
      !tensor_map(&ty, encode, bf, y, B, S, H, P, kTile))
    return (int)cudaErrorInvalidValue;
  // raise the block's shared-memory ceiling once per instantiation, to
  // the most any chunk it takes needs (and never inside a CUDA graph
  // capture, which replays launches only)
  static bool configured = false;
  if (!configured) {
    int most = kMaxTiles;
    while (smem_bytes<NB>(most) > kSmemLimit) --most;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_wgmma_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<NB>(most));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int CL = (S + L - 1) / L > 1 ? kCluster : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)CL, (unsigned)(H * ((P + 63) / 64)),
                     (unsigned)B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<NB>(L / kTile);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ssd_scan_wgmma_kernel<NB>, tx, tb, tc, ty,
      (const float*)dt, (const float*)A, (float*)fin, S, H, P, G, N, L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The chunk the wgmma kernel walks for these shapes (L = min(chunk, S)):
// L where S spans several chunks, S rounded up to 64 where one chunk holds
// it (the same scan: a lone chunk's length past S changes nothing); 0 where
// it takes no such shape.  kernel.py's ssd_route keeps the same rule.
int ssd_scan_wgmma_chunk(int P, int N, int S, int L) {
  const int Lk = L >= S ? (S + kTile - 1) / kTile * kTile : L;
  if (P % 8 != 0 || N % 8 != 0 || P < 8 || N < 8 || P > 128 || N > 128)
    return 0;
  if (Lk < kTile || Lk % kTile != 0 || Lk > kMaxTiles * kTile) return 0;
  return Lk;
}

// The wgmma route of ssd_scan_launch (ssd_scan.cu), bf16 only: shapes that
// ssd_scan_wgmma_chunk takes, x, Bm, Cm and y 16-byte aligned (what a
// tensor map takes); anything else is refused.
int ssd_scan_wgmma(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* fin, int B,
                   int S, int H, int P, int G, int N, int L,
                   cudaStream_t st) {
  const int Lk = ssd_scan_wgmma_chunk(P, N, S, L);
  if (Lk == 0 || G < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, Bm, Cm, (const void*)y})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  if (N <= 64)
    return launch<1>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, Lk, st);
  return launch<2>(x, dt, A, Bm, Cm, y, fin, B, S, H, P, G, N, Lk, st);
}
