// Hopper (sm_90a) kernel for the FlashAttention-2 forward on bf16 and f16
// inputs whose head dim is a multiple of 8 up to 128 and whose q, k, v and
// out start 16-byte aligned (repro_torch/kernels/flash_attention/kernel.py,
// route `flash_fwd.wgmma`): wgmma on the tensor cores, TMA loads into a
// shared-memory ring, one producer warpgroup and two consumer warpgroups.
// `flash_fwd_launch` (flash_fwd.cu) sends those inputs here, any other
// 16-bit shape to the mma.sync kernel (flash_fwd_mma.cu) and f32 to the
// CUDA-core kernel (flash_fwd.cu); this file has no C entry point of its
// own.
//
// flash_fwd replaces src/repro/kernels/flash_attention/kernel.py
// flash_fwd_pallas / _fwd_kernel: out = softmax(q k^T * scale + mask) v
// and lse = m + log(l) per query row, GQA (kv head = q head // G), causal
// and sliding-window masks from positions (query i and key j both counted
// from 0), Sq != Skv, ragged lengths.
//
// Bound: operations.  At zamba2's prefill (B=4, S=2048, Hq=Hkv=32, D=112,
// causal) the live (query, key) pairs need ~1.2e11 FLOP, 0.12 ms on the
// bf16 tensor cores, against ~0.07 ms to move q, k, v and out once.  Only
// wgmma reaches the tensor cores' full rate on this card; the mma.sync
// kernel (flash_fwd_mma.cu) stays near a fifth of the bound, this one
// reaches 0.44 of it (0.274 ms at that shape, on an H100 at 700 W).
//
// Design:
// - One block of three warpgroups per (128-row q tile, q head, batch):
//   warpgroup 0 is the producer, 1 and 2 the consumers, 64 q rows each.
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232).  Blocks start in groups of (batch, head) pairs whose K and V
//   fit in 32 MB of L2, each group's by q tile from the last down: under
//   the causal mask the heaviest blocks start first and the lightest
//   fill the tail, and the blocks that read one head's K and V run
//   together and find them in L2 (with one group of every head,
//   zamba2's 117 MB of K and V came from HBM once a q tile).
// - Loads: one producer thread issues TMA loads of 4-d tensor maps over
//   (D, H, S, B) with boxes of 64 head-dim columns x 1 head x rows x 1,
//   128-byte swizzled as wgmma's descriptors read them.  Out-of-bounds
//   elements read as zero: the ragged Sq / Skv tail, and a head dim
//   padded to 64 or 128 (D = 112 is two boxes whose last 16 columns are
//   zero and add nothing to Q K^T).  Q comes once per block; K and V
//   tiles of 128 rows go through 2-stage rings of their own, each stage
//   with a full mbarrier (the TMA bytes) and an empty one (all 256
//   consumer threads), in the order the consumers take them: K_i, then
//   V_{i-1}.  kv tiles wholly outside the mask are never loaded.
// - The consumers take turns to issue (two named barriers): each issues
//   S_i = Q K_i^T and O += P_{i-1} V_{i-1} together, then runs the
//   softmax of S_i while its P V and the other warpgroup's products run.
// - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory,
//   f32 accumulators, 4, 7 or 8 k16 steps (ceil(D / 16) at D = 64, 112,
//   128), a compile-time count: ptxas serialises wgmma in a loop of
//   run-time length.  Products of 16-bit inputs are exact in f32: the
//   scores are the plain version's f32 scores up to
//   summation order.  The scale (folded with log2 e, for exp2), the mask
//   (only on tiles that cross a mask edge; masked scores -1e30 in the
//   log2 domain) and the online softmax stay in registers; a row's max
//   and sum reduce over the four lanes that hold it.
// - O += P V: p rounded to the input dtype into the A registers of wgmma
//   m64nNk16 (N = 64 or 128, the padded head dim), V read through its
//   MN-major ("transposed") descriptor: the plain version's rounding.
// - Epilogue: l clamped at 1e-37 (a row with no live key gets finite
//   numbers, as the plain version's does); out = o / l written into the
//   warpgroup's own q tile in the swizzled layout and stored by TMA,
//   which clips the rows past Sq and the columns past D; lse = m + log l
//   from registers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

constexpr int kBQ = 128;        // q rows per block
constexpr int kRows = 64;       // q rows per consumer warpgroup
constexpr int kBK = 128;        // kv rows per tile
constexpr int kStages = 2;      // the K / V rings
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kBox = 64;        // head-dim columns a box (128 bytes)
constexpr int kRowBytes = 128;  // one row of a box
// the K and V bytes that one group of heads may read (of L2's 50 MB)
constexpr long long kL2Budget = 32ll << 20;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg2 = -1e30f * kLog2e;  // masked score, log2 domain

// NB boxes of 64 head-dim columns (NB = 1 for D <= 64, 2 for D <= 128);
// every tile 1024-byte aligned, as the 128-byte swizzle needs
template <int NB>
struct Smem {
  alignas(1024) uint8_t q[2][NB][kRows * kRowBytes];   // per consumer
  alignas(1024) uint8_t k[kStages][NB][kBK * kRowBytes];
  alignas(1024) uint8_t v[kStages][NB][kBK * kRowBytes];
  uint64_t q_full, k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

// the ring slot and the phase parity of the i-th tile of a ring
__device__ __forceinline__ int slot(int i) { return i % kStages; }
__device__ __forceinline__ uint32_t parity(int i) {
  return (i / kStages) & 1;
}

// S = Q K^T over KS k16 steps: the consumer's 64 q rows (shared address
// `qs`) against the 128 kv rows of a K tile (`ks`).  KS is a constant:
// a loop of run-time length makes ptxas wait on every wgmma.
template <typename T, int KS>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t qs,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // the k16 step in the row
    Wgmma<T>::ss_n128(
        s, desc_sw128(qs + (kk >> 2) * kRows * kRowBytes + off, 16, 1024),
        desc_sw128(ks + (kk >> 2) * kBK * kRowBytes + off, 16, 1024),
        kk > 0);
  }
}

// O += P V: P in the A registers (k16 step kc: keys 16 kc..16 kc + 15),
// V through its MN-major descriptor (`vs`)
template <typename T, int NB>
__device__ __forceinline__ void issue_pv(float (&o)[NB * 32],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    const uint64_t dv =
        desc_sw128(vs + kc * 16 * kRowBytes, kBK * kRowBytes, 1024);
    if constexpr (NB == 1)
      Wgmma<T>::rs_n64(o, pa[kc], dv);
    else
      Wgmma<T>::rs_n128(o, pa[kc], dv);
  }
}

// 2^x on the SFU alone: no denormal results (exp2f's range fix-up costs
// four more instructions an element, and p below 2^-126 is 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile (keys k0..k0 + 127) for this lane's
// rows row0 and row0 + 8: masks (`edge`: the tile crosses a mask edge for
// some row of the warpgroup), updates m and l, leaves p = exp2(s * scale
// - m) in s and the factor that rescales the rows' earlier sums in corr.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool edge, int row0, int k0, int t, int Skv, int causal, int window,
    float scale_log2) {
  float mx[2];
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + (e >> 1) * 8;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        bool live = kpos < Skv;
        if (causal) live = live && kpos <= qpos;
        if (window) live = live && kpos > qpos - window;
        s[4 * j + e] = live ? s[4 * j + e] * scale_log2 : kNeg2;
      }
    }
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  } else {
    // no mask: the max of the raw scores, scaled once (the scale is
    // positive, so the max and the rounding of the product commute)
    mx[0] = s[0];
    mx[1] = s[2];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx[0] = fmaxf(m[0], mx[0] * scale_log2);
    mx[1] = fmaxf(m[1], mx[1] * scale_log2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
  const float a = edge ? 1.f : scale_log2;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], a, -m[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
  }
}

// p rounded to T, packed as the A operand of the P V product: the
// accumulator of two neighbouring 8-key blocks is one k16 step
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4],
                                       const float (&s)[kBK / 2]) {
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    pa[kc][0] = mma_sm90::Mma<T>::pack(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = mma_sm90::Mma<T>::pack(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = mma_sm90::Mma<T>::pack(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = mma_sm90::Mma<T>::pack(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// KS k16 steps cover the head dim in Q K^T: ceil(D / 16) for the main
// paths' D (64, 112, 128), 4 NB for any other (the zero columns add 0)
template <typename T, int NB, int KS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int Sq, int Skv, int Hq,
                       int Hkv, int D, int causal, int window,
                       float scale_log2, int group) {
  constexpr int DN = kBox * NB;  // the P V product's width
  extern __shared__ uint8_t smem_raw[];
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // the block's (q tile, head, batch), kernel.py's block_order: the
  // (batch, head) pairs in groups of `group`, each group's blocks by q
  // tile from the last (the heaviest under a causal mask) down
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int pairs = gridDim.x / n_qt;
  const int g0 = blockIdx.x / (group * n_qt) * group;
  const int gs = min(group, pairs - g0);
  const int within = blockIdx.x - g0 * n_qt;
  const int pair = g0 + within % gs;
  const int q0 = (n_qt - 1 - within / gs) * kBQ;
  const int h = pair % Hq;
  const int b = pair / Hq;
  const int kvh = h / (Hq / Hkv);
  const int wg = threadIdx.x / 128;

  // kv tiles alive under the mask for some row of this q tile
  // (kernel.py's tile_walk)
  int k_begin = 0, k_end = Skv;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  if (window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int kt_lo = k_begin / kBK;
  const int n = k_begin < k_end ? (k_end + kBK - 1) / kBK - kt_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 2 * 128);
      mbar_init(&sm.v_empty[i], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps both rings full ------------------- //
    // in the order the consumers take the tiles: K 0, then K i with V i-1
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      constexpr uint32_t kTile = NB * kBK * kRowBytes;
      mbar_expect_tx(&sm.q_full, 2 * NB * kRows * kRowBytes);
      for (int c = 0; c < 2; ++c)
        for (int x = 0; x < NB; ++x)
          tma_load_4d(sm.q[c][x], &tq, &sm.q_full, x * kBox, h,
                      q0 + c * kRows, b);
      for (int i = 0; i <= n; ++i) {
        if (i < n) {
          const int st = slot(i);
          mbar_wait(&sm.k_empty[st], parity(i) ^ 1);
          mbar_expect_tx(&sm.k_full[st], kTile);
          for (int x = 0; x < NB; ++x)
            tma_load_4d(sm.k[st][x], &tk, &sm.k_full[st], x * kBox, kvh,
                        (kt_lo + i) * kBK, b);
        }
        if (i > 0) {
          const int st = slot(i - 1);
          mbar_wait(&sm.v_empty[st], parity(i - 1) ^ 1);
          mbar_expect_tx(&sm.v_full[st], kTile);
          for (int x = 0; x < NB; ++x)
            tma_load_4d(sm.v[st][x], &tv, &sm.v_full[st], x * kBox, kvh,
                        (kt_lo + i - 1) * kBK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ------------------------------------ //
    // Each step issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} together,
    // then runs the softmax of S_i while P_{i-1} V_{i-1} is in flight.
    // The two warpgroups take turns to issue (named barriers 1 and 2,
    // warpgroup 0 first): one's softmax runs under the other's products.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + c * kRows;         // this warpgroup's first row
    const int row0 = r0 + 16 * warp + g;   // this lane's rows: row0, +8
    const uint32_t qs = smem_u32(sm.q[c][0]);
    // my turn to issue; then the other warpgroup's (whose last turn
    // passes none on: the barrier would be left with an arrival)
    auto turn_begin = [&] { named_sync(1 + c, 256); };
    auto turn_end = [&](bool last) {
      if (!(last && c == 1)) named_arrive(2 - c, 256);
    };
    auto edge = [&](int i) {
      const int k0 = (kt_lo + i) * kBK;
      return k0 + kBK > Skv || (causal && k0 + kBK - 1 > r0) ||
             (window && k0 <= r0 + kRows - 1 - window);
    };

    float o[DN / 2], s[kBK / 2], m[2] = {kNeg2, kNeg2}, l[2] = {0.f, 0.f};
    float corr[2];
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;

    if (n > 0) {
      if (c == 1) named_arrive(1, 256);  // warpgroup 0 issues first
      mbar_wait(&sm.q_full, 0);
      mbar_wait(&sm.k_full[0], 0);
      turn_begin();
      wgmma_fence();
      issue_qk<T, KS>(s, qs, smem_u32(sm.k[0][0]));
      wgmma_commit();
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&sm.k_empty[0]);
      softmax_tile(s, m, l, corr, edge(0), row0, kt_lo * kBK, t, Skv,
                   causal, window, scale_log2);
      pack_p<T>(pa, s);
      for (int i = 1; i < n; ++i) {
        const int st = slot(i), pst = slot(i - 1);
        mbar_wait(&sm.k_full[st], parity(i));
        mbar_wait(&sm.v_full[pst], parity(i - 1));
        turn_begin();
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();  // one fence a product: the softmax below
        issue_qk<T, KS>(s, qs, smem_u32(sm.k[st][0]));
        wgmma_commit();  // rewrites S while P V is still in flight
        wgmma_fence();
        issue_pv<T, NB>(o, pa, smem_u32(sm.v[pst][0]));
        wgmma_commit();
        turn_end(false);
        wgmma_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
        fence_regs(s);
        mbar_arrive(&sm.k_empty[st]);
        softmax_tile(s, m, l, corr, edge(i), row0, (kt_lo + i) * kBK, t,
                     Skv, causal, window, scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&sm.v_empty[pst]);
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        pack_p<T>(pa, s);
      }
      const int pst = slot(n - 1);
      mbar_wait(&sm.v_full[pst], parity(n - 1));
      turn_begin();
      fence_regs(o);
      wgmma_fence();
      issue_pv<T, NB>(o, pa, smem_u32(sm.v[pst][0]));
      wgmma_commit();
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&sm.v_empty[pst]);
    }

    // ---- epilogue: out = o / l through the q tile, lse = m + log l ----- //
    float inv[2], lc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lc[r] = fmaxf(l[r], 1e-37f);
      inv[r] = 1.f / lc[r];
    }
    if (n == 0) mbar_wait(&sm.q_full, 0);  // the q tile is ours to reuse
    named_sync(3 + c, 128);  // every wgmma of this warpgroup read its q
    uint8_t* ot = sm.q[c][0];
    const int rr = 16 * warp + g;  // rows rr and rr + 8 of the tile
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      // 16-byte chunk j % 8 of box j / 8, swizzled by the row (rr % 8 = g)
      uint8_t* p = ot + (j / 8) * kRows * kRowBytes + (((j & 7) ^ g) << 4)
                   + 4 * t;
      *reinterpret_cast<uint32_t*>(p + rr * kRowBytes) =
          mma_sm90::Mma<T>::pack(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(p + (rr + 8) * kRowBytes) =
          mma_sm90::Mma<T>::pack(o[4 * j + 2] * inv[1],
                                 o[4 * j + 3] * inv[1]);
    }
    fence_proxy_async();
    named_sync(3 + c, 128);
    if (tid == 0) {
      for (int x = 0; x < NB; ++x)
        tma_store_4d(&to, sm.q[c][x], x * kBox, h, r0, b);
      tma_store_commit();
      tma_store_wait_read();
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        if (qpos < Sq)
          lse[((long long)b * Sq + qpos) * Hq + h] =
              m[r] * kLn2 + logf(lc[r]);
      }
    }
  }
}

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

// a 4-d map over a (B, S, H, D) tensor, boxes of 64 columns x 1 head x
// `rows` positions x 1 batch, 128-byte swizzled, zeros out of bounds
bool tensor_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType ty,
                const void* base, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, ty, 4, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NB, int KS>
int launch_nb(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
              int causal, int window, CUtensorMapDataType ty,
              float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, encode, ty, q, B, Sq, Hq, D, kRows) ||
      !tensor_map(&tk, encode, ty, k, B, Skv, Hkv, D, kBK) ||
      !tensor_map(&tv, encode, ty, v, B, Skv, Hkv, D, kBK) ||
      !tensor_map(&to, encode, ty, out, B, Sq, Hq, D, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(Smem<NB>) + 1024;  // + the 1024-byte align
  // raise the block's shared-memory ceiling once per instantiation (and
  // never inside a CUDA graph capture, which replays launches only)
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<T, NB, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const long long n_qt = (Sq + kBQ - 1) / kBQ;
  const long long pairs = (long long)B * Hq;
  if (n_qt * pairs > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  // the fewest groups whose K and V fit the budget (a group holds at
  // least one kv head and every q head that reads it), of equal size
  const long long G = Hq / Hkv;
  const long long most =
      std::max(kL2Budget / (2ll * Skv * D * (long long)sizeof(T)), 1ll) * G;
  const long long n_groups = (pairs + most - 1) / most;
  const long long group = std::min(
      pairs, ((pairs + n_groups - 1) / n_groups + G - 1) / G * G);
  const float scale_log2 = scale * kLog2e;
  flash_fwd_wgmma_kernel<T, NB, KS>
      <<<(unsigned)(n_qt * pairs), kThreads, bytes, stream>>>(
          tq, tk, tv, to, (float*)lse, Sq, Skv, Hq, Hkv, D, causal, window,
          scale_log2, (int)group);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
           int window, CUtensorMapDataType ty, float scale,
           cudaStream_t st) {
  if (D <= kBox)
    return launch_nb<T, 1, 4>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                              causal, window, ty, scale, st);
  if (D <= 112)
    return launch_nb<T, 2, 7>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                              causal, window, ty, scale, st);
  return launch_nb<T, 2, 8>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                            causal, window, ty, scale, st);
}

}  // namespace

// The wgmma route of flash_fwd_launch (flash_fwd.cu): dtype 1 bf16, 2 f16,
// D a multiple of 8 up to 128, every base pointer 16-byte aligned (what a
// tensor map takes); anything else is refused.
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                    int D, int causal, int window, int dtype,
                    float scale, cudaStream_t st) {
  if (D % 8 != 0 || D < 8 || D > 2 * kBox) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                                   causal, window,
                                   CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale,
                                   st);
    case 2:
      return launch<__half>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                            causal, window, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
