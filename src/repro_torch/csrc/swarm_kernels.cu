// Hopper (sm_90a) kernels for the batched swarm decision engine
// (repro_torch/core/swarm_kernels.py).  Plain C entry points, loaded with
// ctypes; every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported
// at the call site.
//
// 1. rarest_keys     replaces src/repro/core/swarm_kernels.py
//                    _rarest_keys_pallas (rarest-first composite keys).
// 2. island_has      replaces _island_has_pallas (P4P island availability).
// 3. match_requests  replaces _match_requests_pallas (greedy holder walk).
//
// Each kernel's note says what bounds it on the card and what the design
// does about it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kKeyInf = 1LL << 62;   // swarm_kernels.KEY_INF

// ----------------------------------------------------------------------
// rarest_keys: key[r,p] = (counts[p]*n + (p + offsets[r]) mod n)*n + p,
// plus cost[r,p]*span when a cost plane is given, and KEY_INF where
// missing[r,p] is 0.
//
// Bound: bytes.  One int64 key written per (row, piece), the mask and the
// cost plane read once; the arithmetic is a handful of integer ops per
// byte.  Design: one thread per (r, p), consecutive threads on
// consecutive pieces so every load and the store coalesce; the mask and
// the cost term are fused here so the (R, P) keys are written once and
// never re-read before the sort.  Keys are int64 throughout, which lifts
// the Pallas kernel's counts * P^2 < 2^31 ceiling.
// ----------------------------------------------------------------------
__global__ void rarest_keys_kernel(const int64_t* __restrict__ counts,
                                   const int64_t* __restrict__ offsets,
                                   const uint8_t* __restrict__ missing,
                                   const int64_t* __restrict__ cost,
                                   long long span, int rows, int n,
                                   int64_t* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)rows * n;
  if (idx >= total) return;
  int r = (int)(idx / n);
  int p = (int)(idx - (long long)r * n);
  long long rot = ((long long)p + offsets[r]) % n;
  if (rot < 0) rot += n;
  long long key = ((long long)counts[p] * n + rot) * n + p;
  if (cost != nullptr) key += (long long)cost[idx] * span;
  if (missing != nullptr && missing[idx] == 0) key = kKeyInf;
  out[idx] = key;
}

// ----------------------------------------------------------------------
// island_has: out[k,p] = OR_n member[k,n] & have[n,p].
//
// Bound: bytes (the (N, P) plane is read once; K*N*P byte ANDs are far
// below the card's integer rate), but at the main path's sizes (N <=
// 2000, P = 64) the plane is ~100 KB and the real limit is load latency.
// Design: one block per (island, 32-piece chunk); its 32 x 32 threads
// split the N rows 32 ways, so each thread walks N/32 rows instead of N,
// and a warp reads 32 consecutive pieces of one row (one coalesced
// segment).  Rows outside the island skip the plane read.  The 32 partial
// ORs meet in shared memory.  The OR over bytes is exact by
// construction, where the Pallas kernel needed an f32 dot and a > 0 test.
// ----------------------------------------------------------------------
constexpr int kIslandLanes = 32;   // pieces per block
constexpr int kIslandRows = 32;    // row groups per block

__global__ void island_has_kernel(const uint8_t* __restrict__ have,
                                  const uint8_t* __restrict__ member,
                                  int n_rows, int k_islands, int n_pieces,
                                  uint8_t* __restrict__ out) {
  __shared__ uint8_t part[kIslandRows][kIslandLanes];
  const int k = blockIdx.y;
  const int p = blockIdx.x * kIslandLanes + threadIdx.x;
  const uint8_t* mrow = member + (size_t)k * n_rows;
  uint8_t acc = 0;
  if (p < n_pieces) {
    for (int i = threadIdx.y; i < n_rows; i += kIslandRows) {
      if (mrow[i]) acc |= have[(size_t)i * n_pieces + p];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc != 0;
  __syncthreads();
  if (threadIdx.y == 0 && p < n_pieces) {
    uint8_t any = 0;
    for (int y = 0; y < kIslandRows; ++y) any |= part[y][threadIdx.x];
    out[(size_t)k * n_pieces + p] = any;
  }
}

// ----------------------------------------------------------------------
// match_requests: per row, walk the piece order; at step k pick the
// untaken usable candidate with the lowest (cand_key, c) that holds piece
// orders[r,k] (have or full), mark it taken, spend one unit of budget.
// The row stops at min(n_walk, P), at budget 0, or when every candidate
// is taken.  picks[r,k] is the chosen holder row or -1.
//
// Bound: latency of the sequential walk (up to P dependent steps per
// row), then bytes: the candidate arrays and the gathered have[cand, p]
// bytes.  Design: one warp per row; the C candidates are strided across
// the 32 lanes and the winner is a warp argmin over a packed 64-bit
// (key, c) word, lowest c on ties as np.argmin has it.  have[cand, p] is
// gathered on the fly, so the (R, C, P) availability tensor the numpy and
// Pallas versions build never exists.  The taken flags live in dynamic
// shared memory sized by C (or in a caller-provided (R, C) scratch when
// C is too wide for shared memory), never in registers; the free count is
// kept in a register and decremented, not rescanned.
// ----------------------------------------------------------------------
__device__ __forceinline__ unsigned long long pack_key(int32_t key, int c) {
  // flip the sign bit so signed keys order as unsigned words
  unsigned long long k = (unsigned long long)((uint32_t)key ^ 0x80000000u);
  return (k << 32) | (unsigned long long)(uint32_t)c;
}

__global__ void match_requests_kernel(const int32_t* __restrict__ orders,
                                      const int32_t* __restrict__ n_walk,
                                      const int32_t* __restrict__ budgets,
                                      const int32_t* __restrict__ cand,
                                      const uint8_t* __restrict__ cand_ok,
                                      const int32_t* __restrict__ cand_key,
                                      const uint8_t* __restrict__ have,
                                      const uint8_t* __restrict__ full,
                                      int rows, int n_pieces, int n_cand,
                                      uint8_t* __restrict__ scratch,
                                      int32_t* __restrict__ picks) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  uint8_t* taken = scratch != nullptr ? scratch + (size_t)r * n_cand
                                      : smem + (size_t)warp * n_cand;
  const int32_t* crow = cand + (size_t)r * n_cand;
  const int32_t* krow = cand_key + (size_t)r * n_cand;
  const uint8_t* okrow = cand_ok + (size_t)r * n_cand;
  const int32_t* orow = orders + (size_t)r * n_pieces;
  int32_t* prow = picks + (size_t)r * n_pieces;

  int n_free = 0;
  for (int c = lane; c < n_cand; c += 32) {
    uint8_t ok = okrow[c] != 0;
    taken[c] = ok ? 0 : 1;
    n_free += ok;
  }
  for (int off = 16; off > 0; off >>= 1)
    n_free += __shfl_xor_sync(0xffffffffu, n_free, off);
  __syncwarp();

  int budget = budgets[r];
  int walk = n_walk[r];
  if (walk > n_pieces) walk = n_pieces;
  if (walk < 0) walk = 0;
  const unsigned long long kNone = ~0ULL;
  int k = 0;
  for (; k < walk; ++k) {
    if (budget <= 0 || n_free <= 0) break;
    const int p = orow[k];
    unsigned long long best = kNone;
    for (int c = lane; c < n_cand; c += 32) {
      if (taken[c]) continue;
      const int j = crow[c] >= 0 ? crow[c] : 0;   // -1 padding reads row 0
      if (full[j] || have[(size_t)j * n_pieces + p]) {
        unsigned long long w = pack_key(krow[c], c);
        if (w < best) best = w;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      if (o < best) best = o;
    }
    if (best != kNone) {
      const int c = (int)(uint32_t)(best & 0xffffffffULL);
      if (lane == 0) {
        prow[k] = crow[c];
        taken[c] = 1;
      }
      --budget;
      --n_free;
    } else if (lane == 0) {
      prow[k] = -1;
    }
    __syncwarp();
  }
  for (int q = k + lane; q < n_pieces; q += 32) prow[q] = -1;
}

}  // namespace

extern "C" {

int rarest_keys_launch(const void* counts, const void* offsets,
                       const void* missing, const void* cost, long long span,
                       int rows, int n, void* out, void* stream) {
  long long total = (long long)rows * n;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    rarest_keys_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)counts, (const int64_t*)offsets,
        (const uint8_t*)missing, (const int64_t*)cost, span, rows, n,
        (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

int island_has_launch(const void* have, const void* member, int n_rows,
                      int k_islands, int n_pieces, void* out, void* stream) {
  if (k_islands > 0 && n_pieces > 0) {
    const dim3 threads(kIslandLanes, kIslandRows);
    const dim3 blocks((n_pieces + kIslandLanes - 1) / kIslandLanes,
                      k_islands);
    island_has_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)have, (const uint8_t*)member, n_rows, k_islands,
        n_pieces, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// warps_per_block rows share one block; smem_bytes = warps_per_block * C
// when the taken flags sit in shared memory, 0 when scratch is given.
int match_requests_launch(const void* orders, const void* n_walk,
                          const void* budgets, const void* cand,
                          const void* cand_ok, const void* cand_key,
                          const void* have, const void* full, int rows,
                          int n_pieces, int n_cand, void* scratch,
                          int warps_per_block, int smem_bytes, void* picks,
                          void* stream) {
  if (rows > 0) {
    const int blocks = (rows + warps_per_block - 1) / warps_per_block;
    match_requests_kernel<<<blocks, 32 * warps_per_block, smem_bytes,
                            (cudaStream_t)stream>>>(
        (const int32_t*)orders, (const int32_t*)n_walk,
        (const int32_t*)budgets, (const int32_t*)cand,
        (const uint8_t*)cand_ok, (const int32_t*)cand_key,
        (const uint8_t*)have, (const uint8_t*)full, rows, n_pieces, n_cand,
        (uint8_t*)scratch, (int32_t*)picks);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
