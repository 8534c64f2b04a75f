// Hopper (sm_90a) kernels for the batched swarm decision engine
// (repro_torch/core/swarm_kernels.py).  Plain C entry points, loaded with
// ctypes; every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported
// at the call site.
//
// 1. rarest_keys     replaces src/repro/core/swarm_kernels.py
//                    _rarest_keys_pallas (rarest-first composite keys);
//    rarest_orders   the same keys and their stable per-row order in one
//                    kernel (what the hub's pump runs).
// 2. island_has      replaces _island_has_pallas (P4P island availability);
//    island_cost_rows the same reduction fused with everything the hub's
//                    P4P pump builds around it, from its device planes to
//                    the per-row cost rows (what the hub's pump runs).
// 3. match_requests  replaces _match_requests_pallas (greedy holder walk),
//                    dense rows or ragged (CSR) rows in one launch.
//
// Each kernel's note says what bounds it on the card and what the design
// does about it.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr long long kKeyInf = 1LL << 62;   // swarm_kernels.KEY_INF
constexpr unsigned kFull = 0xffffffffu;

// a row's offset reduced to [0, n), once per row
__device__ __forceinline__ int offset_mod(long long offset, int n) {
  long long om = offset % n;
  return (int)(om < 0 ? om + n : om);
}

// the key of piece p < n of a row whose offset mod n is om
__device__ __forceinline__ long long rarest_key(
    const int64_t* __restrict__ counts, int om,
    const uint8_t* __restrict__ missing, const int64_t* __restrict__ cost,
    long long span, int n, size_t idx, int p) {
  const int rot = p + om < n ? p + om : p + om - n;
  long long key = ((long long)counts[p] * n + rot) * n + p;
  if (cost != nullptr) key += (long long)cost[idx] * span;
  if (missing != nullptr && missing[idx] == 0) key = kKeyInf;
  return key;
}

// ----------------------------------------------------------------------
// rarest_keys: key[r,p] = (counts[p]*n + (p + offsets[r]) mod n)*n + p,
// plus cost[r,p]*span when a cost plane is given, and KEY_INF where
// missing[r,p] is 0.
//
// Bound: bytes.  One int64 key written per (row, piece), the mask and the
// cost plane read once; the arithmetic is a handful of integer ops per
// byte.  Design: one thread per (r, p), consecutive threads on
// consecutive pieces so every load and the store coalesce; the mask and
// the cost term are fused here so the (R, P) keys are written once.  Keys
// are int64 throughout, which lifts the Pallas kernel's counts * P^2 <
// 2^31 ceiling.  The hub's pump takes rarest_orders below; this kernel
// serves callers that want the keys, and piece counts above the sorting
// kernel's width (keys, then torch.sort).
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
  out[idx] = rarest_key(counts, offset_mod(offsets[r], n), missing, cost,
                        span, n, (size_t)idx, p);
}

// ----------------------------------------------------------------------
// rarest_orders: the keys above and, per row, the stable ascending order
// of its keys as int32 piece ids (torch.sort(stable=True) on the keys).
//
// Bound: bytes (mask and cost read once, the int32 order written once);
// at the pump's R <= 2000, P = 64 that is ~0.2 us, below what one launch
// costs, so what matters is that keys, sort and cast are one launch and
// the int64 keys never reach device memory.  Design: the sort is on
// (key, index) pairs, which is exactly a stable sort: non-INF keys of a
// row are distinct anyway (each embeds p), KEY_INF entries tie and the
// index orders them.  Rows pad to a power of two with (INT64_MAX, index
// >= n).  P <= 64: one warp per row, two pairs a lane (element e = s*32 +
// lane), a bitonic network over register shuffles.  Wider rows take the
// keys kernel and torch.sort.
// ----------------------------------------------------------------------
__device__ __forceinline__ bool pair_less(long long a, int ai, long long b,
                                          int bi) {
  return a < b || (a == b && ai < bi);
}

constexpr int kOrderWarps = 4;   // rows per block of the warp route

__global__ void rarest_orders_warp_kernel(const int64_t* __restrict__ counts,
                                          const int64_t* __restrict__ offsets,
                                          const uint8_t* __restrict__ missing,
                                          const int64_t* __restrict__ cost,
                                          long long span, int rows, int n,
                                          int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kOrderWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int om = offset_mod(offsets[r], n);
  long long key[2];
  int id[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int p = s * 32 + lane;
    id[s] = p;
    key[s] = p < n ? rarest_key(counts, om, missing, cost, span, n,
                                (size_t)r * n + p, p)
                   : LLONG_MAX;
  }
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {
        // k == 64: slot 0 against slot 1 of the same lane, ascending
        if (pair_less(key[1], id[1], key[0], id[0])) {
          long long tk = key[0]; key[0] = key[1]; key[1] = tk;
          int ti = id[0]; id[0] = id[1]; id[1] = ti;
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int e = s * 32 + lane;
          const bool asc = (e & k) == 0;
          const long long ok = __shfl_xor_sync(kFull, key[s], j);
          const int oi = __shfl_xor_sync(kFull, id[s], j);
          // the lower element of an ascending pair keeps the smaller
          const bool other_first = pair_less(ok, oi, key[s], id[s]);
          if (other_first == (lower == asc)) {
            key[s] = ok;
            id[s] = oi;
          }
        }
      }
    }
  }
  int32_t* orow = out + (size_t)r * n;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = s * 32 + lane;
    if (e < n) orow[e] = id[s];
  }
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
// is taken.  picks[r,k] is the chosen holder row or -1.  Rows are dense
// (row r's candidates at r*stride, degree stride) or ragged (CSR:
// cand_ptr[r] .. cand_ptr[r+1]); row r walks orders[row_of[r]], so the
// pump's order rows are read in place.
//
// Bound: latency of the walk (up to P dependent steps a row); the bytes
// (candidate arrays, one have row per candidate) are ~0.4 us at the
// pump's sizes.  Design (register route, P <= 64 and degree <= 512):
//  * a row's candidates are sorted once by the packed (key, c) word, so
//    the winner at any step is the FIRST sorted candidate that is untaken
//    and holds p (lowest key, then lowest c, as np.argmin);
//  * each lane keeps its sorted candidates' have rows as 64-bit masks
//    (all ones where full), loaded once with 16-byte loads, in one round
//    with no branch on full; a pick clears its mask, so the untaken set
//    lives in the masks too;
//  * a step is a shift per slot and a find-first-set in each lane (its
//    slots are sorted), then the minimum over the lanes' first available
//    words in two single-instruction warp reductions.  No load from
//    memory and no shuffle tree;
//  * a warp a row, ceil(degree / 32) slots a lane (a power of two), 4
//    rows a block.
// Wide route (P > 64, or degree > 512): the block's 4 warps walk such a
// row together after their own rows; each candidate's packed word and
// have mask (ceil(P / 64) words) go once to a scratch beside the CSR, and
// a step scans them and takes the block's minimum.
// ----------------------------------------------------------------------
constexpr int kRowsPerBlock = 4;
constexpr int kRegMaxDegree = 512;
constexpr unsigned long long kNone = ~0ULL;

struct MatchArgs {
  const int32_t* orders;     // (orders rows, P)
  const int32_t* row_of;     // (rows,) or null: row r walks orders[r]
  const int32_t* cand_ptr;   // (rows + 1,) or null: dense, stride
  int stride;
  const int32_t* n_walk;
  const int32_t* budgets;
  const int32_t* cand;
  const uint8_t* cand_ok;
  const int32_t* cand_key;
  const uint8_t* have;       // (N, P)
  const uint8_t* full;       // (N,)
  int rows;
  int P;
  // wide route: 1 + ceil(P / 64) words per candidate slot, or null
  unsigned long long* scratch;
  long long n_slots;         // candidate slots: R * stride, or the CSR's
  int32_t* picks;            // (rows, P)
};

__device__ __forceinline__ unsigned long long pack_key(int32_t key, int c) {
  // flip the sign bit so signed keys order as unsigned words
  unsigned long long k = (unsigned long long)((uint32_t)key ^ 0x80000000u);
  return (k << 32) | (unsigned long long)(uint32_t)c;
}

// the warp's smallest 64-bit word, in two single-instruction reductions
__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long v) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, (unsigned)(v >> 32) == hi ? (unsigned)v : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ void cmp_swap(unsigned long long& x,
                                         unsigned long long& y, bool asc) {
  const bool swap = (y < x) == asc;
  const unsigned long long lo = swap ? y : x;
  y = swap ? x : y;
  x = lo;
}

__device__ __forceinline__ void row_span(const MatchArgs& a, int r,
                                         int& start, int& deg) {
  if (a.cand_ptr != nullptr) {
    start = a.cand_ptr[r];
    deg = a.cand_ptr[r + 1] - start;
  } else {
    start = r * a.stride;
    deg = a.stride;
  }
}

__device__ __forceinline__ const int32_t* order_row(const MatchArgs& a,
                                                    int r) {
  const int o = a.row_of != nullptr ? a.row_of[r] : r;
  return a.orders + (size_t)o * a.P;
}

// bit i set where byte i of x is not zero: the top bit of each byte of
// y says so (no carry crosses a byte), and the multiply gathers the four
// top bits into bits 28..31
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  const unsigned y = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((y >> 7) * 0x10204080u) >> 28;
}

// up to 64 bytes of a have row as a bit mask: bit p set where
// row[p] & byte_mask is not zero
__device__ __forceinline__ unsigned long long have_bits(
    const uint8_t* __restrict__ row, int len, unsigned byte_mask = 0xffu) {
  unsigned long long bits = 0;
  if ((len & 15) == 0 && ((uintptr_t)row & 15) == 0) {
    const unsigned rep = (byte_mask & 0xffu) * 0x01010101u;
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < (len >> 4)) {
        const uint4 x = __ldg(v + q);
        const unsigned nib = nonzero_bytes(x.x & rep) |
                             nonzero_bytes(x.y & rep) << 4 |
                             nonzero_bytes(x.z & rep) << 8 |
                             nonzero_bytes(x.w & rep) << 12;
        bits |= (unsigned long long)nib << (16 * q);
      }
    }
  } else {
    for (int p = 0; p < len; ++p)
      if (row[p] & byte_mask) bits |= 1ULL << p;
  }
  return bits;
}

// The register route: one row per warp, S slots a lane (S a power of
// two, 32 * S >= degree).  Lane l's slot s loads candidate c = s * 32 + l
// (coalesced), then the lane sorts its S slots; ``scand`` is the warp's
// shared scratch of kRegMaxDegree ints.
template <int S>
__device__ void match_row_reg(const MatchArgs& a, int r, int lane,
                              int* scand) {
  int start, deg;
  row_span(a, r, start, deg);
  const int walk = min(max(a.n_walk[r], 0), a.P);
  int budget = a.budgets[r];

  // one round of loads: the packed (key, c) words of the usable
  // candidates (the rest sort last), their holder rows, and the order
  // (positions lane and lane + 32; P <= 64)
  unsigned long long w[S];
  int cpre[S];
  int n_free = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = s * 32 + lane;
    w[s] = kNone;
    cpre[s] = -1;
    if (c < deg) {
      cpre[s] = a.cand[start + c];
      if (a.cand_ok[start + c]) {
        w[s] = pack_key(a.cand_key[start + c], c);
        ++n_free;
      }
    }
  }
  const int32_t* orow = order_row(a, r);
  const int ord0 = lane < a.P ? orow[lane] : 0;
  const int ord1 = lane + 32 < a.P ? orow[lane + 32] : 0;
  n_free = __reduce_add_sync(kFull, n_free);

  // bitonic sort of each lane's S slots
#pragma unroll
  for (int k = 2; k <= S; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if ((s & j) == 0) cmp_swap(w[s], w[s | j], (s & k) == 0);
    }
  }

  // each sorted slot's holder row (through shared memory, by c) and its
  // availability mask
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = s * 32 + lane;
    if (c < deg) scand[c] = cpre[s];
  }
  __syncwarp();
  unsigned long long m[S];
  int cj[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    m[s] = 0;
    cj[s] = -1;
    if (w[s] != kNone) cj[s] = scand[(int)(uint32_t)(w[s] & 0xffffffffULL)];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (w[s] != kNone) {
      const int j = cj[s] >= 0 ? cj[s] : 0;   // -1 reads row 0, as plain
      const unsigned long long hb = have_bits(a.have + (size_t)j * a.P, a.P);
      m[s] = a.full[j] ? kNone : hb;
    }
  }

  // every lane holds the same walk, budget and free count: the loop and
  // its exits are uniform over the warp
  int32_t* prow = a.picks + (size_t)r * a.P;
  unsigned long long picked = 0;
  for (int k = 0; k < walk && budget > 0 && n_free > 0; ++k) {
    const int p = __shfl_sync(kFull, k < 32 ? ord0 : ord1, k & 31);
    unsigned local = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      local |= (unsigned)((m[s] >> p) & 1ULL) << s;
    // each lane's first hit is its smallest; the warp's smallest wins
    const int first = __ffs(local) - 1;
    unsigned long long wv = kNone;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s == first) wv = w[s];
    const unsigned long long win = warp_min64(wv);
    if (win == kNone) continue;
    if (wv == win) {   // words are distinct: one lane
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s == first) {
          prow[k] = cj[s];
          m[s] = 0;
        }
      }
    }
    picked |= 1ULL << k;
    --budget;
    --n_free;
  }
  for (int q = lane; q < a.P; q += 32)
    if (!((picked >> q) & 1ULL)) prow[q] = -1;
}

// the wide route: the block's 128 threads walk one row together.  The
// scratch holds, beside the CSR, each candidate slot's packed word (~0
// once taken or if unusable) and then its have mask words (word q of slot
// i at n_slots * (1 + q) + i, all ones where full, 0 where unusable).
// Thread t handles c = t + 128 i, so every access coalesces and no thread
// reads another's entries; a step is each thread's scan, a warp minimum
// and the minimum of the 4 warps' in shared memory.
constexpr int kBlockThreads = 32 * kRowsPerBlock;

__device__ void match_row_wide(const MatchArgs& a, int r,
                               unsigned long long* wmin, int* wcount) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int start, deg;
  row_span(a, r, start, deg);
  const int W = (a.P + 63) >> 6;
  unsigned long long* word = a.scratch + start;
  unsigned long long* mask = a.scratch + a.n_slots + start;
  const int32_t* orow = order_row(a, r);
  int32_t* prow = a.picks + (size_t)r * a.P;

  int n_free = 0;
#pragma unroll 4
  for (int c = tid; c < deg; c += kBlockThreads) {
    const bool ok = a.cand_ok[start + c] != 0;
    const int32_t key = a.cand_key[start + c];
    const int j0 = a.cand[start + c];
    const int j = j0 >= 0 ? j0 : 0;   // -1 reads row 0, as plain
    const bool f = a.full[j] != 0;
    const uint8_t* hrow = a.have + (size_t)j * a.P;
    if (W == 1) {
      const unsigned long long hb = have_bits(hrow, a.P);
      mask[c] = ok ? (f ? kNone : hb) : 0ULL;
    } else {
      for (int q = 0; q < W; ++q) {
        const unsigned long long hb =
            have_bits(hrow + 64 * q, min(64, a.P - 64 * q));
        mask[(size_t)q * a.n_slots + c] = ok ? (f ? kNone : hb) : 0ULL;
      }
    }
    word[c] = ok ? pack_key(key, c) : kNone;
    n_free += ok;
  }
  for (int off = 16; off > 0; off >>= 1)
    n_free += __shfl_xor_sync(kFull, n_free, off);
  if (lane == 0) wcount[warp] = n_free;
  __syncthreads();
  n_free = 0;
#pragma unroll
  for (int w = 0; w < kRowsPerBlock; ++w) n_free += wcount[w];

  int budget = a.budgets[r];
  const int walk = min(max(a.n_walk[r], 0), a.P);
  int k = 0;
  for (; k < walk; ++k) {
    if (budget <= 0 || n_free <= 0) break;
    const int p = orow[k];
    const unsigned long long* mq = mask + (size_t)(p >> 6) * a.n_slots;
    const int bit = p & 63;
    unsigned long long best = kNone;
#pragma unroll 8
    for (int c = tid; c < deg; c += kBlockThreads) {
      const unsigned long long mw = mq[c];
      const unsigned long long wv = word[c];
      best = ((mw >> bit) & 1ULL) ? min(best, wv) : best;
    }
    best = warp_min64(best);
    if (lane == 0) wmin[warp] = best;
    __syncthreads();
    unsigned long long win = wmin[0];
#pragma unroll
    for (int w = 1; w < kRowsPerBlock; ++w) win = min(win, wmin[w]);
    if (win != kNone) {
      const int c = (int)(uint32_t)(win & 0xffffffffULL);
      if (tid == c % kBlockThreads) {   // c's own thread marks it taken
        prow[k] = a.cand[start + c];
        word[c] = kNone;
      }
      --budget;
      --n_free;
    } else if (tid == 0) {
      prow[k] = -1;
    }
    __syncthreads();   // wmin is rewritten by the next step
  }
  for (int q = k + tid; q < a.P; q += kBlockThreads) prow[q] = -1;
  __syncthreads();     // wcount is rewritten by the next wide row
}

__global__ void match_requests_kernel(MatchArgs a) {
  __shared__ int scand[kRowsPerBlock][kRegMaxDegree];
  __shared__ unsigned long long wmin[kRowsPerBlock];
  __shared__ int wcount[kRowsPerBlock];
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x >> 5;
  const int base = blockIdx.x * kRowsPerBlock;
  // every warp reads the block's 4 degrees: its own, and the wide rows
  const int rq = base + (lane & (kRowsPerBlock - 1));
  int dq = 0;
  if (rq < a.rows) {
    int st;
    row_span(a, rq, st, dq);
  }
  const unsigned wide = __ballot_sync(
      kFull, lane < kRowsPerBlock && rq < a.rows &&
                 (a.P > 64 || dq > kRegMaxDegree));
  // a warp a row on the register route; the block's wide rows after that,
  // each by the whole block (every warp reaches the same barriers)
  const int r = base + sub;
  const int d = __shfl_sync(kFull, dq, sub);
  if (r < a.rows && !((wide >> sub) & 1u)) {
    if (d <= 32) {
      match_row_reg<1>(a, r, lane, scand[sub]);
    } else if (d <= 64) {
      match_row_reg<2>(a, r, lane, scand[sub]);
    } else if (d <= 128) {
      match_row_reg<4>(a, r, lane, scand[sub]);
    } else if (d <= 256) {
      match_row_reg<8>(a, r, lane, scand[sub]);
    } else {
      match_row_reg<16>(a, r, lane, scand[sub]);
    }
  }
  for (int q = 0; q < kRowsPerBlock; ++q)
    if ((wide >> q) & 1u) match_row_wide(a, base + q, wmin, wcount);
}

// ----------------------------------------------------------------------
// island_cost_rows: the P4P cost plane of a pump in one launch.
//   avail[k,p] = OR over rows i < n with island[i] == k of
//                ((have[i,p] | full[i]) & alive[i]) != 0
//   out[r,p]   = min over k of (avail[k,p] ? cost[s,k] : COST_NONE),
//                s = island[rows[r]]
// which is island_has on the alive have plane, min_island_cost and the
// gather by island[rows] of swarm_kernels.py, bit for bit.
//
// Bound: bytes (the (n, P) have plane and the (R, P) int64 rows, ~0.3 MB
// at N = R = 500, P = 64: ~0.0001 ms), far below what one launch costs;
// what the hub paid was the ~11 launches of that composition (plane ops,
// the member matrix, island_has, min_island_cost, two gathers), so the
// design is one launch whose dependent memory round trips are few:
//  * one thread-block cluster of 8 blocks (distributed shared memory), so
//    the reduction over rows needs no global atomics, no zeroed scratch
//    and no second launch;
//  * a lane per row: its full / alive / island, then its 64-piece chunk
//    of have in four 16-byte loads, packed to a 64-bit mask (byte-wise
//    `& alive` kept exact); a full and alive row contributes every piece
//    without a load.  The warp then ORs its 32 masks island by island
//    (one __reduce_or_sync pair per island present in the batch) and the
//    first lane of each island ORs the result into the block's
//    bits[K][ceil(P/32)] in shared memory; consecutive 32-row batches go
//    to different blocks;
//  * after cluster.sync() each block ORs its peers' bits into its own
//    through map_shared_rank (OR is idempotent, so a peer reading a word
//    while it is widened still reads a superset of the block's own bits),
//    then arrives at a second cluster barrier that it waits on only
//    before it exits;
//  * the (K, K) cost matrix is loaded into shared memory while the rows
//    are reduced, and the cost plane per source island is computed once
//    per block in shared memory, a tile of up to 2048 int64 entries (K x
//    TP pieces) at a time; each warp copies its rows' island rows of it
//    out (rows gw, gw + 64, ...: a few rows a warp, each warp's chain of
//    rows unrolled), with the rows' islands loaded at the start, beside
//    the reduction.
// Limits: K <= 64, P <= 4096 (cost 32 KB, bits 32 KB and the plane tile
// 16 KB of shared memory at most).  Rows outside [0, cap) and islands
// outside [0, K) (which the plain version rejects) contribute nothing and
// read COST_NONE.
// ----------------------------------------------------------------------
constexpr int kCostCluster = 8;          // blocks, one cluster
constexpr int kCostWarps = 8;            // warps a block
constexpr int kCostWarpsAll = kCostCluster * kCostWarps;
constexpr int kCostMaxIslands = 64;
constexpr int kCostMaxPieces = 4096;
constexpr int kCostPlaneEntries = 2048;  // int64 plane tile, 16 KB
constexpr long long kCostNone = 64;      // swarm_kernels.COST_NONE

// the island of leecher row r, or -1 (r past R, a row outside [0, cap),
// an island outside [0, K))
__device__ __forceinline__ int row_island(const int64_t* __restrict__ rows,
                                          const int64_t* __restrict__ island,
                                          int cap, int K, int R, int r) {
  if (r >= R) return -1;
  const long long row = rows[r];
  if (row < 0 || row >= cap) return -1;
  const long long is = island[row];
  return is >= 0 && is < K ? (int)is : -1;
}

__global__ void __cluster_dims__(kCostCluster, 1, 1)
__launch_bounds__(32 * kCostWarps)
island_cost_rows_kernel(const uint8_t* __restrict__ have,
                        const uint8_t* __restrict__ full,
                        const uint8_t* __restrict__ alive,
                        const int64_t* __restrict__ island,
                        const int64_t* __restrict__ rows,
                        const int64_t* __restrict__ cost, int cap, int n,
                        int P, int K, int R, int TP,
                        int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (P + 31) >> 5;
  // [K][K] cost, [K][TP] plane tile, [K][C] availability bits
  long long* cost_s = reinterpret_cast<long long*>(cost_smem);
  long long* plane = cost_s + K * K;
  unsigned* bits = reinterpret_cast<unsigned*>(plane + K * TP);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  // warp w of block b is the cluster's warp w * 8 + b: consecutive
  // batches on different SMs
  const int gw = (tid >> 5) * kCostCluster + rank;
  for (int w = tid; w < K * C; w += blockDim.x) bits[w] = 0;
  for (int w = tid; w < K * K; w += blockDim.x) cost_s[w] = cost[w];
  // the warp's leecher rows are gw + 64 j; lane j holds row j's island,
  // loaded while the rows are reduced (at R <= 2048 a warp has no more)
  const int s_first =
      row_island(rows, island, cap, K, R, gw + kCostWarpsAll * lane);
  __syncthreads();

  // 1. rows [0, n) into island bits
  const int nb = (n + 31) >> 5;
  for (int g = gw; g < nb; g += kCostWarpsAll) {
    const int i = g * 32 + lane;
    unsigned a = 0, fa = 0;
    int isl = -1;
    if (i < n) {
      const long long s = island[i];
      a = alive[i];
      fa = full[i] & a;
      isl = s >= 0 && s < K ? (int)s : -1;
    }
    const bool live = isl >= 0 && a != 0;
    for (int c64 = 0; c64 * 64 < P; ++c64) {
      const int len = min(64, P - c64 * 64);
      unsigned long long m = 0;
      if (live) {
        m = fa != 0 ? (len == 64 ? ~0ULL : (1ULL << len) - 1ULL)
                    : have_bits(have + (size_t)i * P + c64 * 64, len, a);
      }
      unsigned pending = __ballot_sync(kFull, m != 0);
      while (pending != 0) {
        const int leader = __ffs(pending) - 1;
        const int k = __shfl_sync(kFull, isl, leader);
        const bool mine = isl == k && m != 0;
        const unsigned lo = __reduce_or_sync(kFull, mine ? (unsigned)m : 0u);
        const unsigned hi =
            __reduce_or_sync(kFull, mine ? (unsigned)(m >> 32) : 0u);
        if (lane == leader) {
          const int w = k * C + 2 * c64;
          if (lo != 0) atomicOr(&bits[w], lo);
          if (hi != 0) atomicOr(&bits[w + 1], hi);   // hi != 0: len > 32
        }
        pending &= ~__ballot_sync(kFull, mine);
      }
    }
  }

  // 2. the cluster's bits: each block ORs its peers' into its own
  cluster.sync();
  for (int w = tid; w < K * C; w += blockDim.x) {
    unsigned v = bits[w];
    for (int q = 0; q < kCostCluster; ++q)
      if (q != rank) v |= cluster.map_shared_rank(bits, q)[w];
    bits[w] = v;
  }
  __syncthreads();
  // this block is done with its peers' shared memory; the wait at the
  // end keeps each block's bits alive until every peer has read them
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // 3. the cost plane, a tile of TP pieces at a time, and the rows
  const int my_rows = R > gw ? (R - gw + kCostWarpsAll - 1) / kCostWarpsAll
                             : 0;
  for (int p0 = 0; p0 < P; p0 += TP) {
    const int tp = min(TP, P - p0);
    for (int e = tid; e < K * tp; e += blockDim.x) {
      const int s = e / tp;
      const int q = e - s * tp;
      const int p = p0 + q;
      const long long* crow = cost_s + s * K;
      long long m = LLONG_MAX;
      for (int k = 0; k < K; ++k) {
        const bool has = (bits[k * C + (p >> 5)] >> (p & 31)) & 1u;
        const long long v = has ? crow[k] : kCostNone;
        m = v < m ? v : m;
      }
      plane[s * TP + q] = m;
    }
    __syncthreads();
    for (int j0 = 0; j0 < my_rows; j0 += 32) {
      const int s = j0 == 0 ? s_first
                            : row_island(rows, island, cap, K, R,
                                         gw + kCostWarpsAll * (j0 + lane));
      const int nj = min(32, my_rows - j0);
      // rows are independent: unrolled, their shuffle, shared load and
      // store chains overlap
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const int sj = __shfl_sync(kFull, s, j);
        int64_t* orow =
            out + (size_t)(gw + kCostWarpsAll * (j0 + j)) * P + p0;
        for (int q = lane; q < tp; q += 32)
          orow[q] = sj >= 0 ? plane[sj * TP + q] : kCostNone;
      }
    }
    __syncthreads();   // the next tile rewrites the plane
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// n <= 64 (one warp a row); wider rows are the caller's keys + torch.sort.
int rarest_orders_launch(const void* counts, const void* offsets,
                         const void* missing, const void* cost,
                         long long span, int rows, int n, void* out,
                         void* stream) {
  if (n > 64) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    rarest_orders_warp_kernel<<<(rows + kOrderWarps - 1) / kOrderWarps,
                                32 * kOrderWarps, 0, (cudaStream_t)stream>>>(
        (const int64_t*)counts, (const int64_t*)offsets,
        (const uint8_t*)missing, (const int64_t*)cost, span, rows, n,
        (int32_t*)out);
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

// have (cap, P) uint8, full / alive (cap,) uint8, island (cap,) int64:
// rows [0, n) are reduced; rows (R,) int64 index [0, cap); cost (K, K)
// int64; out (R, P) int64.  K in [1, 64], P in [1, 4096].
int island_cost_rows_launch(const void* have, const void* full,
                            const void* alive, const void* island,
                            const void* rows, const void* cost, int cap,
                            int n, int n_pieces, int k_islands, int n_rows,
                            void* out, void* stream) {
  if (k_islands < 1 || k_islands > kCostMaxIslands || n_pieces < 1 ||
      n_pieces > kCostMaxPieces || n < 0 || n > cap || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    // the plane tile: as many 32-piece chunks as 2048 entries hold
    const int chunks = (n_pieces + 31) / 32;
    const int fit = kCostPlaneEntries / (32 * k_islands);
    const int tp = 32 * (fit < 1 ? 1 : (fit < chunks ? fit : chunks));
    const size_t smem =
        (size_t)k_islands * (k_islands + tp) * sizeof(long long) +
        (size_t)k_islands * chunks * sizeof(unsigned);
    static bool wide_smem = false;   // more than 48 KB needs an opt-in
    if (smem > 48 * 1024 && !wide_smem) {
      const cudaError_t e = cudaFuncSetAttribute(
          island_cost_rows_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, 80 * 1024);
      if (e != cudaSuccess) return (int)e;
      wide_smem = true;
    }
    island_cost_rows_kernel<<<kCostCluster, 32 * kCostWarps, smem,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)have, (const uint8_t*)full, (const uint8_t*)alive,
        (const int64_t*)island, (const int64_t*)rows, (const int64_t*)cost,
        cap, n, n_pieces, k_islands, n_rows, tp, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// row_of null: row r walks orders[r]; cand_ptr null: dense rows of
// `stride` candidates.  max_degree is the largest row degree; when P > 64
// or max_degree > 512 (the wide route) scratch must hold 1 + ceil(P / 64)
// 8-byte words per candidate slot, else it may be null.
int match_requests_launch(const void* orders, const void* row_of,
                          const void* cand_ptr, int stride,
                          const void* n_walk, const void* budgets,
                          const void* cand, const void* cand_ok,
                          const void* cand_key, const void* have,
                          const void* full, int rows, int n_pieces,
                          int max_degree, int n_slots, void* scratch,
                          void* picks, void* stream) {
  if ((n_pieces > 64 || max_degree > kRegMaxDegree) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    MatchArgs a;
    a.orders = (const int32_t*)orders;
    a.row_of = (const int32_t*)row_of;
    a.cand_ptr = (const int32_t*)cand_ptr;
    a.stride = stride;
    a.n_walk = (const int32_t*)n_walk;
    a.budgets = (const int32_t*)budgets;
    a.cand = (const int32_t*)cand;
    a.cand_ok = (const uint8_t*)cand_ok;
    a.cand_key = (const int32_t*)cand_key;
    a.have = (const uint8_t*)have;
    a.full = (const uint8_t*)full;
    a.rows = rows;
    a.P = n_pieces;
    a.scratch = (unsigned long long*)scratch;
    a.n_slots = n_slots;
    a.picks = (int32_t*)picks;
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    match_requests_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                            (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
