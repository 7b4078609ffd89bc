// Fused serve kernel: scores = vecs @ factors^T, ban/valid masking and
// top-k, without the [bucket, n_items] score matrix ever reaching device
// memory.
//
// Replaces predictionio_tpu/ops/fused_topk.py::_merge_body with
// _kernel_static (K1, the single-device form) and _kernel_dynamic (K2,
// the sharded form, reached through shard_local_candidates), both built
// by _pallas_topk. Semantics are the same: the product is exact fp32
// (one fmaf chain per score over r = 0..rank4-1 from 0.0f, the rank zero
// padded to a multiple of 4; no TF32, no bf16, no tensor cores); ids >=
// n_valid and each row's banned ids score NEG_INF = -1e30 and can still
// be emitted; the order is (score desc, id asc), lax.top_k's lowest-index
// tie-break, on the key (score_key(score), ~id), so an all-banned row
// gives ids 0..k-1. `banned` holds ids offset by the runtime id_base: an
// id g is banned in this call exactly when (unsigned)(g - id_base) <
// n_rows, so the n_items filler and another shard's ids match nothing,
// and the emitted ids are local + id_base. K1 is id_base 0; K2 passes
// its shard's first global row and n_valid, so one kernel serves both.
//
// Bound on this card. Per call the kernel must read the factor matrix
// once (n_rows * rank * 4 B) and do 2 * bucket * n_rows * rank fp32
// operations on CUDA cores: max(bytes / HBM rate, flops / fp32 rate). At
// 500,000 x 64 on an H100 SXM (NVIDIA data sheet: 3.35 TB/s, 67 TFLOP/s
// fp32 outside the tensor cores, at 700 W) the 128 MB take 38.2 us and
// the operations bucket x 0.955 us: memory-bound up to bucket 40 (the
// serve path's buckets 1-8 above all), compute-bound above (61.1 us at
// bucket 64). chip_smoke.py recomputes the bound for the card nvidia-smi
// names and prints it beside the measured time and the power limit.
//
// Design (pass 1, score_blocks; pass 2, merge_blocks), against the four
// costs of the first version (one block per 128-item tile):
//  1. Selection per tile: k rounds of a warp argmax per row and tile
//     made the first version latency-bound. Now each (warp, row) keeps a
//     running top-k list, sorted, in shared memory, and a float
//     threshold `pass`: a raw score below it costs one compare, and a
//     row of a tile with no score at or above it one vote. Scores that
//     reach it go to a 32-entry buffer beside the list (ballot, popc);
//     a full buffer is flushed: each lane masks one candidate (id past
//     n_valid, or among the row's bans, read by broadcast loads through
//     L1: NEG_INF key), the warp sorts the candidates (bitonic, 15
//     shuffle steps) and merges them into the list (a half-cleaner on
//     list entry l against candidate 31 - l). `pass` rises with the
//     list's k-th key and with the row's bound: every list publishes its
//     best key into slot (list index mod k) of the row's k slots in
//     global memory (atomicMax), so the least slot is the key of the
//     worst of k distinct items, at most the row's final k-th key; each
//     list reads the slots on every 8th tile (an L2 line that all the
//     row's lists share). The slots persist across calls: each word
//     carries the call's generation above the key, so no launch resets
//     them, and a word of another call (an older one, or one running on
//     another stream) counts as no bound. On the first tile each lane
//     flushes its best item first, so the empty list does not let the
//     whole tile through. The order inside the lists is the full (key,
//     ~id) pair; empty slots hold the key (0, 0), below every real key,
//     never emitted.
//  2. Scratch as large as the work: candidates go out once per block,
//     not per tile: [bucket, n_blocks, k] (key, ~id) pairs for a few
//     hundred blocks. Pass 2 merges those lists by their heads, one
//     thread per block list, so no per-tile state and no ceiling on the
//     catalog size.
//  3. Re-staging per tile: blocks are persistent. The grid is the SM
//     count (read at launch) times the blocks per SM that fit, clamped
//     to the tile count, and each block walks a contiguous tile range,
//     staging the bucket's queries once. No division in the copy loops
//     (the row/chunk pair is stepped with a carry).
//  4. No overlap: factor tiles come through a ring of 2-4 shared-memory
//     stages filled with 16-byte cp.async (4-byte where the rank is not a
//     multiple of 4 or the rows are not 16-byte aligned); the load of
//     tile i + stages - 1 is in flight while tile i is scored. The stage
//     count is the one that gives the most stages per SM (1 block of 3
//     stages of 256 items at bucket 1: ~200 KB in flight per SM). The
//     ragged last tile zero-fills the rows past n_rows and never reads
//     them from global memory.
// The product is register-tiled: 8 warps; a warp owns RPT query rows x
// IPT items per lane. Small buckets take 256-item tiles split over the
// warps (bucket 1: every warp 32 items of the one row), so every warp
// scores and selects; larger buckets take 128-item tiles and give each
// warp rows w, w + 8, ... Factor rows are staged at an odd stride of
// 16-byte chunks, so the float4 reads of 8 consecutive lanes hit
// distinct banks; query reads are warp broadcasts. Each (warp, row) list
// of a row is merged into the block's list in the epilogue.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;         // pass-1 block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kMaxBucket = 128;
constexpr int kMaxStages = 4;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxBlocks = 1024;      // pass 2: one thread per block list
constexpr int kBuf = 32;              // buffered candidates per (warp, row)
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Larger key = better. Monotone in the float for every non-NaN value;
// +0.0f is added first so -0.0 and +0.0 tie, as they compare equal.
__device__ __forceinline__ unsigned score_key(float s) {
  unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  unsigned u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

// (key, ~id) as one 64-bit word: the larger word is the better entry
// under (score desc, id asc)
__device__ __forceinline__ unsigned long long pair(unsigned hi,
                                                   unsigned lo) {
  return ((unsigned long long)hi << 32) | lo;
}

// (hi, lo) = (score key, ~id): the warp's best pair under (score desc,
// id asc), returned to every lane.
__device__ __forceinline__ void warp_best(unsigned& hi, unsigned& lo) {
  unsigned m = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, hi == m ? lo : 0u);
  hi = m;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// Copy rows [tile * TI, tile * TI + TI) of the factors into a ring stage
// of TI rows at `fstride` floats; rows past n_rows are zero-filled.
template <int TI>
__device__ __forceinline__ void issue_tile(
    float* dst, const float* __restrict__ factors, int tile, int rank,
    int rank4, int fstride, int n_rows, bool vec16) {
  const int tid = threadIdx.x;
  const int first = tile * TI;
  const int rows = min(TI, n_rows - first);
  const float* src = factors + (size_t)first * rank;
  // element e of the tile's flat copy is (row it, column c) of the
  // stage; the pair is stepped with a carry instead of a division
  const int width = vec16 ? (rank >> 2) : rank;
  const int total = rows * width;
  const int dit = kThreads / width, dc = kThreads - dit * width;
  int it = tid / width, c = tid - it * width;
  for (int e = tid; e < total; e += kThreads) {
    if (vec16)
      cp_async16(dst + it * fstride + 4 * c, src + (size_t)e * 4);
    else
      cp_async4(dst + it * fstride + c, src + e);
    it += dit;
    c += dc;
    if (c >= width) { c -= width; ++it; }
  }
  if (rows < TI) {   // the ragged last tile: zeros, never read
    for (int e = tid; e < (TI - rows) * rank4; e += kThreads) {
      const int r = e / rank4;
      dst[(rows + r) * fstride + (e - r * rank4)] = 0.f;
    }
  }
}

// Sort one 64-bit word per lane in descending order across the warp
// (bitonic: 15 compare-exchange steps).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
      v = ((lane & stride) == 0) == ((lane & size) == 0) ? max(v, o)
                                                         : min(v, o);
    }
  return v;
}

// Sort a bitonic sequence of one word per lane in descending order.
__device__ __forceinline__ unsigned long long warp_merge(
    unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
    v = (lane & stride) == 0 ? max(v, o) : min(v, o);
  }
  return v;
}

__device__ __forceinline__ unsigned long long load_pair(const uint2* p) {
  const uint2 e = *p;
  return pair(e.x, e.y);
}

__device__ __forceinline__ void store_pair(uint2* p, unsigned long long v) {
  *p = make_uint2((unsigned)(v >> 32), (unsigned)v);
}

// Flush a (warp, row) buffer of n <= 32 raw candidates into its sorted
// list L [k]. Lane l masks buffered candidate l: an id past n_valid or
// among the row's bans (ids offset by id_base; every lane reads the same
// ban, one broadcast load) takes the NEG_INF key. The candidates are
// sorted across the warp and merged with the list: the larger of list
// entry l and candidate 31 - l is a bitonic sequence holding the best 32
// of both, sorted by a half-cleaner; for k > 32 the list's second half
// is merged with the candidates first. Ids are unique, and the empty
// (0, 0) slots rank after every real key. Kept out of line: the hot
// loop only calls it.
__device__ __noinline__ void flush_buffer(uint2* L, const uint2* buf, int n,
                                          int k, int n_valid,
                                          const int* __restrict__ row_bans,
                                          int width, unsigned id_base) {
  const int lane = threadIdx.x & 31;
  unsigned long long c = 0ull;
  if (lane < n) {
    const uint2 e = buf[lane];
    const unsigned lid = ~e.y;
    bool hit = lid >= (unsigned)n_valid;
    if ((width & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(row_bans) & 15) == 0) {
      const int4* b4 = reinterpret_cast<const int4*>(row_bans);
#pragma unroll 4
      for (int w = 0; w < (width >> 2); ++w) {
        const int4 g = __ldg(b4 + w);
        hit |= ((unsigned)g.x - id_base == lid) |
               ((unsigned)g.y - id_base == lid) |
               ((unsigned)g.z - id_base == lid) |
               ((unsigned)g.w - id_base == lid);
      }
    } else {
#pragma unroll 4
      for (int w = 0; w < width; ++w)
        hit |= (unsigned)__ldg(row_bans + w) - id_base == lid;
    }
    c = pair(hit ? score_key(kNegInf) : e.x, e.y);
  }
  c = warp_sort(c);
  const unsigned long long up = __shfl_sync(kFull, c, 31 - lane);
  const unsigned long long a = lane < k ? load_pair(L + lane) : 0ull;
  if (k <= 32) {
    const unsigned long long x = warp_merge(max(a, up));
    __syncwarp();
    if (lane < k) store_pair(L + lane, x);
  } else {
    const unsigned long long b =
        lane + 32 < k ? load_pair(L + lane + 32) : 0ull;
    const unsigned long long y = warp_merge(max(b, up));  // best 32 of b, c
    const unsigned long long yr = __shfl_sync(kFull, y, 31 - lane);
    const unsigned long long hi = warp_merge(max(a, yr));
    const unsigned long long lo = warp_merge(min(a, yr));
    __syncwarp();
    store_pair(L + lane, hi);
    if (lane + 32 < k) store_pair(L + lane + 32, lo);
  }
  __syncwarp();
}

// A bound slot's key if the word is of generation gen, else 0 (no bound).
__device__ __forceinline__ unsigned slot_key(unsigned long long w,
                                             unsigned gen) {
  return (unsigned)(w >> 32) == gen ? (unsigned)w : 0u;
}

// The float a raw score must reach to be a candidate under a threshold
// key h: ties pass, and so does everything while h is at or below the
// NEG_INF key (masking may raise a score below NEG_INF to it).
__device__ __forceinline__ float pass_score(unsigned h) {
  return h > score_key(kNegInf) ? key_score(h) : -INFINITY;
}

// Pass 1. TI items per tile; WI warps split a tile's items (IPT per
// lane), the other kWarps / WI warp groups split the rows (RPT each).
template <int TI, int WI, int IPT, int RPT>
__global__ void __launch_bounds__(kThreads, RPT >= 16 ? 1 : 2)
score_blocks(const float* __restrict__ vecs,
             const float* __restrict__ factors,
             const int* __restrict__ banned, uint2* __restrict__ cand,
             unsigned long long* __restrict__ slots, unsigned gen,
             int bucket, int rank, int rank4, int fstride, int n_rows,
             int n_valid, int width, int k, unsigned id_base, int n_tiles,
             int stages, int vec16) {
  static_assert(WI * IPT * 32 == TI, "a tile is WI warps x IPT x 32 items");
  constexpr int NR = kWarps / WI;  // row groups
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [stages][TI][fstride]
  float* q_s = ring + (size_t)stages * TI * fstride;  // [NR * RPT][rank4]
  // per (warp, row): its list [k] and candidate buffer [kBuf]
  uint2* lists = reinterpret_cast<uint2*>(q_s + NR * RPT * rank4);
  const int area = k + kBuf;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ig = warp % WI, rg = warp / WI;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int share = n_tiles / nb, extra = n_tiles - share * nb;
  const int t0 = blk * share + min(blk, extra);
  const int n_my = share + (blk < extra ? 1 : 0);
  // this list's slot among the row's k bound slots
  const int slot = (blk * WI + ig) % k;

  // padding columns of every stage (never written by the copies); the
  // query rows past the bucket are zeros, so the product needs no branch
  if (rank4 != rank)
    for (int it = tid; it < stages * TI; it += kThreads)
      for (int r = rank; r < rank4; ++r) ring[it * fstride + r] = 0.f;
  for (int b = warp; b < NR * RPT; b += kWarps)
    for (int r = lane; r < rank4; r += 32)
      q_s[b * rank4 + r] =
          b < bucket && r < rank ? vecs[(size_t)b * rank + r] : 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_my)
      issue_tile<TI>(ring + (size_t)s * TI * fstride, factors, t0 + s, rank,
                     rank4, fstride, n_rows, vec16);
    cp_async_commit();
  }

  // The (warp, row) lists start empty: (0, 0) slots, below every real
  // key. Per (warp, row) in registers: pass, the raw score a candidate
  // must reach, and nbuf, the buffer's count. pass rises with the list's
  // k-th key and with the row's bound: every list publishes its best key
  // (atomicMax) into slot (its index mod k) of the row's k slots, so the
  // k slots hold the keys of k distinct items (lists hold disjoint
  // items) and the least slot is at most the row's final k-th key (0,
  // no bound, until every slot is set). A slot word is (gen, key); one
  // of another generation reads as 0. The slots are read from L2 before
  // the product of every 8th tile from the second and used after it:
  // every list of the row reads and updates that line, so a read on
  // every tile costs more than the tighter bound saves.
  for (int e = lane; e < RPT * area; e += 32)
    lists[warp * RPT * area + e] = make_uint2(0u, 0u);
  float pass[RPT];
  int nbuf[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    pass[rr] = -INFINITY;
    nbuf[rr] = 0;
  }
  const unsigned lt_mask = (1u << lane) - 1u;

  const int ibase = ig * 32 * IPT + lane;
  for (int i = 0; i < n_my; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();  // tile i landed; every warp is done with tile i-1
    {
      const int nx = i + stages - 1;
      if (nx < n_my)
        issue_tile<TI>(ring + (size_t)(nx % stages) * TI * fstride, factors,
                       t0 + nx, rank, rank4, fstride, n_rows, vec16);
      cp_async_commit();
    }
    const float* f_s = ring + (size_t)(i % stages) * TI * fstride;
    // the rows' slots, read now, used after the product
    const bool read_slots = (i & 7) == 1;
    unsigned fresh[RPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const unsigned long long* sl = slots + (size_t)(rg + NR * rr) * k;
      fresh[rr] = 0xffffffffu;
      if (read_slots && rg + NR * rr < bucket) {
        if (lane < k) fresh[rr] = slot_key(__ldcg(sl + lane), gen);
        if (lane + 32 < k)
          fresh[rr] = min(fresh[rr], slot_key(__ldcg(sl + lane + 32), gen));
      }
    }

    float acc[RPT][IPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int j = 0; j < IPT; ++j) acc[rr][j] = 0.f;
    for (int r = 0; r < rank4; r += 4) {
      float4 f[IPT];
#pragma unroll
      for (int j = 0; j < IPT; ++j)
        f[j] = *reinterpret_cast<const float4*>(
            f_s + (ibase + 32 * j) * fstride + r);
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const float4 q = *reinterpret_cast<const float4*>(
            q_s + (rg + NR * rr) * rank4 + r);
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
          acc[rr][j] = fmaf(q.x, f[j].x, acc[rr][j]);
          acc[rr][j] = fmaf(q.y, f[j].y, acc[rr][j]);
          acc[rr][j] = fmaf(q.z, f[j].z, acc[rr][j]);
          acc[rr][j] = fmaf(q.w, f[j].w, acc[rr][j]);
        }
      }
    }

    // the lane's item j of this tile is local row tb + 32 j + lane. A
    // raw score that reaches `pass` goes to the list's buffer, flushed
    // when full; the flush masks and ranks exactly. One compare per
    // score and one vote per row when nothing passes, the common case.
    const unsigned tb = (unsigned)(t0 + i) * TI + ig * 32 * IPT;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int b = rg + NR * rr;
      if (b >= bucket) break;
      if (read_slots)
        pass[rr] = fmaxf(pass[rr],
                         pass_score(__reduce_min_sync(kFull, fresh[rr])));
      uint2* L = lists + (warp * RPT + rr) * area;
      // flush the buffer; publish the list's best, take its k-th
      auto flush = [&]() {
        flush_buffer(L, L + k, nbuf[rr], k, n_valid,
                     banned + (size_t)b * width, width, id_base);
        nbuf[rr] = 0;
        if (lane == 0)
          atomicMax(slots + (size_t)b * k + slot, pair(gen, L[0].x));
        pass[rr] = fmaxf(pass[rr], pass_score(L[k - 1].x));
      };
      // The first tile meets an empty list, so every score would pass
      // until the first flush. Flush each lane's best item of the tile
      // first: the list then starts at the k-th best of 32 lane bests,
      // and the lane's other items alone meet that threshold.
      int jb = -1;
      if (i == 0) {
        float sb = acc[rr][0];
        jb = 0;
#pragma unroll
        for (int j = 1; j < IPT; ++j)
          if (acc[rr][j] > sb) { sb = acc[rr][j]; jb = j; }
        store_pair(L + k + lane, pair(score_key(sb), ~(tb + 32 * jb + lane)));
        nbuf[rr] = 32;
        __syncwarp();
        flush();
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < IPT; ++j) any |= acc[rr][j] >= pass[rr] && j != jb;
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int j = 0; j < IPT; ++j) {
        unsigned m = __ballot_sync(kFull, acc[rr][j] >= pass[rr] && j != jb);
        if (m && nbuf[rr] + __popc(m) > kBuf) {
          flush();
          m = __ballot_sync(kFull, acc[rr][j] >= pass[rr] && j != jb);
        }
        if (!m) continue;
        if ((m >> lane) & 1u)
          L[k + nbuf[rr] + __popc(m & lt_mask)] =
              make_uint2(score_key(acc[rr][j]), ~(tb + 32 * j + lane));
        nbuf[rr] += __popc(m);
        __syncwarp();
      }
    }
  }

  // epilogue: flush what is left, then the block's list of each row,
  // from its WI warp lists
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int b = rg + NR * rr;
    if (b < bucket && nbuf[rr] > 0) {
      uint2* L = lists + (warp * RPT + rr) * area;
      flush_buffer(L, L + k, nbuf[rr], k, n_valid,
                   banned + (size_t)b * width, width, id_base);
    }
  }
  __syncthreads();
  for (int b = warp; b < bucket; b += kWarps) {
    const int rgb = b % NR, rrb = b / NR;
    uint2* out = cand + ((size_t)b * nb + blk) * k;
    if (WI == 1) {
      const uint2* L = lists + (rgb * RPT + rrb) * area;
      for (int j = lane; j < k; j += 32) out[j] = L[j];
    } else {
      const uint2* mine = lists + ((rgb * WI + lane) * RPT + rrb) * area;
      int head = 0;
      for (int j = 0; j < k; ++j) {
        const uint2 e = (lane < WI && head < k) ? mine[head]
                                                : make_uint2(0u, 0u);
        unsigned h = e.x, l = e.y;
        warp_best(h, l);
        if (lane == 0) out[j] = make_uint2(h, l);
        if (lane < WI && e.x == h && e.y == l) ++head;
      }
    }
  }
}

// Pass 2: one block per query row, one thread per block list; k rounds
// of a block-wide best head, the owner of the winner advancing its head
// to the entry it loaded ahead. The lists hold >= k real keys in all,
// and real ids are unique, so the winner's ~id names one owner.
__global__ void __launch_bounds__(kMaxBlocks)
merge_blocks(const uint2* __restrict__ cand, float* __restrict__ out_s,
             int* __restrict__ out_i, int k, int nb, unsigned id_base) {
  __shared__ unsigned red_hi[32], red_lo[32];
  __shared__ unsigned win_lo;
  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const uint2* mine = cand + ((size_t)row * nb + tid) * k;
  const uint2 none = make_uint2(0u, 0u);
  int head = 0;
  uint2 e = tid < nb ? mine[0] : none;
  uint2 ahead = tid < nb && k > 1 ? mine[1] : none;
  for (int j = 0; j < k; ++j) {
    unsigned h = e.x, l = e.y;
    warp_best(h, l);
    if (lane == 0) { red_hi[warp] = h; red_lo[warp] = l; }
    __syncthreads();
    if (warp == 0) {
      h = lane < nwarps ? red_hi[lane] : 0u;
      l = lane < nwarps ? red_lo[lane] : 0u;
      warp_best(h, l);
      if (lane == 0) {
        out_s[(size_t)row * k + j] = key_score(h);
        out_i[(size_t)row * k + j] = (int)(~l + id_base);
        win_lo = l;
      }
    }
    __syncthreads();
    if (tid < nb && e.y == win_lo) {
      ++head;
      e = ahead;
      ahead = head + 1 < k ? mine[head + 1] : none;
    }
  }
}

using ScoreFn = void (*)(const float*, const float*, const int*, uint2*,
                         unsigned long long*, unsigned, int, int, int, int,
                         int, int, int, int, unsigned, int, int, int);

struct Config {
  int ti, wi, ipt, rpt;
  ScoreFn fn;
};

// The thread mapping for a bucket (mirrored by the Python wrapper's
// _config): every warp has items at bucket 1, 2 and 4.
Config config_for(int bucket) {
  if (bucket <= 1) return {256, 8, 1, 1, score_blocks<256, 8, 1, 1>};
  if (bucket <= 2) return {256, 4, 2, 1, score_blocks<256, 4, 2, 1>};
  if (bucket <= 4) return {256, 2, 4, 1, score_blocks<256, 2, 4, 1>};
  if (bucket <= 8) return {128, 1, 4, 1, score_blocks<128, 1, 4, 1>};
  if (bucket <= 16) return {128, 1, 4, 2, score_blocks<128, 1, 4, 2>};
  if (bucket <= 32) return {128, 1, 4, 4, score_blocks<128, 1, 4, 4>};
  if (bucket <= 64) return {128, 1, 4, 8, score_blocks<128, 1, 4, 8>};
  return {128, 1, 4, 16, score_blocks<128, 1, 4, 16>};
}

int fstride_for(int rank) {
  const int c4 = (rank + 3) >> 2;
  return 4 * (c4 | 1);  // an odd number of 16-byte chunks per row
}

// ring + queries + (warp, row) lists; the wrapper's _smem_bytes is the
// same formula
size_t smem_bytes(const Config& c, int bucket, int rank, int k, int stages) {
  const int rank4 = (rank + 3) & ~3;
  return sizeof(float) * ((size_t)stages * c.ti * fstride_for(rank) +
                          (size_t)(kWarps / c.wi) * c.rpt * rank4) +
         sizeof(uint2) * (size_t)kWarps * c.rpt * (k + kBuf);
}

struct Plan {
  Config cfg;
  int sms, bps, stages, grid;
  size_t smem;
};

// Stages and blocks per SM per (device, bucket, rank, k): the stage
// count that gives the most stages per SM (ties: more blocks), worked
// out once with the occupancy calculator and kept.
cudaError_t make_plan(int bucket, int rank, int k, int n_rows,
                      int max_blocks, Plan* p) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, Plan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, bucket, rank, k);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
      *p = it->second;
    } else {
      Plan q{};
      q.cfg = config_for(bucket);
      err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(q.cfg.fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kMaxSmem);
      if (err != cudaSuccess) return err;
      int best = 0;
      for (int s = kMaxStages; s >= 2; --s) {
        const size_t smem = smem_bytes(q.cfg, bucket, rank, k, s);
        if (smem > kMaxSmem) continue;
        int bps = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &bps, q.cfg.fn, kThreads, smem);
        if (err != cudaSuccess) return err;
        bps = bps < kMaxBlocksPerSm ? bps : kMaxBlocksPerSm;
        if (bps > 0 && (s * bps > best ||
                        (s * bps == best && bps > q.bps))) {
          best = s * bps;
          q.bps = bps;
          q.stages = s;
          q.smem = smem;
        }
      }
      if (best == 0) return cudaErrorInvalidConfiguration;
      cache.emplace(key, q);
      *p = q;
    }
  }
  const int n_tiles = (n_rows + p->cfg.ti - 1) / p->cfg.ti;
  int grid = p->sms * p->bps;
  grid = grid < n_tiles ? grid : n_tiles;
  grid = grid < max_blocks ? grid : max_blocks;
  p->grid = grid < kMaxBlocks ? grid : kMaxBlocks;
  return cudaSuccess;
}

bool bad_args(int bucket, int rank, int n_rows, int n_valid, int width,
              int k, int id_base, int max_blocks) {
  return bucket < 1 || bucket > kMaxBucket || k < 1 || k > kMaxK ||
         rank < 1 || n_rows < 1 || width < 0 || n_valid < 0 ||
         n_valid > n_rows || id_base < 0 || max_blocks < 1 ||
         (long long)id_base + n_rows > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The largest k / bucket the launcher takes; the wrapper checks them.
int pio_fused_topk_max_k() { return kMaxK; }
int pio_fused_topk_max_bucket() { return kMaxBucket; }

// Pass-1 shared memory for `stages` ring stages (the wrapper's formula).
long long pio_fused_topk_smem_bytes(int bucket, int rank, int k,
                                    int stages) {
  return (long long)smem_bytes(config_for(bucket), bucket, rank, k, stages);
}

// The launch plan on the current device: out = {SM count, blocks per
// SM, stages, grid, shared bytes, items per tile}. Returns an error code.
int pio_fused_topk_plan(int bucket, int rank, int k, int n_rows,
                        int max_blocks, int* out) {
  if (bad_args(bucket, rank, n_rows, 0, 0, k, 0, max_blocks))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(bucket, rank, k, n_rows, max_blocks, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.sms; out[1] = p.bps; out[2] = p.stages; out[3] = p.grid;
  out[4] = (int)p.smem; out[5] = p.cfg.ti;
  return 0;
}

// vecs [bucket, rank] f32, factors [n_rows, rank] f32, banned
// [bucket, width] i32 ids offset by id_base, the bound slots (at least
// bucket * k 8-byte words that persist across calls, zero before the
// first, each call with a generation above every earlier one on them),
// scratch cand of at least bucket * max_blocks * k 8-byte words (the
// blocks' (key, ~id) lists), outputs out_s/out_i [bucket, k]; all
// contiguous on the current device. Enqueues both passes on `stream`
// and returns the first error code.
int pio_fused_topk(const void* vecs, const void* factors, const void* banned,
                   void* slots, void* cand, void* out_s, void* out_i,
                   int bucket, int rank, int n_rows, int n_valid, int width,
                   int k, int id_base, int max_blocks, unsigned gen,
                   void* stream) {
  if (bad_args(bucket, rank, n_rows, n_valid, width, k, id_base,
               max_blocks))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(bucket, rank, k, n_rows, max_blocks, &p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rank4 = (rank + 3) & ~3;
  const int n_tiles = (n_rows + p.cfg.ti - 1) / p.cfg.ti;
  const int vec16 = (rank % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(factors) & 15) == 0);
  uint2* c = static_cast<uint2*>(cand);
  p.cfg.fn<<<p.grid, kThreads, p.smem, st>>>(
      static_cast<const float*>(vecs), static_cast<const float*>(factors),
      static_cast<const int*>(banned), c,
      static_cast<unsigned long long*>(slots), gen, bucket, rank, rank4,
      fstride_for(rank), n_rows, n_valid, width, k, (unsigned)id_base,
      n_tiles, p.stages, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads2 = ((p.grid + 31) / 32) * 32;
  merge_blocks<<<bucket, threads2, 0, st>>>(
      c, static_cast<float*>(out_s), static_cast<int*>(out_i), k, p.grid,
      (unsigned)id_base);
  return (int)cudaGetLastError();
}

const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
