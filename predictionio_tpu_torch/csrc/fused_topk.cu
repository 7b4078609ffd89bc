// Fused serve kernel: scores = vecs @ factors^T, ban/valid masking and
// top-k, without the [bucket, n_items] score matrix ever reaching device
// memory.
//
// Replaces predictionio_tpu/ops/fused_topk.py::_merge_body/_kernel_static
// (the Pallas kernel built by _pallas_topk(n_valid=int)). Semantics are
// the same: the product is exact fp32 (sequential FMA on CUDA cores, no
// TF32, no bf16); ids >= n_valid and each row's banned ids score
// NEG_INF = -1e30 and can still be emitted; the order is (score desc,
// id asc), lax.top_k's lowest-index tie-break, so an all-banned row
// gives ids 0..k-1; a banned id outside the tile range (the n_items
// filler) matches nothing. n_valid is a runtime argument so the sharded
// form (_kernel_dynamic) needs only a call site, not a second kernel.
//
// Design. The TPU kernel walks item tiles in order on one core and
// carries a scoreboard between grid steps; Hopper blocks run in
// parallel and in no order, so the work is split in two launches:
//   pass 1 (score_tiles): one block per 128-item tile stages the tile's
//     factors (row stride rank4+1, so lanes hit distinct banks), the
//     bucket's query rows and a [bucket, 128] ban flag array in shared
//     memory. Each row walks its W banned ids once per block and flags
//     those inside the tile, instead of comparing every item with every
//     banned id. Warp w owns rows w, w+8, ...; lane l scores items
//     l, l+32, l+64, l+96 of the tile with a sequential FMA loop over
//     rank (any rank; zero padded to a multiple of 4). Every id of the
//     tile is a candidate, ids past n_valid (the catalog's ragged end
//     included) at NEG_INF, so a tile always holds 128 >= k candidates.
//     k rounds of a warp argmax (two __reduce_max_sync on an orderable
//     (score, ~id) key) write the tile's top-k, best first, to
//     scratch [bucket, k, n_tiles].
//   pass 2 (merge_tiles): one block per query row merges the n_tiles
//     sorted candidate lists by their heads: each round takes the best
//     head under the same key and advances that tile's pointer, so a
//     round re-reads one tile's list, not all n_tiles * k candidates.
//
// Bound on this card. Per call the kernel must read the factor matrix
// once (n_items * rank * 4 B) and do 2 * bucket * n_items * rank fp32
// operations on CUDA cores: max(bytes / HBM rate, flops / fp32 rate).
// At 500,000 x 64 that is 128 MB and, at bucket 64, 4.1 GFLOP. On an
// H100 SXM (NVIDIA data sheet: 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores, at the 700 W limit) bucket 64 is compute-bound at about
// 61 us and bucket 1 memory-bound at about 38 us. The card measured so
// far, "NVIDIA H100 80GB HBM3" (the SXM part) at a 700 W power limit,
// has exactly those rates, so those bounds hold for it. chip_smoke.py
// recomputes the bound for the card nvidia-smi names and prints it with
// the card's power limit beside the measured time; PERF.md keeps them.
//
// This first version is simple and exact, not fast. Later work: the
// product as a 3xTF32 split on wgmma (exact enough for fp32 ranking), a
// TMA ring of factor tiles with persistent blocks, and a running top-k
// per block with a threshold skip so most tiles emit no candidates.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 128;            // items per pass-1 block
constexpr int kThreads1 = 256;        // pass-1 block: 8 warps
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kPerLane = kTile / 32;  // items per lane
constexpr int kThreads2 = 512;        // pass-2 block
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kMaxK = 64;
constexpr int kMaxBucket = 128;
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

// (hi, lo) = (score key, ~id): the warp's best pair under (score desc,
// id asc), returned to every lane.
__device__ __forceinline__ void warp_best(unsigned& hi, unsigned& lo) {
  unsigned m = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, hi == m ? lo : 0u);
  hi = m;
}

__device__ __forceinline__ bool better(unsigned ah, unsigned al,
                                       unsigned bh, unsigned bl) {
  return ah > bh || (ah == bh && al > bl);
}

__device__ __forceinline__ void order_pair(unsigned& ah, unsigned& al,
                                           unsigned& bh, unsigned& bl) {
  if (better(bh, bl, ah, al)) {
    unsigned th = ah, tl = al;
    ah = bh; al = bl; bh = th; bl = tl;
  }
}

template <int RPT>  // query rows per warp: ceil(bucket / 8)
__global__ void __launch_bounds__(kThreads1)
score_tiles(const float* __restrict__ vecs, const float* __restrict__ factors,
            const int* __restrict__ banned, float* __restrict__ cand_s,
            int* __restrict__ cand_i, int bucket, int rank, int rank4,
            int n_rows, int n_valid, int width, int k, int n_tiles) {
  extern __shared__ float4 smem4[];
  const int fstride = rank4 + 1;
  float* f_s = reinterpret_cast<float*>(smem4);      // [kTile][fstride]
  float* q_s = f_s + kTile * fstride;                 // [bucket][rank4]
  unsigned char* ban_s =
      reinterpret_cast<unsigned char*>(q_s + bucket * rank4);  // [bucket][kTile]

  const int tile = blockIdx.x;
  const int base = tile * kTile;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTile * rank4; e += kThreads1) {
    const int it = e / rank4, r = e - it * rank4;
    const int gid = base + it;
    float v = 0.f;
    if (gid < n_rows && r < rank) v = factors[(size_t)gid * rank + r];
    f_s[it * fstride + r] = v;
  }
  for (int e = tid; e < bucket * rank4; e += kThreads1) {
    const int b = e / rank4, r = e - b * rank4;
    q_s[e] = r < rank ? vecs[(size_t)b * rank + r] : 0.f;
  }
  for (int e = tid; e < bucket * kTile; e += kThreads1) ban_s[e] = 0;
  __syncthreads();
  for (int e = tid; e < bucket * width; e += kThreads1) {
    const unsigned off = (unsigned)banned[e] - (unsigned)base;
    if (off < (unsigned)kTile) ban_s[(e / width) * kTile + off] = 1;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  float acc[RPT][kPerLane];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[rr][j] = 0.f;

  for (int r = 0; r < rank4; r += 4) {
    float f[kPerLane][4];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[j][c] = f_s[(lane + 32 * j) * fstride + r + c];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int b = warp + kWarps1 * rr;
      if (b < bucket) {
        const float4 q = *reinterpret_cast<const float4*>(q_s + b * rank4 + r);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          acc[rr][j] = fmaf(q.x, f[j][0], acc[rr][j]);
          acc[rr][j] = fmaf(q.y, f[j][1], acc[rr][j]);
          acc[rr][j] = fmaf(q.z, f[j][2], acc[rr][j]);
          acc[rr][j] = fmaf(q.w, f[j][3], acc[rr][j]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int b = warp + kWarps1 * rr;
    if (b >= bucket) break;
    unsigned hi[kPerLane], lo[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int it = lane + 32 * j;
      const int gid = base + it;
      const bool masked = gid >= n_valid || ban_s[b * kTile + it];
      hi[j] = score_key(masked ? kNegInf : acc[rr][j]);
      lo[j] = ~(unsigned)gid;
    }
    // sort the lane's four candidates best first
    order_pair(hi[0], lo[0], hi[1], lo[1]);
    order_pair(hi[2], lo[2], hi[3], lo[3]);
    order_pair(hi[0], lo[0], hi[2], lo[2]);
    order_pair(hi[1], lo[1], hi[3], lo[3]);
    order_pair(hi[1], lo[1], hi[2], lo[2]);
    for (int t = 0; t < k; ++t) {
      unsigned wh = hi[0], wl = lo[0];
      warp_best(wh, wl);
      if (lane == 0) {
        const size_t o = ((size_t)b * k + t) * n_tiles + tile;
        cand_s[o] = key_score(wh);
        cand_i[o] = (int)~wl;
      }
      if (lo[0] == wl) {  // ids are unique: this lane held the winner
        hi[0] = hi[1]; lo[0] = lo[1];
        hi[1] = hi[2]; lo[1] = lo[2];
        hi[2] = hi[3]; lo[2] = lo[3];
        hi[3] = 0u;    lo[3] = 0u;  // below every real key
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads2)
merge_tiles(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
            float* __restrict__ out_s, int* __restrict__ out_i, int k,
            int n_tiles) {
  extern __shared__ unsigned char head_s[];  // [n_tiles] next unread rank
  __shared__ unsigned red_hi[kWarps2], red_lo[kWarps2];
  __shared__ unsigned win_lo;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* cs = cand_s + (size_t)row * k * n_tiles;
  const int* ci = cand_i + (size_t)row * k * n_tiles;

  // each thread owns tiles tid, tid + kThreads2, ...; only it touches
  // their heads, so the heads need no barrier
  for (int t = tid; t < n_tiles; t += kThreads2) head_s[t] = 0;

  unsigned bh = 0u, bl = 0u;
  auto rescan = [&]() {
    bh = 0u; bl = 0u;
#pragma unroll 8
    for (int t = tid; t < n_tiles; t += kThreads2) {
      const int p = head_s[t];
      if (p < k) {
        const size_t o = (size_t)p * n_tiles + t;
        const unsigned h = score_key(cs[o]), l = ~(unsigned)ci[o];
        if (better(h, l, bh, bl)) { bh = h; bl = l; }
      }
    }
  };
  rescan();

  for (int j = 0; j < k; ++j) {
    unsigned h = bh, l = bl;
    warp_best(h, l);
    if (lane == 0) { red_hi[warp] = h; red_lo[warp] = l; }
    __syncthreads();
    if (warp == 0) {
      h = lane < kWarps2 ? red_hi[lane] : 0u;
      l = lane < kWarps2 ? red_lo[lane] : 0u;
      warp_best(h, l);
      if (lane == 0) {
        out_s[(size_t)row * k + j] = key_score(h);
        out_i[(size_t)row * k + j] = (int)~l;
        win_lo = l;
      }
    }
    __syncthreads();
    const int tile = (int)(~win_lo) / kTile;
    if (tile % kThreads2 == tid) {
      ++head_s[tile];
      rescan();
    }
  }
}

template <int RPT>
cudaError_t launch_score(const float* vecs, const float* factors,
                         const int* banned, float* cand_s, int* cand_i,
                         int bucket, int rank, int rank4, int n_rows,
                         int n_valid, int width, int k, int n_tiles,
                         size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        score_tiles<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  score_tiles<RPT><<<n_tiles, kThreads1, smem, stream>>>(
      vecs, factors, banned, cand_s, cand_i, bucket, rank, rank4, n_rows,
      n_valid, width, k, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Items per pass-1 tile and the largest k / bucket the launcher takes;
// the Python wrapper sizes its scratch from these.
int pio_fused_topk_tile() { return kTile; }
int pio_fused_topk_max_k() { return kMaxK; }
int pio_fused_topk_max_bucket() { return kMaxBucket; }

// vecs [bucket, rank] f32, factors [n_rows, rank] f32, banned
// [bucket, width] i32, scratch cand_s/cand_i [bucket, k, n_tiles],
// outputs out_s/out_i [bucket, k]; all contiguous on the current device.
// Enqueues both passes on `stream` and returns the launches' error code.
int pio_fused_topk(const void* vecs, const void* factors, const void* banned,
                   void* cand_s, void* cand_i, void* out_s, void* out_i,
                   int bucket, int rank, int n_rows, int n_valid, int width,
                   int k, void* stream) {
  if (bucket < 1 || bucket > kMaxBucket || k < 1 || k > kMaxK ||
      rank < 1 || n_rows < 1 || width < 0 || n_valid < 0 ||
      n_valid > n_rows)
    return (int)cudaErrorInvalidValue;
  const int rank4 = (rank + 3) & ~3;
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  const size_t smem1 = sizeof(float) * ((size_t)kTile * (rank4 + 1) +
                                        (size_t)bucket * rank4) +
                       (size_t)bucket * kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vecs);
  const float* f = static_cast<const float*>(factors);
  const int* bn = static_cast<const int*>(banned);
  float* cs = static_cast<float*>(cand_s);
  int* cix = static_cast<int*>(cand_i);
  const int rpt = (bucket + kWarps1 - 1) / kWarps1;
  cudaError_t err;
  if (rpt <= 1)
    err = launch_score<1>(v, f, bn, cs, cix, bucket, rank, rank4, n_rows,
                          n_valid, width, k, n_tiles, smem1, st);
  else if (rpt <= 2)
    err = launch_score<2>(v, f, bn, cs, cix, bucket, rank, rank4, n_rows,
                          n_valid, width, k, n_tiles, smem1, st);
  else if (rpt <= 4)
    err = launch_score<4>(v, f, bn, cs, cix, bucket, rank, rank4, n_rows,
                          n_valid, width, k, n_tiles, smem1, st);
  else if (rpt <= 8)
    err = launch_score<8>(v, f, bn, cs, cix, bucket, rank, rank4, n_rows,
                          n_valid, width, k, n_tiles, smem1, st);
  else
    err = launch_score<16>(v, f, bn, cs, cix, bucket, rank, rank4, n_rows,
                           n_valid, width, k, n_tiles, smem1, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = (size_t)n_tiles;
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  merge_tiles<<<bucket, kThreads2, smem2, st>>>(
      cs, cix, static_cast<float*>(out_s), static_cast<int*>(out_i), k,
      n_tiles);
  return (int)cudaGetLastError();
}

const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
