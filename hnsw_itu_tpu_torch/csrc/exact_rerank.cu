// Exact rerank of the mini route's final beam in one launch: the beam's
// full-sketch Hamming distances, their (d, id) order, and either its top-k
// (rerank_exact) or the top-k of its union with the full adjacency rows of
// its `seeds` best (rerank_onehop). One warp serves one query; nothing but
// the answer is written to device memory.
//
// Replaces no TPU kernel: the JAX package's rerank_exact and rerank_onehop
// (hnsw_itu_tpu/ops/pallas_dma_search.py) are XLA code, and the port's
// plain versions (hnsw_itu_tpu_torch/ops/mini_search.py
// rerank_exact_plain, rerank_onehop_plain) gather every candidate's row
// into a [B, H + seeds W, words] temporary, popcount it in a dozen
// elementwise passes, and sort [B, H + seeds W] pairs four times. Contract:
// bit-exact with those plain versions. Keys are int64 d << 32 | id; an id
// < 0 or >= cap is invalid and becomes key_inf = (DINF, IINF). The beam is
// sorted stably with its repeats (rerank_exact without dedup keeps them;
// the one-hop seeds are its first `seeds` keys, repeats included). A
// repeated id always carries the same exact distance, so it repeats a
// whole key: dropping repeated ids (dedup, and the one-hop union) is
// keeping the distinct keys, and key_inf pads the answer to its width.
//
// Per query (warp-synchronous, no block barrier):
//  1. the H beam ids, then their rows: a row is read by L lanes, 16 bytes
//     each (L = 8 for 32- and 64-word sketches, a 128-byte line per load
//     instruction), 4 KB of rows in flight per warp (32 rows of 32
//     words); popcount of the XOR with the query (held in registers), a
//     shuffle sum over the L lanes;
//  2. the beam keys sorted by rank: each lane counts the keys below its
//     own (ties by position), H <= 128 broadcast reads of shared memory;
//  3. rerank_exact: the first k sorted keys, or with dedup the first k
//     distinct ones (a ballot and a prefix popcount), out;
//  4. one hop: the running top (the first Kr distinct beam keys, Kr = the
//     answer's width, key_inf past them; in shared memory, two buffers)
//     takes the seeds' adjacency entries in tiles of 128 (lane-contiguous
//     reads of each 4 W byte row), their distances as in 1; a tile's keys
//     below the running top's worst are compacted, those equal to a key it
//     holds or to an earlier one of the tile dropped, and the rest merged
//     in by rank (#(top < c) by binary search, #(new < c) by counting).
//
// What bounds it on an H100: the random 128-byte rows of a points table
// far larger than the 50 MB L2 (1.3 GB at 10M), one per candidate. At
// 8192 queries, H = 96, 8 seeds of W = 64 on 32 words that is 80.5 KB a
// query, 0.66 GB a call, 0.197 ms at 3.35 TB/s. The reads form a
// dependent chain (ids, beam rows, sort, adjacency, hop rows), so the
// design keeps many independent row reads in flight per warp (each lane
// holds 8 reads of 16 bytes before the first use) and many warps per SM
// (48-56 registers, 14 KB of static shared memory a block of 4), and
// keeps the queries in the order the caller sorted them by entry, so
// neighbouring warps share neighbourhoods in L2. No tensor cores (no
// products) and no TMA (rows chosen by the data, not tiles).

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_common.cuh"

namespace {

using beam::count_below;
using beam::kFull;
using beam::key_id;
using beam::kKeyInf;
using beam::lanemask_lt;

constexpr int kWarps = 4;     // queries per block
constexpr int kMaxH = 128;    // beam width, at most
constexpr int kTile = 128;    // one-hop candidates a tile
constexpr int kMaxTop = 2048; // the one-hop answer's width, at most

// How a warp reads rows of WORDS words (0: any width, 4-byte loads).
template <int WORDS>
struct Rows {
  static constexpr int kVec = WORDS / 4;                   // 16-byte parts
  static constexpr int kLanes = WORDS == 0 ? 8 : (kVec < 8 ? kVec : 8);
  static constexpr int kPer = WORDS == 0 ? 1 : kVec / kLanes;  // per lane
  static constexpr int kAtOnce = 32 / kLanes;              // rows a load
  static constexpr int kUnroll = WORDS == 0 ? 8 : 8 / kPer;
  static constexpr int kBatch = kAtOnce * kUnroll;         // rows in flight
};

// keys[i] = exact key of ids[i] (i < n), both in shared memory.
template <int WORDS>
__device__ __forceinline__ void exact_keys(
    const int* ids, int n, long long* keys, const int* __restrict__ points,
    int cap, int words, const int* __restrict__ query,
    const uint4 (&q)[Rows<WORDS>::kPer], int lane) {
  using R = Rows<WORDS>;
  const int grp = lane / R::kLanes;
  const int sub = lane % R::kLanes;
  for (int base = 0; base < n; base += R::kBatch) {
    int id[R::kUnroll];
    uint4 v[R::kUnroll][R::kPer];
#pragma unroll
    for (int u = 0; u < R::kUnroll; ++u) {
      const int i = base + u * R::kAtOnce + grp;
      const int x = i < n ? ids[i] : -1;
      id[u] = x >= 0 && x < cap ? x : -1;
      if constexpr (WORDS > 0) {
        const uint4* row = reinterpret_cast<const uint4*>(points) +
                           (size_t)(id[u] < 0 ? 0 : id[u]) * R::kVec + sub;
#pragma unroll
        for (int c = 0; c < R::kPer; ++c)
          v[u][c] = id[u] >= 0 ? __ldg(row + R::kLanes * c)
                               : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < R::kUnroll; ++u) {
      int s = 0;
      if constexpr (WORDS > 0) {
#pragma unroll
        for (int c = 0; c < R::kPer; ++c)
          s += __popc(v[u][c].x ^ q[c].x) + __popc(v[u][c].y ^ q[c].y) +
               __popc(v[u][c].z ^ q[c].z) + __popc(v[u][c].w ^ q[c].w);
      } else if (id[u] >= 0) {
        const int* row = points + (size_t)id[u] * words;
        for (int t = sub; t < words; t += R::kLanes)
          s += __popc(__ldg(row + t) ^ __ldg(query + t));
      }
#pragma unroll
      for (int o = R::kLanes / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(kFull, s, o);
      const int i = base + u * R::kAtOnce + grp;
      if (sub == 0 && i < n)
        keys[i] = id[u] >= 0
                      ? (static_cast<long long>(s) << 32) | (unsigned)id[u]
                      : kKeyInf;
    }
  }
}

// The distinct keys below key_inf of the ascending a[0, n), in order, into
// dst[0, lim); returns how many there are (may pass lim).
__device__ __forceinline__ int distinct_into(const long long* a, int n,
                                             long long* dst, int lim,
                                             int lane) {
  int m = 0;
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int p = p0 + lane;
    const long long x = p < n ? a[p] : kKeyInf;
    const bool keep = x != kKeyInf && (p == 0 || a[p - 1] != x);
    const unsigned b = __ballot_sync(kFull, keep);
    const int at = m + __popc(b & lanemask_lt());
    if (keep && at < lim) dst[at] = x;
    m += __popc(b);
  }
  return m;
}

// #(a[j] < x) over the unordered a[0, n).
__device__ __forceinline__ int count_less(const long long* a, int n,
                                          long long x) {
  int r = 0;
  for (int j = 0; j < n; ++j) r += a[j] < x;
  return r;
}

template <int WORDS>
__global__ void __launch_bounds__(kWarps * 32)
exact_rerank_kernel(const int* __restrict__ points, int cap, int words,
                    const int* __restrict__ queries,
                    const int* __restrict__ cand, int B, int H,
                    const int* __restrict__ adj, int W, int seeds, int dedup,
                    int kout, int* __restrict__ out_d,
                    int* __restrict__ out_i) {
  using R = Rows<WORDS>;
  __shared__ long long s_key[kWarps][kMaxH];   // beam keys, then a tile's
  __shared__ long long s_sort[kWarps][kMaxH];  // the beam, sorted
  __shared__ long long s_new[kWarps][kTile];   // a tile's entering keys
  __shared__ int s_ids[kWarps][kMaxH];         // ids of the rows to read
  extern __shared__ long long s_top[];         // one hop: 2 kout a warp

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform

  long long* key = s_key[warp];
  long long* srt = s_sort[warp];
  long long* fresh = s_new[warp];
  int* ids = s_ids[warp];
  const int* query = queries + (size_t)b * words;
  uint4 q[R::kPer];
  if constexpr (WORDS > 0) {
#pragma unroll
    for (int c = 0; c < R::kPer; ++c)
      q[c] = __ldg(reinterpret_cast<const uint4*>(query) +
                   lane % R::kLanes + R::kLanes * c);
  }

  // 1. the beam's keys
  for (int i = lane; i < H; i += 32) ids[i] = cand[(size_t)b * H + i];
  __syncwarp();
  exact_keys<WORDS>(ids, H, key, points, cap, words, query, q, lane);
  __syncwarp();
  // 2. stable sort by rank
  for (int i = lane; i < H; i += 32) {
    const long long x = key[i];
    int r = 0;
    for (int j = 0; j < H; ++j) {
      const long long y = key[j];
      r += y < x || (y == x && j < i);
    }
    srt[r] = x;
  }
  __syncwarp();

  const long long* ans = srt;
  if (seeds == 0) {
    // 3. rerank_exact; kout <= H, and key[] is free again
    if (dedup) {
      const int m = distinct_into(srt, H, key, kout, lane);
      for (int i = m + lane; i < kout; i += 32) key[i] = kKeyInf;
      __syncwarp();
      ans = key;
    }
  } else {
    // 4. one hop
    long long* top = s_top + (size_t)warp * 2 * kout;
    long long* next = top + kout;
    const int m = distinct_into(srt, H, top, kout, lane);
    for (int i = m + lane; i < kout; i += 32) top[i] = kKeyInf;
    __syncwarp();
    const int P = seeds * W;
    for (int t0 = 0; t0 < P; t0 += kTile) {
      const int n = min(kTile, P - t0);
      for (int c = lane; c < n; c += 32) {
        const int s = (t0 + c) / W;
        const long long sk = srt[s];
        ids[c] = sk == kKeyInf
                     ? -1
                     : __ldg(adj + (size_t)key_id(sk) * W + (t0 + c - s * W));
      }
      __syncwarp();
      exact_keys<WORDS>(ids, n, key, points, cap, words, query, q, lane);
      __syncwarp();
      // the tile's keys below the top's worst, compacted
      const long long worst = top[kout - 1];
      int F = 0;
      for (int p0 = 0; p0 < n; p0 += 32) {
        const int p = p0 + lane;
        const bool in = p < n && key[p] < worst;
        const unsigned bal = __ballot_sync(kFull, in);
        if (in) fresh[F + __popc(bal & lanemask_lt())] = key[p];
        F += __popc(bal);
      }
      __syncwarp();
      if (F == 0) continue;
      // drop those the top holds and repeats within the tile
      long long x[kTile / 32];
      bool keep[kTile / 32];
#pragma unroll
      for (int t = 0; t < kTile / 32; ++t) {
        const int p = 32 * t + lane;
        keep[t] = p < F;
        x[t] = kKeyInf;
        if (keep[t]) {
          x[t] = fresh[p];
          for (int j = 0; j < p && keep[t]; ++j) keep[t] = fresh[j] != x[t];
          if (keep[t]) {
            const int c = count_below(top, kout, x[t]);
            keep[t] = !(c < kout && top[c] == x[t]);
          }
        }
      }
      __syncwarp();
      int M = 0;
#pragma unroll
      for (int t = 0; t < kTile / 32; ++t) {
        const unsigned bal = __ballot_sync(kFull, keep[t]);
        if (keep[t]) fresh[M + __popc(bal & lanemask_lt())] = x[t];
        M += __popc(bal);
      }
      __syncwarp();
      if (M == 0) continue;
      // merge by rank: the keys are distinct (key_inf copies apart), so the
      // positions are a permutation of [0, kout + M)
      for (int i = lane; i < kout; i += 32) {
        const long long y = top[i];
        const int p = i + count_less(fresh, M, y);
        if (p < kout) next[p] = y;
      }
      for (int c = lane; c < M; c += 32) {
        const long long y = fresh[c];
        const int p = count_below(top, kout, y) + count_less(fresh, M, y);
        if (p < kout) next[p] = y;
      }
      __syncwarp();
      long long* const was = top;
      top = next;
      next = was;
    }
    ans = top;
  }

  for (int i = lane; i < kout; i += 32) {
    const long long k = ans[i];
    out_d[(size_t)b * kout + i] = static_cast<int>(k >> 32);
    out_i[(size_t)b * kout + i] = key_id(k);
  }
}

template <int WORDS>
int launch(const int* points, int cap, int words, const int* queries,
           const int* cand, int B, int H, const int* adj, int W, int seeds,
           int dedup, int kout, int* out_d, int* out_i,
           cudaStream_t stream) {
  const auto kernel = exact_rerank_kernel<WORDS>;
  const int smem = seeds ? kWarps * 2 * kout * 8 : 0;
  if (smem > 32 * 1024) {  // past the 48 KB default with the static 14 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      points, cap, words, queries, cand, B, H, adj, W, seeds, dedup, kout,
      out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// points int32[cap, words], queries int32[B, words], cand int32[B, H], adj
// int32[>= cap, W] (read only when seeds > 0), out_d and out_i
// int32[B, kout]; all contiguous. seeds <= H (0: rerank_exact, dedup
// 0 or 1); kout = min(k, H + seeds W) with seeds, min(k, H) without.
int hnsw_exact_rerank(const void* points, int cap, int words,
                      const void* queries, const void* cand, int B, int H,
                      const void* adj, int W, int seeds, int dedup, int kout,
                      void* out_d, void* out_i, void* stream) {
  if (B <= 0 || cap <= 0 || words <= 0 || H <= 0 || H > kMaxH ||
      seeds < 0 || seeds > H || (seeds > 0 && (W < 0 || !adj)) ||
      kout <= 0 || kout > (seeds ? kMaxTop : H))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto p = static_cast<const int*>(points);
  const auto qs = static_cast<const int*>(queries);
  const auto c = static_cast<const int*>(cand);
  const auto a = static_cast<const int*>(adj);
  const auto d = static_cast<int*>(out_d);
  const auto i = static_cast<int*>(out_i);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  switch (vec ? words : 0) {
    case 8: return launch<8>(p, cap, words, qs, c, B, H, a, W, seeds, dedup,
                             kout, d, i, s);
    case 16: return launch<16>(p, cap, words, qs, c, B, H, a, W, seeds,
                               dedup, kout, d, i, s);
    case 32: return launch<32>(p, cap, words, qs, c, B, H, a, W, seeds,
                               dedup, kout, d, i, s);
    case 64: return launch<64>(p, cap, words, qs, c, B, H, a, W, seeds,
                               dedup, kout, d, i, s);
    default: return launch<0>(p, cap, words, qs, c, B, H, a, W, seeds,
                              dedup, kout, d, i, s);
  }
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
