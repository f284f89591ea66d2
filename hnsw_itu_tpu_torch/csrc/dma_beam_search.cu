// Exact beam search over an adjacency array and a point array: one warp
// runs one query's whole search, from its seed keys to termination, in one
// launch. The build's searches (ef = ef_construction, and the ef = 1
// descent) run here.
//
// Replaces hnsw_itu_tpu/ops/pallas_dma_search.py::_make_kernel (reached by
// dma_beam_search): per step, read the expanded node's adjacency row, drop
// candidates already in the beam, then fetch one point per fresh neighbor
// and merge. The TPU kernel's packed 128-lane tables (pack_adj,
// pack_points) are not carried over: this kernel reads adj int32[cap, W]
// and points int32[cap_pts, words] as they are, through an optional
// node_map (graph-local id -> point row; the upper HNSW levels use it).
// Contract: bit-exact with the XLA two-key beam search
// (hnsw_itu_tpu/ops/search.py::beam_search, expand=1, dedup="beam") and
// with its plain PyTorch port, hnsw_itu_tpu_torch/ops/search.py::
// beam_search_gather: the same keys, visited counts and step counts. Like
// the XLA merge, and unlike the Pallas kernel, a neighbor repeated within
// one row is a duplicate (ROADMAP §3).
//
// What bounds it on an H100: latency, not bandwidth. An expansion is two
// (three with node_map) dependent round trips to device memory: the row's
// W ids (256 B at W = 64), then one 128 B point per fresh neighbor, each
// anywhere in a point array far larger than the 50 MB L2. The design
// dedups before fetching (a duplicate costs no point read), keeps each
// lane's point loads independent (a lane owns neighbors lane, lane+32,
// ...; 16-byte loads, the whole point's loads issued together when words
// is a multiple of 4), and keeps the beam, candidates and query in shared
// memory, so nothing but rows, points, seeds and the final keys touches
// device memory. The beam, rank merge and termination are those of
// mini_beam_search.cu.
//
// Keys: int64 d << 32 | id (both fields >= 0); key_inf = DINF << 32 | IINF
// marks an empty slot. Beam keys are unique except key_inf.
//
// Per step, for one query (warp-synchronous, no block barrier):
//  1. frontier: the first beam slot that is unexpanded, < key_inf and
//     <= beam[ef-1] (the beam is sorted, so this is the best unexpanded
//     key); none -> the query is done;
//  2. each lane reads neighbor ids j = lane, lane+32, ... of the expanded
//     node;
//  3. a neighbor that is absent (< 0), in the beam, or repeats an earlier
//     neighbor of the row is a duplicate; the rest are fresh and count in
//     visited;
//  4. each fresh neighbor's point (through node_map when given): XOR +
//     __popc with the query -> its key;
//  5. rank merge: beam key i moves to i + #(fresh < key), fresh key c to
//     #(beam < c) + #(fresh < c); positions >= ef fall out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;
constexpr int kSlots = kMaxW / 32;  // neighbors per lane at most
constexpr int kMaxWords = 64;
constexpr int kWarps = 4;           // queries per block
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kKeyInf = (0x7FFF0000LL << 32) | 0x7FFFFFFFLL;

__device__ __forceinline__ int key_id(long long k) {
  return static_cast<int>(k & 0xffffffffLL);
}

// Hamming distance of the point at `p` to the query `q` (shared memory).
// W4 > 0: words = 4 * W4, 16-byte loads, all issued before the first use;
// W4 = 0: the run-time width, one 4-byte load per word.
template <int W4>
__device__ __forceinline__ int point_distance(const int* __restrict__ p,
                                              const int* q, int words) {
  if constexpr (W4 > 0) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
    const int4* q4 = reinterpret_cast<const int4*>(q);
    int4 v[W4];
#pragma unroll
    for (int c = 0; c < W4; ++c) v[c] = __ldg(p4 + c);
    int s = 0;
#pragma unroll
    for (int c = 0; c < W4; ++c) {
      const int4 w = q4[c];
      s += __popc(v[c].x ^ w.x) + __popc(v[c].y ^ w.y) +
           __popc(v[c].z ^ w.z) + __popc(v[c].w ^ w.w);
    }
    return s;
  } else {
    int s = 0;
    for (int t = 0; t < words; ++t) s += __popc(__ldg(p + t) ^ q[t]);
    return s;
  }
}

template <int CAP, int W4>
__global__ void __launch_bounds__(kWarps * 32)
dma_beam_search_kernel(const int* __restrict__ queries, int words,
                       const long long* __restrict__ init_keys, int E,
                       const int* __restrict__ adj, int cap, int W,
                       const int* __restrict__ points, int n_pts,
                       const int* __restrict__ node_map,
                       long long* __restrict__ out_keys,
                       int* __restrict__ out_visited,
                       int* __restrict__ out_steps, int B, int ef,
                       int max_steps) {
  __shared__ long long s_bk[kWarps][CAP];    // beam keys, ascending
  __shared__ long long s_nk[kWarps][CAP];    // merged beam keys
  __shared__ long long s_ck[kWarps][kMaxW];  // candidate keys
  __shared__ int s_bf[kWarps][CAP];          // expanded flags
  __shared__ int s_nf[kWarps][CAP];          // merged flags
  __shared__ int s_id[kWarps][kMaxW];        // the expanded row's ids
  __shared__ __align__(16) int s_q[kWarps][kMaxWords];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  long long* bk = s_bk[warp];
  long long* nk = s_nk[warp];
  long long* ck = s_ck[warp];
  int* bf = s_bf[warp];
  int* nf = s_nf[warp];
  int* rid = s_id[warp];
  const int* q = s_q[warp];

  for (int t = lane; t < words; t += 32)
    s_q[warp][t] = queries[(size_t)b * words + t];
  int seeds = 0;  // valid seeds: the visited count starts there
  for (int i = lane; i < ef; i += 32) {
    const long long k = i < E ? init_keys[(size_t)b * E + i] : kKeyInf;
    bk[i] = k;
    bf[i] = 0;
    seeds += i < E && key_id(k) != 0x7FFFFFFF;
  }
  int visited = __reduce_add_sync(kFull, seeds);
  __syncwarp();

  int steps = 0;
  while (steps < max_steps) {
    // 1. frontier
    const long long worst = bk[ef - 1];
    int pos = -1;
    for (int base = 0; base < ef; base += 32) {
      const int i = base + lane;
      const bool open = i < ef && !bf[i] && bk[i] < kKeyInf && bk[i] <= worst;
      const unsigned m = __ballot_sync(kFull, open);
      if (m) {
        pos = base + __ffs(m) - 1;
        break;
      }
    }
    if (pos < 0) break;
    ++steps;
    const int e = min(max(key_id(bk[pos]), 0), cap - 1);
    __syncwarp();
    if (lane == 0) bf[pos] = 1;

    // 2. the row's ids
    const int* row = adj + (size_t)e * W;
    int nid[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      nid[s] = j < W ? __ldg(row + j) : -1;
      if (j < W) rid[j] = nid[s];
    }
    __syncwarp();

    // 3. dedup against the beam and against earlier ids of the row
    int fresh_total = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      bool fresh = j < W && nid[s] >= 0;
      for (int i = 0; fresh && i < ef; ++i) fresh = key_id(bk[i]) != nid[s];
      for (int i = 0; fresh && i < j; ++i) fresh = rid[i] != nid[s];
      if (!fresh) nid[s] = -1;
      fresh_total += __popc(__ballot_sync(kFull, fresh));
    }
    __syncwarp();
    if (fresh_total == 0) continue;
    visited += fresh_total;

    // 4. one point per fresh neighbor -> candidate keys
    long long key[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      key[s] = kKeyInf;
      if (nid[s] >= 0) {
        const int g = min(nid[s], cap - 1);
        int r = node_map ? __ldg(node_map + g) : g;
        r = min(max(r, 0), n_pts - 1);
        const int d = point_distance<W4>(points + (size_t)r * words, q, words);
        key[s] = (static_cast<long long>(d) << 32) | nid[s];
      }
      if (j < W) ck[j] = key[s];
    }
    __syncwarp();

    // 5. rank merge into nk/nf, then copy back
    for (int i = lane; i < ef; i += 32) {
      const long long k = bk[i];
      int p = i;
      for (int j = 0; j < W; ++j) p += ck[j] < k;
      if (p < ef) {
        nk[p] = k;
        nf[p] = bf[i];
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const long long c = key[s];
      if (c < kKeyInf) {
        int p = 0;
        for (int i = 0; i < ef; ++i) p += bk[i] < c;
        for (int j = 0; j < W; ++j) p += ck[j] < c;
        if (p < ef) {
          nk[p] = c;
          nf[p] = 0;
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < ef; i += 32) {
      bk[i] = nk[i];
      bf[i] = nf[i];
    }
    __syncwarp();
  }

  for (int i = lane; i < ef; i += 32) out_keys[(size_t)b * ef + i] = bk[i];
  if (lane == 0) {
    out_visited[b] = visited;
    out_steps[b] = steps;
  }
}

struct Args {
  const int* queries;
  int words;
  const long long* init_keys;
  int E;
  const int* adj;
  int cap, W;
  const int* points;
  int n_pts;
  const int* node_map;
  long long* out_keys;
  int* out_visited;
  int* out_steps;
  int B, ef, max_steps;
};

template <int CAP, int W4>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  dma_beam_search_kernel<CAP, W4><<<grid, block, 0, stream>>>(
      a.queries, a.words, a.init_keys, a.E, a.adj, a.cap, a.W, a.points,
      a.n_pts, a.node_map, a.out_keys, a.out_visited, a.out_steps, a.B, a.ef,
      a.max_steps);
}

template <int CAP>
void launch_words(const Args& a, cudaStream_t stream) {
  switch (a.words) {  // 16-byte loads where a point is a whole int4 count
    case 8: launch<CAP, 2>(a, stream); break;
    case 16: launch<CAP, 4>(a, stream); break;
    case 32: launch<CAP, 8>(a, stream); break;
    case 64: launch<CAP, 16>(a, stream); break;
    default: launch<CAP, 0>(a, stream); break;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers: queries int32[B, words], init_keys int64[B, E] (ascending),
// adj int32[cap, W], points int32[n_pts, words] (16-byte aligned),
// node_map int32[>= cap] or null (identity), out_keys int64[B, ef],
// out_visited and out_steps int32[B].
int hnsw_dma_beam_search(const void* queries, int words, const void* init_keys,
                         int E, const void* adj, int cap, int W,
                         const void* points, int n_pts, const void* node_map,
                         void* out_keys, void* out_visited, void* out_steps,
                         int B, int ef, int max_steps, void* stream) {
  if (B <= 0 || cap <= 0 || W <= 0 || W > kMaxW || n_pts <= 0 || words <= 0 ||
      words > kMaxWords || ef <= 0 || ef > 128 || E <= 0 || E > ef ||
      max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(queries),
               words,
               static_cast<const long long*>(init_keys),
               E,
               static_cast<const int*>(adj),
               cap,
               W,
               static_cast<const int*>(points),
               n_pts,
               static_cast<const int*>(node_map),
               static_cast<long long*>(out_keys),
               static_cast<int*>(out_visited),
               static_cast<int*>(out_steps),
               B, ef, max_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef <= 64)
    launch_words<64>(a, s);
  else
    launch_words<128>(a, s);
  return static_cast<int>(cudaGetLastError());
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
