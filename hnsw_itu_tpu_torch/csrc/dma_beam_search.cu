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
// Per step (the beam machinery is beam_common.cuh's):
//  1. frontier; the row's W ids are loaded (lane owns j = lane, lane+32,
//     ...) and are in flight while the id set is brought up to date;
//  2. dedup of the row against the set, one slot of 32 at a time;
//  3. the F fresh ids are packed into [0, F), and lane c fetches fresh
//     neighbor c's point (through node_map when given; 16-byte loads when
//     words is a multiple of 4): all of a step's point reads go out in one
//     wave, and a duplicate costs no read;
//  4. XOR + __popc with the query in shared memory -> keys; merge.
//
// What bounds it on an H100. The first design (a shared-memory compare per
// beam key and per earlier row entry for each candidate, ranks by counting
// over all W slots) was issue-bound: ~830 compare iterations a step at
// ef=96, W=64. Now a step is a short chain: the row read, the set
// placements, the point reads, the broadcast merge. What is left is that
// chain's latency, two dependent round trips to device memory (the row,
// 256 B at W=64; the fresh points, 128 B each, anywhere in a point array
// far larger than the 50 MB L2; three with node_map) and the instructions
// of 32 warps sharing an SM: its time no longer grows with ef at a fixed
// number of steps (PERF.md, the ef sweep). Neither tensor cores (no
// products: XOR, popcount, compares) nor TMA tiles (scattered rows, not
// tiles) apply; the bulk L2 prefetch of the next frontier's row (4 W
// bytes) would, but was measured slower here (PERF.md) and is not issued.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_common.cuh"

namespace {

using beam::kFull;
using beam::kIInf;
using beam::kKeyInf;
using beam::key_id;

constexpr int kMaxW = 128;
constexpr int kMaxWords = 64;
constexpr int kWarps = 4;  // queries per block

// At most 64 registers up to two slots: 32 warps per SM, so a 4096-search
// build chunk runs in one wave on 132 SMs. The two-slot instances spill at
// 64 (80-96 B of stack); 80 registers end that but leave 24 warps per SM
// and two waves, measured 17% slower on the H100 (PERF.md).
template <int CAP, int SLOTS, bool SEEDS>
__global__ void __launch_bounds__(kWarps * 32, SLOTS <= 2 ? 8 : 4)
dma_beam_search_kernel(const int* __restrict__ queries, int words,
                       const long long* __restrict__ init_keys, int E,
                       const int* __restrict__ adj, int cap, int W,
                       const int* __restrict__ points, int n_pts,
                       const int* __restrict__ node_map,
                       long long* __restrict__ out_keys,
                       int* __restrict__ out_visited,
                       int* __restrict__ out_steps, int B, int ef,
                       int max_steps) {
  using Smem = beam::Beam<CAP, SLOTS>;
  constexpr int S = Smem::kSet;
  __shared__ Smem s_beam[kWarps];
  __shared__ int s_cid[kWarps][Smem::kW];  // fresh ids, packed
  __shared__ __align__(16) int s_q[kWarps][kMaxWords];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  Smem& sm = s_beam[warp];
  int* cid = s_cid[warp];
  const int* q = s_q[warp];

  for (int t = lane; t < words; t += 32)
    s_q[warp][t] = queries[(size_t)b * words + t];
  int visited = beam::load_seeds(sm, init_keys + (size_t)b * E, E, ef, lane);
  __syncwarp();
  // SEEDS (E > 1): repeated seed ids go before the first step, which
  // expands slot 0 where it holds a key, as the plain merge drops them at
  // that step. One-seed instances carry none of this code.
  if constexpr (SEEDS) {
    if (max_steps > 0 && sm.key[0][0] < kKeyInf)
      beam::drop_repeated_seeds<CAP>(sm.key[0], E, ef, lane);
  }

  // hint: the frontier slot the last merge found (-1: none), -2: scan
  // tombs: erased set slots since the last rebuild (S: rebuild first)
  const int rebuild_after = Smem::rebuild_after(ef, W);
  int cur = 0, steps = 0, hint = -2, tombs = S;
  while (steps < max_steps) {
    const long long* bk = sm.key[cur];
    unsigned char* bf = sm.flag[cur];
    const int pos = hint == -2 ? beam::frontier(bk, bf, ef, lane) : hint;
    if (pos < 0) break;
    ++steps;
    const int e = min(max(key_id(bk[pos]), 0), cap - 1);
    const int* row = adj + (size_t)e * W;
    int nid[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * 32 + lane;
      nid[s] = j < W ? __ldg(row + j) : -1;
    }
    __syncwarp();
    if (lane == 0) bf[pos] = 1;
    if (tombs > rebuild_after) {
      beam::set_rebuild<S, CAP>(sm.set, bk, ef, lane);
      tombs = 0;
    }
    bool iinf_seen = beam::beam_has_iinf<CAP>(bk, ef, lane);

    int F = 0, counted = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * 32 + lane;
      const bool valid = j < W && nid[s] >= 0;
      const int id = j < W ? (valid ? nid[s] : kIInf) : -1;
      int slot;
      const bool fresh =
          beam::dedup_slot<S>(sm.set, id, valid, iinf_seen, lane, slot);
      const unsigned m = __ballot_sync(kFull, fresh);
      if (fresh) {
        const int at = F + __popc(m & beam::lanemask_lt());
        cid[at] = nid[s];
        sm.slot[at] = slot;
      }
      F += __popc(m);
      counted += __popc(__ballot_sync(kFull, fresh && nid[s] != kIInf));
    }
    __syncwarp();
    if (F == 0) {
      hint = -2;
      continue;
    }
    visited += counted;

    long long key[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = t * 32 + lane;
      key[t] = kKeyInf;
      if (c < F) {
        const int id = cid[c];
        const int g = min(id, cap - 1);
        int r = node_map ? __ldg(node_map + g) : g;
        r = min(max(r, 0), n_pts - 1);
        const int d =
            beam::point_distance(points + (size_t)r * words, q, words);
        key[t] = (static_cast<long long>(d) << 32) | id;
      }
    }
    int erased;
    hint = beam::merge<S, CAP, SLOTS>(bk, bf, sm.key[cur ^ 1],
                                      sm.flag[cur ^ 1], sm.fresh, key, F, ef,
                                      sm.set, sm.slot, lane, erased);
    tombs += erased;
    cur ^= 1;
  }

  for (int i = lane; i < ef; i += 32)
    out_keys[(size_t)b * ef + i] = sm.key[cur][i];
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

// Launches the instance (CAP, SLOTS, SEEDS) on `stream`, or with `warps`
// set, only reports its resident warps per SM.
template <int CAP, int SLOTS, bool SEEDS>
void run(const Args& a, cudaStream_t stream, int* warps) {
  const auto kernel = dma_beam_search_kernel<CAP, SLOTS, SEEDS>;
  if (warps) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  kWarps * 32, 0);
    *warps = blocks * kWarps;
    return;
  }
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      a.queries, a.words, a.init_keys, a.E, a.adj, a.cap, a.W, a.points,
      a.n_pts, a.node_map, a.out_keys, a.out_visited, a.out_steps, a.B, a.ef,
      a.max_steps);
}

template <int CAP, bool SEEDS>
void run_slots(const Args& a, cudaStream_t stream, int* warps) {
  switch ((a.W + 31) / 32) {  // row slots of 32: the build's W are 24, 64
    case 1: run<CAP, 1, SEEDS>(a, stream, warps); break;
    case 2: run<CAP, 2, SEEDS>(a, stream, warps); break;
    case 3: run<CAP, 3, SEEDS>(a, stream, warps); break;
    default: run<CAP, 4, SEEDS>(a, stream, warps); break;
  }
}

template <bool SEEDS>
void run_caps(const Args& a, cudaStream_t stream, int* warps) {
  if (a.ef <= 64)
    run_slots<64, SEEDS>(a, stream, warps);
  else
    run_slots<128, SEEDS>(a, stream, warps);
}

void dispatch(const Args& a, cudaStream_t stream, int* warps) {
  if (a.E > 1)
    run_caps<true>(a, stream, warps);
  else
    run_caps<false>(a, stream, warps);
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
  dispatch(a, static_cast<cudaStream_t>(stream), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of the one-seed instance that serves (ef, W).
int hnsw_dma_beam_search_warps(int ef, int W) {
  Args a{};
  a.ef = ef;
  a.W = W;
  int warps = 0;
  dispatch(a, nullptr, &warps);
  return warps;
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
