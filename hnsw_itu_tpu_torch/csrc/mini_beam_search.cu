// Mini-table beam search: one warp runs one query's whole search on prefix
// ("estimated") Hamming distances, from its seed keys to termination, in
// one launch.
//
// Replaces hnsw_itu_tpu/ops/pallas_dma_search.py::_make_mini_kernel_packed
// (beam half 64), ::_make_mini_kernel_s128 (beam half 128) and
// ::_make_mini_kernel (any half): the three compute one function and differ
// only in TPU lane layout. Here one kernel, templated on the beam capacity
// (64 for ef <= 64, 128 above) and on the row's slots of 32, covers all
// three. Contract: bit-exact with the XLA two-key beam search
// (hnsw_itu_tpu/ops/search.py::beam_search, expand=1, dedup="beam") on the
// truncated sketches, and with its plain PyTorch port,
// hnsw_itu_tpu_torch/ops/search.py::beam_search_two_plane: the same keys,
// visited counts and step counts for every query. Unlike the Pallas
// kernels, and like the XLA merge, a neighbor repeated within one row is a
// duplicate (ROADMAP §3).
//
// Layout (hnsw_itu_tpu_torch/ops/mini_search.py):
//   table int32[cap, W, MV], MV = 1 + mini_words: neighbor j of node e is
//   table[e, j, 0] (id, -1 = no edge) then its first mini_words words.
// With tie_bits > 0 the key's id field holds the bit-reversal of the low
// tie_bits bits of the id: encoded before the dedup and every compare,
// decoded for the row fetch (the wrapper decodes the output).
//
// Per step (the beam machinery is beam_common.cuh's): frontier; each lane
// reads only its neighbors' ids (j = lane, lane+32, ...), in flight while
// the id set is brought up to date; the dedup packs the F fresh ones into
// [0, F), and lane c reads fresh neighbor c's prefix (16-byte loads when
// MV is a multiple of 4); then the merge. Two dependent round trips a
// step, but at W=64, mini_words=31 about 2.9 KB (a 32-byte sector per id,
// 128 B per fresh neighbor) instead of the whole 8 KB row. Reading each
// neighbor whole (id and prefix in one round trip, then the dedup) was
// measured slower on the H100 (PERF.md) and is not kept.
//
// What bounds it on an H100. The first design (a shared-memory compare per
// beam key and per earlier candidate for each candidate, ranks by counting
// over all W slots) was issue-bound, with per-step work that doubled from
// capacity 64 to 128. Now a step costs W/32 set placements, a few erasures
// and F broadcasts per lane, and what is left is the chain of row reads:
// each expansion reads one node's mini row anywhere in a table of many GB
// (18 GB at 2.2M points), far past the 50 MB L2, and the next expansion
// depends on it. Neither tensor cores (no products: XOR, popcount,
// compares) nor TMA tiles (one data-chosen row a step, not a tile) apply;
// the bulk L2 prefetch of the next frontier's 8 KB row would, but was
// measured to cost more than it saves (PERF.md) and is not issued.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_common.cuh"

namespace {

using beam::kFull;
using beam::kIInf;
using beam::kKeyInf;
using beam::key_id;

constexpr int kMaxW = 128;
constexpr int kMaxMv = 32;  // 1 + mini_words, at most
constexpr int kWarps = 4;   // queries per block

// bit reversal of the low `bits` bits: an involution on [0, 2^bits)
__device__ __forceinline__ int tie_code(int id, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(id)) >> (32 - bits))
              : id;
}

// Prefix distance of neighbor `p` (MV ints: id, then prefix words) to the
// query `q` (q[0] = 0, q[t] = query word t-1). mv % 4 == 0: 16-byte loads,
// all issued before the first use; otherwise 4-byte loads.
__device__ __forceinline__ int prefix_distance(const int* __restrict__ p,
                                               const int* q, int mv) {
  int s = 0;
  if ((mv & 3) == 0) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
    const int4* q4 = reinterpret_cast<const int4*>(q);
    const int n4 = mv >> 2;  // <= 8
    int4 v[kMaxMv / 4];
#pragma unroll
    for (int c = 0; c < kMaxMv / 4; ++c)
      if (c < n4) v[c] = __ldg(p4 + c);
    s = __popc(v[0].y ^ q4[0].y) + __popc(v[0].z ^ q4[0].z) +
        __popc(v[0].w ^ q4[0].w);
#pragma unroll
    for (int c = 1; c < kMaxMv / 4; ++c)
      if (c < n4) {
        const int4 w = q4[c];
        s += __popc(v[c].x ^ w.x) + __popc(v[c].y ^ w.y) +
             __popc(v[c].z ^ w.z) + __popc(v[c].w ^ w.w);
      }
    return s;
  }
  for (int t = 1; t < mv; ++t) s += __popc(__ldg(p + t) ^ q[t]);
  return s;
}

// Registers: the one-slot capacity-64 instance fits in 64 (32 resident
// warps per SM); the other one- and two-slot instances spill at 64 (56-88
// B of stack) and take 80, spill-free, at 24 warps per SM: on the H100,
// 16-22% faster at 10k queries, which run in several waves either way
// (PERF.md). Three and four slots take up to 128 (16 warps).
template <int CAP, int SLOTS, bool SEEDS>
__global__ void __launch_bounds__(kWarps * 32,
                                  SLOTS == 1 && CAP == 64 ? 8
                                  : SLOTS <= 2            ? 6
                                                          : 4)
mini_beam_search_kernel(const int* __restrict__ queries, int words,
                        const long long* __restrict__ init_keys, int E,
                        const int* __restrict__ table,
                        long long* __restrict__ out_keys,
                        int* __restrict__ out_visited,
                        int* __restrict__ out_steps, int B, int cap, int W,
                        int mv, int ef, int tie_bits, int max_steps) {
  using Smem = beam::Beam<CAP, SLOTS>;
  constexpr int S = Smem::kSet;
  __shared__ Smem s_beam[kWarps];
  // the fresh candidates, packed: row position and encoded id
  __shared__ int s_col[kWarps][Smem::kW];
  __shared__ int s_code[kWarps][Smem::kW];
  __shared__ __align__(16) int s_q[kWarps][kMaxMv];  // 0, query prefix

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  Smem& sm = s_beam[warp];
  int* col = s_col[warp];
  int* code = s_code[warp];
  const int* q = s_q[warp];
  const int id_cap = tie_bits ? static_cast<int>((1u << tie_bits) - 1u) : 0;
  const size_t row_ints = (size_t)W * mv;

  s_q[warp][lane] =
      (lane >= 1 && lane < mv) ? queries[(size_t)b * words + lane - 1] : 0;
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
    int e = key_id(bk[pos]);
    if (tie_bits) e = tie_code(min(max(e, 0), id_cap), tie_bits);
    e = min(max(e, 0), cap - 1);
    const int* row = table + (size_t)e * row_ints;
    int ids[SLOTS];  // the row's ids, in flight during the set work
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * 32 + lane;
      ids[s] = j < W ? __ldg(row + (size_t)j * mv) : -1;
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
      const int id = ids[s];
      const int c = id >= 0 ? tie_code(id, tie_bits) : kIInf;
      int slot;
      const bool fresh = beam::dedup_slot<S>(sm.set, j < W ? c : -1, id >= 0,
                                             iinf_seen, lane, slot);
      const unsigned m = __ballot_sync(kFull, fresh);
      if (fresh) {
        const int at = F + __popc(m & beam::lanemask_lt());
        col[at] = j;
        code[at] = c;
        sm.slot[at] = slot;
      }
      F += __popc(m);
      counted += __popc(__ballot_sync(kFull, fresh && c != kIInf));
    }
    __syncwarp();
    if (F == 0) {
      hint = -2;
      continue;
    }
    long long key[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = t * 32 + lane;
      key[t] = kKeyInf;
      if (c < F) {
        const int d = prefix_distance(row + (size_t)col[c] * mv, q, mv);
        key[t] = (static_cast<long long>(d) << 32) |
                 static_cast<unsigned>(code[c]);
      }
    }
    visited += counted;
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
  const int* table;
  long long* out_keys;
  int* out_visited;
  int* out_steps;
  int B, cap, W, mv, ef, tie_bits, max_steps;
};

// Launches the instance (CAP, SLOTS, SEEDS) on `stream`, or with `warps`
// set, only reports its resident warps per SM.
template <int CAP, int SLOTS, bool SEEDS>
void run(const Args& a, cudaStream_t stream, int* warps) {
  const auto kernel = mini_beam_search_kernel<CAP, SLOTS, SEEDS>;
  if (warps) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  kWarps * 32, 0);
    *warps = blocks * kWarps;
    return;
  }
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      a.queries, a.words, a.init_keys, a.E, a.table, a.out_keys,
      a.out_visited, a.out_steps, a.B, a.cap, a.W, a.mv, a.ef, a.tie_bits,
      a.max_steps);
}

template <int CAP, bool SEEDS>
void run_slots(const Args& a, cudaStream_t stream, int* warps) {
  switch ((a.W + 31) / 32) {  // row slots of 32
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
// table int32[cap, W, mv], out_keys int64[B, ef], out_visited and
// out_steps int32[B]. table must be 16-byte aligned.
int hnsw_mini_beam_search(const void* queries, int words,
                          const void* init_keys, int E, const void* table,
                          void* out_keys, void* out_visited, void* out_steps,
                          int B, int cap, int W, int mv, int ef, int tie_bits,
                          int max_steps, void* stream) {
  if (B <= 0 || cap <= 0 || W <= 0 || W > kMaxW || mv < 2 || mv > kMaxMv ||
      mv - 1 > words || ef <= 0 || ef > 128 || E <= 0 || E > ef ||
      tie_bits < 0 || tie_bits > 31 || max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(queries),
               words,
               static_cast<const long long*>(init_keys),
               E,
               static_cast<const int*>(table),
               static_cast<long long*>(out_keys),
               static_cast<int*>(out_visited),
               static_cast<int*>(out_steps),
               B, cap, W, mv, ef, tie_bits, max_steps};
  dispatch(a, static_cast<cudaStream_t>(stream), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of the one-seed instance that serves (ef, W).
int hnsw_mini_beam_search_warps(int ef, int W) {
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
