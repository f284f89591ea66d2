// Fused exact beam search over the fused table: one warp runs one query's
// whole search, from its entry key to termination, in one launch.
//
// Replaces hnsw_itu_tpu/ops/pallas_search.py::_make_kernel_packed (and
// ::_make_kernel, which computes the same function one query per row).
// Contract: bit-exact with hnsw_itu_tpu/ops/search.py::_beam_search_packed
// (expand=1, dedup="beam", tie_bits=0) and with its plain PyTorch port,
// hnsw_itu_tpu_torch/ops/search.py::beam_search_packed: the same keys,
// visited counts and step counts for every query.
//
// Layout (hnsw_itu_tpu_torch/ops/fused_search.py):
//   ids  int32[cap, W]          neighbor ids of node e, -1 = no edge
//   data int32[cap, W, words]   sketch of neighbor j of node e
// Keys: key = (min(d, dclamp) << id_bits) | id; key_inf = (dclamp + 1)
// << id_bits marks an empty slot.
//
// Per step (the beam machinery is beam_common.cuh's, as in the gather and
// mini kernels):
//  1. frontier; the row's W ids are loaded (lane owns j = lane, lane+32,
//     ...), in flight while the set is brought up to date;
//  2. every valid neighbor's sketch is read (the row read below) and its
//     key packed, the distance clamped to dclamp;
//  3. dedup of the row's keys against the set, one slot of 32 at a time;
//     the F fresh ones are packed into [0, F) and counted in `visited`;
//  4. merge.
//
// The dedup is on the packed key, not the id. The contract drops a
// candidate whose KEY equals a beam key or an earlier candidate's
// (dup = mk[1:] == mk[:-1] after a sort). On a table built from points the
// two coincide, but a hand-built row may list one id with two different
// sketches: both keys stay, and the beam may then hold that id twice. So
// the kernel widens each key at load: a packed key k < key_inf becomes the
// int64 k, an empty slot beam::kKeyInf. beam::key_id then returns the
// whole packed key, the id set holds packed keys (distinct in the beam by
// construction, as set_erase needs), and the order is kept: key_inf <=
// 2^31 - 2^id_bits, so no packed key is IINF. The output narrows back
// (kKeyInf -> key_inf). The distance is part of the dedup key, so every
// valid neighbor's sketch is read, duplicates too. There is one entry key
// (visited starts at 1), so no seed repeats.
//
// The row read. At words=32 (the product's width) groups of 8 lanes read
// one neighbor's 128-byte sketch together, 16 bytes a lane: one warp load
// covers 512 contiguous bytes of the row (4 lines, where one sketch per
// lane touches 32), a reduce-scatter over each group (7 shuffles a slot)
// sums the popcounts, and one shuffle hands each lane its own entry's
// distance for the dedup. Other widths read one sketch per lane. Measured
// on an H100 80GB HBM3 (700 W), 100k points, 10k queries, ef=32, 32
// steps (chip_smoke.py phase 6): 0.413 ms for the grouped read, 0.424 ms
// for one sketch per lane, 0.675 ms for the first design (per-candidate
// compare loops over the beam and the row in shared memory); the bound,
// the bytes of each expansion's ids and valid neighbors' sketches at HBM's
// rate, is 0.242 ms. From ef 32 to 128 at 32 steps the time moves 11%
// (the first design: 1.9x), so what is left is each step's two dependent
// round trips to device memory (the row's ids, then its sketches, from a
// table far larger than the 50 MB L2) and the instructions of 32 warps per
// SM. Neither tensor cores (no products: XOR, popcount, compares) nor TMA
// tiles (one data-chosen row a step, not a tile) apply.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_common.cuh"

namespace {

using beam::kFull;
using beam::kKeyInf;

constexpr int kMaxEf = 128;
constexpr int kMaxW = 128;
constexpr int kMaxWords = 64;
constexpr int kWarps = 4;  // queries per block

// Distances of slot s's 32 entries, lane l getting entry 32 s + l's, read
// by groups of G = WORDS/4 lanes: at pass it, the lanes of group u read
// the G int4 words of entry it * (32/G) + u together, lane l word l % G
// (qc: that word of the query). valid: bit n set where entry 32 s + n has
// a sketch to read. A reduce-scatter over each group (G - 1 shuffles)
// leaves lane l the sum of pass l % G, which one more shuffle moves to
// the lane that owns that entry.
template <int WORDS>
__device__ __forceinline__ int slot_distance_grouped(
    const int4* __restrict__ row4, int s, unsigned valid, int4 qc,
    int lane) {
  constexpr int G = WORDS / 4, NP = 32 / G;
  const int g = lane & (G - 1), u = lane / G;
  int p[G];
#pragma unroll
  for (int it = 0; it < G; ++it) {
    const int n = it * NP + u;
    int4 v = make_int4(0, 0, 0, 0);
    if ((valid >> n) & 1) v = __ldg(row4 + (size_t)(32 * s + n) * G + g);
    p[it] = __popc(v.x ^ qc.x) + __popc(v.y ^ qc.y) + __popc(v.z ^ qc.z) +
            __popc(v.w ^ qc.w);
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const int send = upper ? p[i] : p[i + o];
      const int keep = upper ? p[i + o] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return __shfl_sync(kFull, p[0], (lane % NP) * G + lane / NP);
}

// WORDS: 32 (the product's sketch width, read by groups of lanes), or 0:
// any width in `words` (a multiple of 4, <= kMaxWords), one sketch per
// lane. At most 64 registers up to two slots: 32 warps per SM, and 10k
// queries (10k warps) run in about 2.4 waves on 132 SMs.
template <int CAP, int SLOTS, int WORDS>
__global__ void __launch_bounds__(kWarps * 32, SLOTS <= 2 ? 8 : 4)
fused_beam_search_kernel(const int* __restrict__ queries,
                         const int* __restrict__ init_keys,
                         const int* __restrict__ ids,
                         const int* __restrict__ data,
                         int* __restrict__ out_keys,
                         int* __restrict__ out_visited,
                         int* __restrict__ out_steps, int B, int cap, int W,
                         int words_in, int ef, int id_bits, int key_inf,
                         int max_steps) {
  using Smem = beam::Beam<CAP, SLOTS>;
  constexpr int S = Smem::kSet;
  __shared__ Smem s_beam[kWarps];
  __shared__ int s_ck[kWarps][Smem::kW];  // fresh keys, packed
  // the query, for the one-sketch-per-lane read (WORDS = 0)
  __shared__ __align__(16) int s_q[kWarps][WORDS ? 4 : kMaxWords];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  const int words = WORDS ? WORDS : words_in;
  Smem& sm = s_beam[warp];
  int* ck = s_ck[warp];
  const int mask = (1 << id_bits) - 1;
  const int dclamp = (key_inf >> id_bits) - 1;
  const int* qrow = queries + (size_t)b * words;

  int4 qc = make_int4(0, 0, 0, 0);  // grouped read: this lane's query word
  if constexpr (WORDS != 0) {
    qc = __ldg(reinterpret_cast<const int4*>(qrow) + lane % (WORDS / 4));
  } else {
    for (int t = lane; t < words; t += 32) s_q[warp][t] = qrow[t];
  }
  const int init = init_keys[b];
  for (int i = lane; i < ef; i += 32) {
    sm.key[0][i] = i == 0 && init < key_inf ? init : kKeyInf;
    sm.flag[0][i] = 0;
  }
  __syncwarp();

  // hint: the frontier slot the last merge found (-1: none), -2: scan
  // tombs: erased set slots since the last rebuild (S: rebuild first)
  const int rebuild_after = Smem::rebuild_after(ef, W);
  int cur = 0, steps = 0, hint = -2, tombs = S, visited = 1;
  while (steps < max_steps) {
    const long long* bk = sm.key[cur];
    unsigned char* bf = sm.flag[cur];
    const int pos = hint == -2 ? beam::frontier(bk, bf, ef, lane) : hint;
    if (pos < 0) break;
    ++steps;
    const int e = min(static_cast<int>(bk[pos]) & mask, cap - 1);
    const int* row_ids = ids + (size_t)e * W;
    int nid[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * 32 + lane;
      nid[s] = j < W ? __ldg(row_ids + j) : -1;
    }
    __syncwarp();
    if (lane == 0) bf[pos] = 1;
    if (tombs > rebuild_after) {
      beam::set_rebuild<S, CAP>(sm.set, bk, ef, lane);
      tombs = 0;
    }

    const int* row = data + (size_t)e * W * words;
    const int4* row4 = reinterpret_cast<const int4*>(row);
    int key[SLOTS];  // the entry's packed key, -1: no neighbor
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const unsigned valid = __ballot_sync(kFull, nid[s] >= 0);
      int d = 0;
      if constexpr (WORDS != 0) {
        if (valid) d = slot_distance_grouped<WORDS>(row4, s, valid, qc, lane);
      } else if (nid[s] >= 0) {
        d = beam::point_distance(row + (size_t)(s * 32 + lane) * words,
                                 s_q[warp], words);
      }
      key[s] = nid[s] >= 0 ? (min(d, dclamp) << id_bits) | nid[s] : -1;
    }

    bool iinf_seen = false;  // no packed key is IINF: never set
    int F = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      int slot;
      const bool fresh = beam::dedup_slot<S>(sm.set, key[s], key[s] >= 0,
                                             iinf_seen, lane, slot);
      const unsigned m = __ballot_sync(kFull, fresh);
      if (fresh) {
        const int at = F + __popc(m & beam::lanemask_lt());
        ck[at] = key[s];
        sm.slot[at] = slot;
      }
      F += __popc(m);
    }
    __syncwarp();
    if (F == 0) {
      hint = -2;
      continue;
    }
    visited += F;

    long long fk[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = t * 32 + lane;
      fk[t] = c < F ? static_cast<long long>(ck[c]) : kKeyInf;
    }
    int erased;
    hint = beam::merge<S, CAP, SLOTS>(bk, bf, sm.key[cur ^ 1],
                                      sm.flag[cur ^ 1], sm.fresh, fk, F, ef,
                                      sm.set, sm.slot, lane, erased);
    tombs += erased;
    cur ^= 1;
  }

  int* out = out_keys + (size_t)b * ef;
  for (int i = lane; i < ef; i += 32) {
    const long long k = sm.key[cur][i];
    out[i] = k < kKeyInf ? static_cast<int>(k) : key_inf;
  }
  if (lane == 0) {
    if (steps == 0) out[0] = init;  // as given, also at or past key_inf
    out_visited[b] = visited;
    out_steps[b] = steps;
  }
}

struct Args {
  const int* queries;
  const int* init_keys;
  const int* ids;
  const int* data;
  int* out_keys;
  int* out_visited;
  int* out_steps;
  int B, cap, W, words, ef, id_bits, key_inf, max_steps;
};

// Launches the instance (CAP, SLOTS, WORDS) on `stream`, or with `warps`
// set, only reports its resident warps per SM.
template <int CAP, int SLOTS, int WORDS>
void run(const Args& a, cudaStream_t stream, int* warps) {
  const auto kernel = fused_beam_search_kernel<CAP, SLOTS, WORDS>;
  if (warps) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  kWarps * 32, 0);
    *warps = blocks * kWarps;
    return;
  }
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      a.queries, a.init_keys, a.ids, a.data, a.out_keys, a.out_visited,
      a.out_steps, a.B, a.cap, a.W, a.words, a.ef, a.id_bits, a.key_inf,
      a.max_steps);
}

// Row slots of 32: fused rows are a power of two wide (1 to 128), so a
// table has 1, 2 or 4 slots; a hand-made width of 65 to 96 takes the
// four-slot instance.
template <int CAP, int WORDS>
void run_slots(const Args& a, cudaStream_t stream, int* warps) {
  switch ((a.W + 31) / 32) {
    case 1: run<CAP, 1, WORDS>(a, stream, warps); break;
    case 2: run<CAP, 2, WORDS>(a, stream, warps); break;
    default: run<CAP, 4, WORDS>(a, stream, warps); break;
  }
}

template <int WORDS>
void run_caps(const Args& a, cudaStream_t stream, int* warps) {
  if (a.ef <= 64)
    run_slots<64, WORDS>(a, stream, warps);
  else
    run_slots<128, WORDS>(a, stream, warps);
}

void dispatch(const Args& a, cudaStream_t stream, int* warps) {
  if (a.words == 32)
    run_caps<32>(a, stream, warps);
  else
    run_caps<0>(a, stream, warps);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers: queries int32[B, words], init_keys int32[B], ids int32[cap, W],
// data int32[cap, W, words] (16-byte aligned), out_keys int32[B, ef],
// out_visited and out_steps int32[B].
int hnsw_fused_beam_search(const void* queries, const void* init_keys,
                           const void* ids, const void* data, void* out_keys,
                           void* out_visited, void* out_steps, int B, int cap,
                           int W, int words, int ef, int id_bits, int key_inf,
                           int max_steps, void* stream) {
  if (B <= 0 || cap <= 0 || W <= 0 || W > kMaxW || ef <= 0 || ef > kMaxEf ||
      words <= 0 || words > kMaxWords || words % 4 || id_bits < 1 ||
      id_bits > 30 || max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(queries),
               static_cast<const int*>(init_keys),
               static_cast<const int*>(ids),
               static_cast<const int*>(data),
               static_cast<int*>(out_keys),
               static_cast<int*>(out_visited),
               static_cast<int*>(out_steps),
               B, cap, W, words, ef, id_bits, key_inf, max_steps};
  dispatch(a, static_cast<cudaStream_t>(stream), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of the instance that serves (ef, W) at words=32.
int hnsw_fused_beam_search_warps(int ef, int W) {
  Args a{};
  a.ef = ef;
  a.W = W;
  a.words = 32;
  int warps = 0;
  dispatch(a, nullptr, &warps);
  return warps;
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
