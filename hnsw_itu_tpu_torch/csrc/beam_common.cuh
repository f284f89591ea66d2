// The beam machinery that the three beam kernels share: the mini-table
// kernel (mini_beam_search.cu), the gather kernel (dma_beam_search.cu) and
// the fused kernel (fused_beam_search.cu). One warp runs one query's whole
// search; only the reads of a row and of its neighbors' words are
// kernel-specific.
//
// Contract: the XLA two-key merge of hnsw_itu_tpu/ops/search.py::
// beam_search (expand=1, dedup="beam"), as hnsw_itu_tpu_torch/ops/search.py
// ::_merge_by_id writes it. Keys are int64 d << 32 | id (both fields >= 0);
// key_inf = DINF << 32 | IINF marks an empty slot. A row entry that is
// absent (< 0) takes part in the dedup as IINF, as the merge sees it. A
// candidate is a duplicate when its id is in the beam or repeats an earlier
// entry of the row; the rest are fresh, and those with id < IINF count in
// `visited`. The merge also keeps one beam key per id: seeds that repeat an
// id (a sampled entry over fewer points than its sample gives such seeds)
// lose their later copies before the first step (drop_repeated_seeds), so
// the beam's ids are distinct. Fresh keys never equal a beam key (their
// ids differ), so the merge positions below are a permutation and the
// result equals the merge's stable sort. The fused kernel's contract
// dedups on its packed int32 key instead of the id; it widens each key to
// the int64 k (key_id then returns the whole key), so that the "ids" here
// are its packed keys, and narrows them back on the way out.
//
// Per step, for one warp (warp-synchronous, no block barrier):
//  1. frontier: the slot of the best unexpanded key. The merge that ends a
//     step finds it with one __reduce_min_sync over the slots it writes; a
//     step without fresh candidates scans the beam by ballots over ef/32
//     chunks instead;
//  2. dedup in O((ef + W)/32) per lane, not O(ef + W): an open-addressed id
//     set in shared memory (linear probing from id mod its size) holds the
//     beam's ids from step to step. The row's entries go through it one
//     slot of 32 at a time, in ascending order: __match_any_sync elects the
//     lowest lane of each id in the slot, and the leaders place their ids in
//     rounds (load, store where free, __syncwarp, load back; no atomics): an
//     id found there is in the beam or earlier in the row. Id IINF never
//     enters the set; a ballot tracks it. The merge erases the ids that
//     leave (tombstones), and the set is rebuilt from the beam only when
//     the tombstones would pass half of it, every several steps;
//  3. compaction: ballot + prefix popcount pack the F fresh candidates into
//     [0, F), so that lane c then reads fresh neighbor c;
//  4. merge: for F <= 32 (nearly every step) each fresh key is broadcast by
//     a shuffle and every lane counts in registers how many fall below its
//     fresh key and below each of its beam keys; #(beam < c) is a binary
//     search. Beam key i moves to i + #(fresh < key), fresh key c to
//     #(beam < c) + #(fresh < c). F > 32 takes a general path: each chunk
//     of 32 fresh keys sorted by a bitonic network of shuffles, then binary
//     searches. The beam ping-pongs between two buffers.
// The first design: about ef + W shared-memory compares per lane for each
// candidate's dedup and W or ef + W for each rank, ~830 iterations a step
// at ef=96, W=64. Now: W/32 placements, about 2F/32 erasures, a rebuild of
// ef/32 placements every several steps, and F broadcasts.
//
// What this card offers the search: it is a chain of dependent reads (the
// expanded row, then the fresh neighbors' words) with XOR, popcount and
// compares in between. Tensor cores have no use: there are no products.
// TMA tiles do not apply either: each step reads one row and a handful of
// scattered neighbors chosen by the data, not a tile. The one Hopper copy
// feature that fits is the bulk L2 prefetch (cp.async.bulk.prefetch.L2):
// at the start of a step the warp knows the best unexpanded key after the
// one it expands, the next frontier unless a fresh key beats it, and can
// ask for that node's row ahead. Measured on the H100 it made both kernels
// slower (PERF.md), so neither issues it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace beam {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIInf = 0x7FFFFFFF;
constexpr long long kKeyInf = (0x7FFF0000LL << 32) | 0x7FFFFFFFLL;
constexpr int kEmpty = -1;  // a free id-set slot (ids are >= 0)
constexpr int kTomb = -2;   // an erased one

constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One warp's beam state. CAP: beam capacity (ef <= CAP); SLOTS: row slots
// of 32 (W <= 32 * SLOTS). The id set holds the beam's ids, a row's ids and
// tombstones, rebuilt before they pass half of it (rebuild_after).
template <int CAP, int SLOTS>
struct Beam {
  static constexpr int kW = 32 * SLOTS;
  static constexpr int kSet = pow2_at_least(2 * (CAP + kW)) > 512
                                  ? pow2_at_least(2 * (CAP + kW))
                                  : 512;
  long long key[2][CAP];  // ping-pong beams, ascending
  long long fresh[kW];    // sorted chunks of fresh keys (F > 32)
  __align__(16) int set[kSet];
  int slot[kW];                // set slots of the fresh ids, packed
  unsigned char flag[2][CAP];  // expanded flags

  // tombstones past which the set is rebuilt: the beam's ef ids, a row's
  // W and the tombstones stay within half the set
  __device__ static int rebuild_after(int ef, int W) {
    return kSet / 2 - ef - W;
  }
};

__device__ __forceinline__ int key_id(long long k) {
  return static_cast<int>(k & 0xffffffffLL);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Seeds into beam 0; returns the number of valid seeds (visited starts
// there).
template <int CAP, int SLOTS>
__device__ __forceinline__ int load_seeds(Beam<CAP, SLOTS>& s,
                                          const long long* __restrict__ init,
                                          int E, int ef, int lane) {
  int seeds = 0;
  for (int i = lane; i < ef; i += 32) {
    const long long k = i < E ? init[i] : kKeyInf;
    s.key[0][i] = k;
    s.flag[0][i] = 0;
    seeds += i < E && key_id(k) != kIInf;
  }
  return __reduce_add_sync(kFull, seeds);
}

// Before the first step, where the seeds repeat an id: every copy after
// the first becomes key_inf, the beam closes up behind the rest, and the
// empty slots go to its end, as the plain merge's dedup of the beam does
// at its first step (the first copy is the best key, and the one
// expanded). The first frontier, slot 0, stays where it is. The caller
// runs it once, before the step loop, where that loop will take a step
// (max_steps > 0 and beam[0] < key_inf), and only in its instances for
// more than one seed: code here, even never run, costs the one-seed
// instances spills in their step loop (PERF.md). Each lane compares its
// seeds with the earlier ones. Ends with __syncwarp.
template <int CAP>
__device__ __forceinline__ void drop_repeated_seeds(long long* bk, int E,
                                                    int ef, int lane) {
  constexpr int T = CAP / 32;
  long long k[T];
  bool rep[T];
  bool any = false;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = 32 * t + lane;
    k[t] = i < ef ? bk[i] : kKeyInf;
    rep[t] = false;
    for (int j = 0; i < E && k[t] < kKeyInf && j < i; ++j)
      rep[t] |= key_id(bk[j]) == key_id(k[t]);
    any |= rep[t];
  }
  if (!__any_sync(kFull, any)) return;
  __syncwarp();  // every lane has read the beam
  int gone = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = 32 * t + lane;
    const unsigned m = __ballot_sync(kFull, rep[t]);
    if (i < ef && !rep[t]) bk[i - gone - __popc(m & lanemask_lt())] = k[t];
    gone += __popc(m);
  }
  for (int i = ef - gone + lane; i < ef; i += 32) bk[i] = kKeyInf;
  __syncwarp();
}

// Hamming distance of the point at `p` to the query `q` (shared memory).
// words % 4 == 0: 16-byte loads, eight issued before the first use;
// otherwise one 4-byte load per word.
__device__ __forceinline__ int point_distance(const int* __restrict__ p,
                                              const int* q, int words) {
  int s = 0;
  if ((words & 3) == 0) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
    const int4* q4 = reinterpret_cast<const int4*>(q);
    const int n4 = words >> 2;
    for (int c0 = 0; c0 < n4; c0 += 8) {
      int4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < n4) v[c] = __ldg(p4 + c0 + c);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < n4) {
          const int4 w = q4[c0 + c];
          s += __popc(v[c].x ^ w.x) + __popc(v[c].y ^ w.y) +
               __popc(v[c].z ^ w.z) + __popc(v[c].w ^ w.w);
        }
    }
    return s;
  }
  for (int t = 0; t < words; ++t) s += __popc(__ldg(p + t) ^ q[t]);
  return s;
}

// The slot of the best unexpanded key (< key_inf, <= beam[ef-1]), or -1:
// the query is done.
__device__ __forceinline__ int frontier(const long long* bk,
                                        const unsigned char* bf, int ef,
                                        int lane) {
  const long long worst = bk[ef - 1];
  for (int base = 0; base < ef; base += 32) {
    const int i = base + lane;
    const bool open = i < ef && !bf[i] && bk[i] < kKeyInf && bk[i] <= worst;
    const unsigned m = __ballot_sync(kFull, open);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

template <int S>
__device__ __forceinline__ void set_clear(int* set, int lane) {
  int4* s4 = reinterpret_cast<int4*>(set);
#pragma unroll
  for (int t = lane; t < S / 4; t += 32)
    s4[t] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
}

// Places every lane's ids (0 <= id < IINF; < 0: none; distinct across the
// warp) into the set, in rounds: each pending id reads its probe slot, all
// of a lane's loads issued together; an id already there is found, a free
// slot is written, any other (an id, a tombstone) skipped; after a
// __syncwarp the writers read their slots back, and one that lost the slot
// to another lane probes on. No atomics. fresh[n]: id[n] was not in the set
// and now sits at slot[n].
template <int S, int N>
__device__ __forceinline__ void set_place(int* set, const int (&id)[N],
                                          bool (&fresh)[N], int (&slot)[N]) {
  volatile int* vs = set;
  bool todo[N];
  bool pending = false;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    slot[n] = id[n] & (S - 1);
    todo[n] = id[n] >= 0;
    fresh[n] = false;
    pending |= todo[n];
  }
  while (__any_sync(kFull, pending)) {
    int v[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      v[n] = todo[n] ? static_cast<int>(vs[slot[n]]) : kEmpty;
    bool wrote[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      wrote[n] = todo[n] && v[n] == kEmpty;
      if (wrote[n]) vs[slot[n]] = id[n];
      if (v[n] == id[n]) todo[n] = false;
    }
    __syncwarp();
    pending = false;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (wrote[n] && vs[slot[n]] == id[n]) {
        fresh[n] = true;
        todo[n] = false;
      } else if (todo[n]) {
        slot[n] = (slot[n] + 1) & (S - 1);
      }
      pending |= todo[n];
    }
    __syncwarp();
  }
}

// Marks the slot of id (in the set) a tombstone: lookups pass over it, and
// it stays taken until the next rebuild. The beam's ids are distinct, so
// the id is there; were it not, the probe would end at a free slot (the
// set is never more than half full) rather than spin.
template <int S>
__device__ __forceinline__ void set_erase(int* set, int id) {
  volatile int* vs = set;
  int h = id & (S - 1);
  int v;
  while ((v = vs[h]) != id) {
    if (v == kEmpty) return;
    h = (h + 1) & (S - 1);
  }
  vs[h] = kTomb;
}

// Clears the set and fills it with the beam's ids below IINF.
template <int S, int CAP>
__device__ __forceinline__ void set_rebuild(int* set, const long long* bk,
                                            int ef, int lane) {
  set_clear<S>(set, lane);
  int id[CAP / 32], slot[CAP / 32];
  bool placed[CAP / 32];
#pragma unroll
  for (int t = 0; t < CAP / 32; ++t) {
    const int i = 32 * t + lane;
    const int x = i < ef ? key_id(bk[i]) : kIInf;
    id[t] = x != kIInf ? x : -1;
  }
  __syncwarp();
  set_place<S>(set, id, placed, slot);
}

// True where some beam key has id IINF (an empty slot, or id 2^31 - 1).
template <int CAP>
__device__ __forceinline__ bool beam_has_iinf(const long long* bk, int ef,
                                              int lane) {
  bool any = false;
#pragma unroll
  for (int t = 0; t < CAP / 32; ++t) {
    const int i = 32 * t + lane;
    any |= i < ef && key_id(bk[i]) == kIInf;
  }
  return __any_sync(kFull, any);
}

// The dedup of one slot of 32 row entries, in ascending slot order. id:
// this lane's entry as the merge sees it (an absent neighbor as IINF; -1
// where the lane has none); valid: the neighbor exists. The set holds the
// beam's ids below IINF and the row's earlier ones; iinf_seen says whether
// the beam or an earlier entry had id IINF (IINF never enters the set).
// __match_any_sync elects the lowest lane of each id in the slot, and only
// the leaders place their ids. Returns whether the entry is fresh, with
// slot = where its id now sits in the set (-1: not placed).
template <int S>
__device__ __forceinline__ bool dedup_slot(int* set, int id, bool valid,
                                           bool& iinf_seen, int lane,
                                           int& slot) {
  const unsigned inf = __ballot_sync(kFull, id == kIInf);
  const bool fresh_inf = valid && id == kIInf && !iinf_seen &&
                         __ffs(inf) - 1 == lane;
  iinf_seen |= inf != 0;
  const int x = id != kIInf ? id : -1;
  const unsigned peers = __match_any_sync(kFull, x);
  const int lead[1] = {__ffs(peers) - 1 == lane ? x : -1};
  bool placed[1];
  int at[1];
  set_place<S>(set, lead, placed, at);
  slot = placed[0] ? at[0] : -1;
  return (placed[0] && valid) || fresh_inf;
}

// Ascending bitonic sort of one key per lane over each aligned group of P
// lanes (P a power of two <= 32).
__device__ __forceinline__ long long warp_sort(long long v, int P, int lane) {
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      const long long o = __shfl_xor_sync(kFull, v, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_min ? min(v, o) : max(v, o);
    }
  return v;
}

// #(a[i] < k) over the ascending a[0, n).
__device__ __forceinline__ int count_below(const long long* a, int n,
                                           long long k) {
  if (n <= 0) return 0;
  const long long* b = a;
  while (n > 1) {
    const int half = n >> 1;
    b = b[half] < k ? b + half : b;
    n -= half;
  }
  return static_cast<int>(b - a) + (*b < k);
}

// Sorts the F fresh keys (key[t] of lane l: fresh key 32 t + l, key_inf
// past F) within each chunk of 32 into fresh[32 t ..]; key[t] of lane l
// becomes the chunk's l-th smallest.
template <int SLOTS>
__device__ __forceinline__ void sort_fresh(long long* fresh,
                                           long long (&key)[SLOTS], int F,
                                           int lane) {
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const int n = F - 32 * t;
    if (n <= 0) break;
    const int P = n >= 32 ? 32 : (n <= 1 ? 1 : 1 << (32 - __clz(n - 1)));
    key[t] = warp_sort(key[t], P, lane);
    if (lane < n) fresh[32 * t + lane] = key[t];
  }
  __syncwarp();
}

// #(fresh < k) over the sorted chunks, leaving out chunk `skip`.
template <int SLOTS>
__device__ __forceinline__ int fresh_below(const long long* fresh, int F,
                                           long long k, int skip) {
  int r = 0;
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const int n = min(32, F - 32 * t);
    if (n <= 0) break;
    if (t != skip) r += count_below(fresh + 32 * t, n, k);
  }
  return r;
}

// Merges the sorted fresh chunks into the beam (bk, bf) -> (nk, nf), cut
// to ef. Ends with __syncwarp.
template <int SLOTS>
__device__ __forceinline__ void merge_sorted(const long long* bk,
                                             const unsigned char* bf,
                                             long long* nk, unsigned char* nf,
                                             const long long* fresh,
                                             const long long (&key)[SLOTS],
                                             int F, int ef, int lane) {
  for (int i = lane; i < ef; i += 32) {
    const long long k = bk[i];
    const int p = i + fresh_below<SLOTS>(fresh, F, k, -1);
    if (p < ef) {
      nk[p] = k;
      nf[p] = bf[i];
    }
  }
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    if (32 * t + lane < F) {
      const long long k = key[t];
      const int p = lane + fresh_below<SLOTS>(fresh, F, k, t) +
                    count_below(bk, ef, k);
      if (p < ef) {
        nk[p] = k;
        nf[p] = 0;
      }
    }
  }
  __syncwarp();
}

// F <= 32 fresh keys, lane c < F holding key c (unsorted; key_inf past F):
// each is broadcast in turn, and every lane counts, in registers, how many
// fall below its fresh key (the rank among the fresh) and below each of its
// beam keys (the shift); #(beam < c) is a binary search. No sort, no
// shared-memory copy of the fresh keys. The ids that leave (beam keys pushed
// past ef, fresh keys that do not enter) are erased from the set; `erased`
// counts them. Returns the next frontier slot of the merged beam (-1:
// none), the least unexpanded slot below key_inf, by one
// __reduce_min_sync. Ends with __syncwarp.
template <int S, int CAP>
__device__ __forceinline__ int merge_small(const long long* bk,
                                           const unsigned char* bf,
                                           long long* nk, unsigned char* nf,
                                           long long fk, int F, int ef,
                                           int* set, const int* fslot,
                                           int lane, int& erased) {
  constexpr int T = CAP / 32;
  long long b[T];
  int shift[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = 32 * t + lane;
    b[t] = i < ef ? bk[i] : kKeyInf;
    shift[t] = 0;
  }
  int rank = 0;
  for (int c = 0; c < F; ++c) {
    const long long f = __shfl_sync(kFull, fk, c);
    rank += f < fk;
#pragma unroll
    for (int t = 0; t < T; ++t) shift[t] += f < b[t];
  }
  int first = ef, gone = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = 32 * t + lane;
    const int p = i + shift[t];
    if (i < ef && p < ef) {
      const unsigned char x = bf[i];
      nk[p] = b[t];
      nf[p] = x;
      if (!x && b[t] < kKeyInf) first = min(first, p);
    } else if (i < ef && key_id(b[t]) != kIInf) {
      set_erase<S>(set, key_id(b[t]));
      ++gone;
    }
  }
  if (lane < F) {
    const int p = rank + count_below(bk, ef, fk);
    if (p < ef) {
      nk[p] = fk;
      nf[p] = 0;
      first = min(first, p);
    } else if (fslot[lane] >= 0) {
      set[fslot[lane]] = kTomb;
      ++gone;
    }
  }
  first = __reduce_min_sync(kFull, first);
  erased = __reduce_add_sync(kFull, gone);
  __syncwarp();
  return first < ef ? first : -1;
}

// Merges the F fresh keys (key[t] of lane l: fresh key 32 t + l, key_inf
// past F; their set slots in fslot) into (bk, bf) -> (nk, nf). Returns the
// next frontier slot (-1: none), or -2 where the frontier scan must find it
// (F > 32: the chunks are sorted and merged by binary search, and the set
// is left to a rebuild: `erased` is then past any limit).
template <int S, int CAP, int SLOTS>
__device__ __forceinline__ int merge(const long long* bk,
                                     const unsigned char* bf, long long* nk,
                                     unsigned char* nf, long long* fresh,
                                     long long (&key)[SLOTS], int F, int ef,
                                     int* set, const int* fslot, int lane,
                                     int& erased) {
  if (F <= 32)
    return merge_small<S, CAP>(bk, bf, nk, nf, key[0], F, ef, set, fslot,
                               lane, erased);
  sort_fresh<SLOTS>(fresh, key, F, lane);
  merge_sorted<SLOTS>(bk, bf, nk, nf, fresh, key, F, ef, lane);
  erased = S;
  return -2;
}

}  // namespace beam
