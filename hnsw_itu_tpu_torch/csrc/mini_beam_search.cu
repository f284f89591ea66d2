// Mini-table beam search: one warp runs one query's whole search on prefix
// ("estimated") Hamming distances, from its seed keys to termination, in
// one launch.
//
// Replaces hnsw_itu_tpu/ops/pallas_dma_search.py::_make_mini_kernel_packed
// (beam half 64), ::_make_mini_kernel_s128 (beam half 128) and
// ::_make_mini_kernel (any half): the three compute one function and differ
// only in TPU lane layout. Here one kernel, templated on the beam capacity
// (64 for ef <= 64, 128 above), covers all three. Contract: bit-exact with
// the XLA two-key beam search (hnsw_itu_tpu/ops/search.py::beam_search,
// expand=1, dedup="beam") on the truncated sketches, and with its plain
// PyTorch port, hnsw_itu_tpu_torch/ops/search.py::beam_search_two_plane:
// the same keys, visited counts and step counts for every query. Unlike
// the Pallas kernels, and like the XLA merge, a neighbor repeated within
// one row is a duplicate (ROADMAP §3).
//
// What bounds it on an H100: latency, not bandwidth. Each expansion reads
// one node's mini row (W ids and, for each valid neighbor, mini_words
// sketch words; 8 KB at W=64, mini_words=31 when the row is full) from
// anywhere in a table of many GB (18 GB at 2.2M points), far past the
// 50 MB L2, and the next expansion depends on it; the arithmetic per byte
// is one XOR and one popcount. The design keeps each lane's loads
// independent (a lane owns neighbors lane, lane+32, ...; 16-byte loads
// when 1 + mini_words is a multiple of 4), reads a neighbor's prefix only
// when its id (the first 4 bytes of the same 16-byte load) is valid, and
// keeps the beam, the candidates and the query prefix in shared memory, so
// nothing but row reads, seeds and the final keys touches device memory.
//
// Layout (hnsw_itu_tpu_torch/ops/mini_search.py):
//   table int32[cap, W, MV], MV = 1 + mini_words: neighbor j of node e is
//   table[e, j, 0] (id, -1 = no edge) then its first mini_words words.
// Keys: int64 d << 32 | id (both fields >= 0), so ids up to 2^31 are exact;
// key_inf = DINF << 32 | IINF marks an empty slot. With tie_bits > 0 the
// id field holds the bit-reversal of the low tie_bits bits of the id
// (encoded before every compare, decoded for the row fetch; the wrapper
// decodes the output). Beam keys are unique except key_inf.
//
// Per step, for one query (warp-synchronous, no block barrier):
//  1. frontier: the first beam slot that is unexpanded, < key_inf and
//     <= beam[ef-1] (the beam is sorted, so this is the best unexpanded
//     key); none -> the query is done;
//  2. each lane takes neighbors j = lane, lane+32, ... of the expanded
//     node: id, then XOR + __popc over its prefix words; tie-encode the id;
//  3. a candidate whose id is in the beam, or repeats an earlier candidate
//     of the row, is a duplicate; the rest are fresh and count in visited;
//  4. rank merge: beam key i moves to i + #(fresh < key), fresh key c to
//     #(beam < c) + #(fresh < c); positions >= ef fall out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;
constexpr int kSlots = kMaxW / 32;  // candidates per lane at most
constexpr int kMaxMv = 32;          // 1 + mini_words, at most
constexpr int kWarps = 4;           // queries per block
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kKeyInf = (0x7FFF0000LL << 32) | 0x7FFFFFFFLL;

__device__ __forceinline__ int key_id(long long k) {
  return static_cast<int>(k & 0xffffffffLL);
}

// bit reversal of the low `bits` bits: an involution on [0, 2^bits)
__device__ __forceinline__ int tie_code(int id, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(id)) >> (32 - bits))
              : id;
}

// Reads neighbor `p` (MV ints: id, then prefix words); returns its id and,
// when the id is valid, sets d to the prefix distance to the query `q`
// (q[0] unused, q[t] = query word t-1). MV = 0: the run-time width `mv`,
// one 4-byte load per word; otherwise 16-byte loads.
template <int MV>
__device__ __forceinline__ int read_neighbor(const int* __restrict__ p,
                                             const int* q, int mv, int& d) {
  if constexpr (MV > 0) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
    const int4* q4 = reinterpret_cast<const int4*>(q);
    const int4 v0 = __ldg(p4);
    if (v0.x < 0) return v0.x;
    const int4 c0 = q4[0];
    int s = __popc(v0.y ^ c0.y) + __popc(v0.z ^ c0.z) + __popc(v0.w ^ c0.w);
#pragma unroll
    for (int c = 1; c < MV / 4; ++c) {
      const int4 v = __ldg(p4 + c);
      const int4 w = q4[c];
      s += __popc(v.x ^ w.x) + __popc(v.y ^ w.y) + __popc(v.z ^ w.z) +
           __popc(v.w ^ w.w);
    }
    d = s;
    return v0.x;
  } else {
    const int id = __ldg(p);
    if (id < 0) return id;
    int s = 0;
    for (int t = 1; t < mv; ++t) s += __popc(__ldg(p + t) ^ q[t]);
    d = s;
    return id;
  }
}

template <int CAP, int MV>
__global__ void __launch_bounds__(kWarps * 32)
mini_beam_search_kernel(const int* __restrict__ queries, int words,
                        const long long* __restrict__ init_keys, int E,
                        const int* __restrict__ table,
                        long long* __restrict__ out_keys,
                        int* __restrict__ out_visited,
                        int* __restrict__ out_steps, int B, int cap, int W,
                        int mv, int ef, int tie_bits, int max_steps) {
  __shared__ long long s_bk[kWarps][CAP];  // beam keys, ascending
  __shared__ long long s_nk[kWarps][CAP];  // merged beam keys
  __shared__ long long s_ck[kWarps][kMaxW];  // candidate keys
  __shared__ int s_bf[kWarps][CAP];  // expanded flags
  __shared__ int s_nf[kWarps][CAP];  // merged flags
  __shared__ __align__(16) int s_q[kWarps][kMaxMv];  // 0, query prefix

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  long long* bk = s_bk[warp];
  long long* nk = s_nk[warp];
  long long* ck = s_ck[warp];
  int* bf = s_bf[warp];
  int* nf = s_nf[warp];
  const int* q = s_q[warp];
  const int stride = MV > 0 ? MV : mv;
  const int id_cap = tie_bits ? static_cast<int>((1u << tie_bits) - 1u) : 0;

  s_q[warp][lane] =
      (lane >= 1 && lane < mv) ? queries[(size_t)b * words + lane - 1] : 0;
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
    int e = key_id(bk[pos]);
    if (tie_bits) e = tie_code(min(max(e, 0), id_cap), tie_bits);
    e = min(max(e, 0), cap - 1);
    __syncwarp();
    if (lane == 0) bf[pos] = 1;

    // 2. candidate keys
    const int* row = table + (size_t)e * W * stride;
    long long key[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      key[s] = kKeyInf;
      if (j < W) {
        int d = 0;
        const int nbr = read_neighbor<MV>(row + (size_t)j * stride, q, mv, d);
        if (nbr >= 0)
          key[s] = (static_cast<long long>(d) << 32) |
                   static_cast<unsigned>(tie_code(nbr, tie_bits));
        ck[j] = key[s];
      }
    }
    __syncwarp();

    // 3. dedup by id against the beam and against earlier candidates
    int fresh_total = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      const int cid = key_id(key[s]);
      bool fresh = j < W && key[s] < kKeyInf;
      for (int i = 0; fresh && i < ef; ++i) fresh = key_id(bk[i]) != cid;
      for (int i = 0; fresh && i < j; ++i) fresh = key_id(ck[i]) != cid;
      if (!fresh) key[s] = kKeyInf;
      fresh_total += __popc(__ballot_sync(kFull, fresh));
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      if (j < W) ck[j] = key[s];
    }
    __syncwarp();
    if (fresh_total == 0) continue;
    visited += fresh_total;

    // 4. rank merge into nk/nf, then copy back
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
  const int* table;
  long long* out_keys;
  int* out_visited;
  int* out_steps;
  int B, cap, W, mv, ef, tie_bits, max_steps;
};

template <int CAP, int MV>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  mini_beam_search_kernel<CAP, MV><<<grid, block, 0, stream>>>(
      a.queries, a.words, a.init_keys, a.E, a.table, a.out_keys,
      a.out_visited, a.out_steps, a.B, a.cap, a.W, a.mv, a.ef, a.tie_bits,
      a.max_steps);
}

template <int CAP>
void launch_mv(const Args& a, cudaStream_t stream) {
  switch (a.mv) {  // 16-byte loads where a neighbor is a whole int4 count
    case 4: launch<CAP, 4>(a, stream); break;
    case 8: launch<CAP, 8>(a, stream); break;
    case 16: launch<CAP, 16>(a, stream); break;
    case 32: launch<CAP, 32>(a, stream); break;
    default: launch<CAP, 0>(a, stream); break;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef <= 64)
    launch_mv<64>(a, s);
  else
    launch_mv<128>(a, s);
  return static_cast<int>(cudaGetLastError());
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
