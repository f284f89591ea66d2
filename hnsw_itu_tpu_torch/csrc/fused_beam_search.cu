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
// What bounds it on an H100: latency, not bandwidth. Each expansion reads
// one node's fused row, W neighbor ids plus up to W 128-byte sketches
// (8.4 KB at W=64, words=32 when the row is full), from anywhere in a
// table far larger than the 50 MB L2, and the next expansion depends on
// it; the arithmetic per byte is one XOR and one popcount. Measured on an
// H100 80GB HBM3 (700 W) at 100k points, 10k queries, ef=32: the kernel
// requests about 1.2 TB/s, a third of HBM's rate, and at a fixed number
// of expansions its time grows with ef (ef 32 -> 128: 1.9x), so the
// dependent row reads and the per-step dedup and rank loops in shared
// memory (O(W * (ef + W)) compares per warp) set its time. The design keeps
// every lane's loads independent (up to 2 x 8 sixteen-byte loads in
// flight per step) and keeps the beam, the candidates and the query in
// shared memory, so nothing but the row reads and the final keys touches
// device memory. There is no matrix product here, so wgmma does not
// apply; TMA or cp.async prefetch of the next row, and a sorted-candidate
// merge in registers, are left for later changes.
//
// Layout (hnsw_itu_tpu_torch/ops/fused_search.py):
//   ids  int32[cap, W]          neighbor ids of node e, -1 = no edge
//   data int32[cap, W, WORDS]   sketch of neighbor j of node e
// Keys: key = (min(d, dclamp) << id_bits) | id; key_inf = (dclamp + 1)
// << id_bits marks an empty slot. Beam keys are unique except key_inf.
//
// Per step, for one query (warp-synchronous, no block barrier):
//  1. frontier: the first beam slot that is unexpanded, < key_inf and
//     <= beam[ef-1] (the beam is sorted, so this is the best unexpanded
//     key); none -> the query is done;
//  2. each lane takes neighbors j = lane, lane+32, ... of the expanded
//     node: XOR + __popc over the sketch, clamp, pack the key;
//  3. a candidate equal to a beam key or to an earlier candidate is a
//     duplicate; the rest are fresh and counted into `visited`;
//  4. rank merge: beam key i moves to i + #(fresh < key), fresh key c to
//     #(beam < c) + #(fresh < c); positions >= ef fall out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEf = 128;
constexpr int kMaxW = 128;
constexpr int kSlots = kMaxW / 32;  // candidates per lane at most
constexpr int kWarps = 4;           // queries per block
constexpr unsigned kFull = 0xffffffffu;

template <int WORDS>
__global__ void __launch_bounds__(kWarps * 32)
fused_beam_search_kernel(const int* __restrict__ queries,
                         const int* __restrict__ init_keys,
                         const int* __restrict__ ids,
                         const int* __restrict__ data,
                         int* __restrict__ out_keys,
                         int* __restrict__ out_visited,
                         int* __restrict__ out_steps,
                         int B, int cap, int W, int ef, int id_bits,
                         int key_inf, int max_steps) {
  __shared__ int s_bk[kWarps][kMaxEf];  // beam keys, ascending
  __shared__ int s_bf[kWarps][kMaxEf];  // expanded flags
  __shared__ int s_nk[kWarps][kMaxEf];  // merged beam keys
  __shared__ int s_nf[kWarps][kMaxEf];  // merged flags
  __shared__ int s_ck[kWarps][kMaxW];   // candidate keys
  __shared__ __align__(16) int s_q[kWarps][WORDS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  int* bk = s_bk[warp];
  int* bf = s_bf[warp];
  int* nk = s_nk[warp];
  int* nf = s_nf[warp];
  int* ck = s_ck[warp];
  const int mask = (1 << id_bits) - 1;
  const int dclamp = (key_inf >> id_bits) - 1;

  for (int i = lane; i < WORDS; i += 32) s_q[warp][i] = queries[(size_t)b * WORDS + i];
  for (int i = lane; i < ef; i += 32) {
    bk[i] = i == 0 ? init_keys[b] : key_inf;
    bf[i] = 0;
  }
  __syncwarp();
  const int4* q4 = reinterpret_cast<const int4*>(s_q[warp]);

  int visited = 1;
  int steps = 0;
  while (steps < max_steps) {
    // 1. frontier
    const int worst = bk[ef - 1];
    int pos = -1;
    for (int base = 0; base < ef; base += 32) {
      const int i = base + lane;
      const bool open = i < ef && !bf[i] && bk[i] < key_inf && bk[i] <= worst;
      const unsigned m = __ballot_sync(kFull, open);
      if (m) {
        pos = base + __ffs(m) - 1;
        break;
      }
    }
    if (pos < 0) break;
    ++steps;
    const int e = min(bk[pos] & mask, cap - 1);
    __syncwarp();
    if (lane == 0) bf[pos] = 1;

    // 2. candidate keys
    const int* row_ids = ids + (size_t)e * W;
    const int4* row = reinterpret_cast<const int4*>(data + (size_t)e * W * WORDS);
    int key[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      key[s] = key_inf;
      if (j < W) {
        const int nbr = __ldg(row_ids + j);
        if (nbr >= 0) {
          const int4* p = row + (size_t)j * (WORDS / 4);
          int d = 0;
#pragma unroll
          for (int w = 0; w < WORDS / 4; ++w) {
            const int4 v = __ldg(p + w);
            const int4 q = q4[w];
            d += __popc(v.x ^ q.x) + __popc(v.y ^ q.y) + __popc(v.z ^ q.z) +
                 __popc(v.w ^ q.w);
          }
          key[s] = (min(d, dclamp) << id_bits) | nbr;
        }
        ck[j] = key[s];
      }
    }
    __syncwarp();

    // 3. dedup against the beam and against earlier candidates
    int fresh_total = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = s * 32 + lane;
      bool fresh = j < W && key[s] < key_inf;
      for (int i = 0; fresh && i < ef; ++i) fresh = bk[i] != key[s];
      for (int i = 0; fresh && i < j; ++i) fresh = ck[i] != key[s];
      if (!fresh) key[s] = key_inf;
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
      const int k = bk[i];
      int p = i;
      for (int j = 0; j < W; ++j) p += ck[j] < k;
      if (p < ef) {
        nk[p] = k;
        nf[p] = bf[i];
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = key[s];
      if (c < key_inf) {
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

template <int WORDS>
void launch(const void* queries, const void* init_keys, const void* ids,
            const void* data, void* out_keys, void* out_visited,
            void* out_steps, int B, int cap, int W, int ef, int id_bits,
            int key_inf, int max_steps, cudaStream_t stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  fused_beam_search_kernel<WORDS><<<grid, block, 0, stream>>>(
      static_cast<const int*>(queries), static_cast<const int*>(init_keys),
      static_cast<const int*>(ids), static_cast<const int*>(data),
      static_cast<int*>(out_keys), static_cast<int*>(out_visited),
      static_cast<int*>(out_steps), B, cap, W, ef, id_bits, key_inf,
      max_steps);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int hnsw_fused_beam_search(const void* queries, const void* init_keys,
                           const void* ids, const void* data, void* out_keys,
                           void* out_visited, void* out_steps, int B, int cap,
                           int W, int words, int ef, int id_bits, int key_inf,
                           int max_steps, void* stream) {
  if (B <= 0 || cap <= 0 || W <= 0 || W > kMaxW || ef <= 0 || ef > kMaxEf ||
      id_bits < 1 || id_bits > 30 || max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 8:
      launch<8>(queries, init_keys, ids, data, out_keys, out_visited, out_steps,
                B, cap, W, ef, id_bits, key_inf, max_steps, s);
      break;
    case 16:
      launch<16>(queries, init_keys, ids, data, out_keys, out_visited,
                 out_steps, B, cap, W, ef, id_bits, key_inf, max_steps, s);
      break;
    case 32:
      launch<32>(queries, init_keys, ids, data, out_keys, out_visited,
                 out_steps, B, cap, W, ef, id_bits, key_inf, max_steps, s);
      break;
    case 64:
      launch<64>(queries, init_keys, ids, data, out_keys, out_visited,
                 out_steps, B, cap, W, ef, id_bits, key_inf, max_steps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
