// The sampled entry in one launch: for every query, the id of the point of
// a strided sample of the dataset at the least Hamming distance, ties to
// the lowest sample position. The sample's ids, its gathered rows, the
// query x sample distances and their argmin never reach device memory;
// only the answer, int32[B], is written.
//
// Replaces no TPU kernel: the JAX package's sampled_entry
// (hnsw_itu_tpu/ops/entry.py) is XLA code, and the port's plain version
// (hnsw_itu_tpu_torch/ops/entry.py sampled_entry_plain) computes the ids,
// gathers the sample, runs Hamming.pairwise_mxu (both sides unpacked to
// float32 0/1 tables, one float32 GEMM, two SWAR popcount terms) and
// argmin: about 50 launches and several [B, S] temporaries a batch.
// Contract: bit-exact with that plain version. id(s) = min((s n) / S,
// n - 1) in 64-bit, as strided_sample_ids computes it (n < S repeats ids);
// ties go to the lowest sample position, torch.argmin's first minimum.
//
// Arithmetic, as kernel #7 (csrc/hamming_block.cu): ham(q, s) = popc(q) +
// popc(s) - 2 popc(q & s), the dot products on the tensor cores as
// mma.sync m16n8k256 b1 x b1 -> s32 with .and.popc on the packed words, 8
// words a k256 slice, a thread's registers on words 2 tig and 2 tig + 1 of
// each slice for both operands; words are zero padded to a multiple of 8.
// The argmin folds each distance into a running minimum of one packed
// 64-bit key per query row, (dist << 32) | pos: the least key is the least
// distance and, among equal ones, the lowest position.
//
// Layout of the work: a block holds 32 queries (two m16 tiles a warp,
// their A fragments in registers for the whole sample) and 4 warps, each
// walking its own share of the sample in chunks of 32 rows (chunks w,
// w + 4, ...). A warp computes the chunk's 32 ids (one lane each), gathers
// the rows into its own shared buffer with cp.async (16 B a thread where
// the rows allow, zero-filled past `words` and past the sample), double
// buffered, and waits only on its own copies (__syncwarp, no block
// barrier). Each staged row's popcount is taken once a chunk; the four
// n8 tiles of a chunk run as 8 independent mma chains. At the end the
// keys are reduced over the 4 lanes of a quad, then across the 4 warps
// through shared memory, and the winning position's id is written.
//
// What bounds it on an H100: the b1 products. At the 1M cell (B = 10,000,
// S = 1024, 32 words) the bytes are 10,000 x 128 B + 1024 x 128 B + 40 KB
// = 1.45 MB, 0.4 us at 3.35 TB/s, against (B/16)(S/8)(words/8) = 625 x
// 128 x 4 = 320,000 m16n8k256 products; at the rate kernel #7 showed
// (about 18 SM clocks each at 1.98 GHz over 132 SMs) that is 0.022 ms
// (8192 queries: 0.018 ms). The grid has ceil(B / 32) blocks of 4 warps
// (313 at the 1M cell), so every SM sub-partition's tensor core gets work;
// each block reads the whole sample (128 KB at 32 words) from L2.
//
// Layout: points int32[cap, words] (rows [0, n) are the dataset), queries
// int32[B, words], out int32[B]; all contiguous; 1 <= words <= 64,
// 1 <= n <= cap, 1 <= S <= 2^30.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 64;
constexpr int kMaxSample = 1 << 30;
constexpr int kWarps = 4;         // warps a block, each on its own chunks
constexpr int kWM = 2;            // m16 query tiles a warp
constexpr int kRows = 16 * kWM;   // queries a block
constexpr int kChunk = 32;        // sample rows a warp stages at a time
constexpr int kNT = kChunk / 8;   // n8 tiles a chunk
constexpr unsigned kFull = 0xffffffffu;

// staged row stride in words: >= 8 KS and = 8 mod 32, so the 8-byte
// fragment loads of a half warp hit 16 distinct bank pairs
__host__ __device__ constexpr int row_stride(int ks) {
  int ldw = 8 * ks;
  while (ldw % 32 != 8) ldw += 8;
  return ldw;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// d += popc(a & b): m16n8k256 over packed bits
__device__ __forceinline__ void mma_b1(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the id of sample position pos: min((pos n) / S, n - 1), in 64-bit
__device__ __forceinline__ int sample_id(int pos, int n, int S) {
  const long long v = static_cast<long long>(pos) * n / S;
  return v < n - 1 ? static_cast<int>(v) : n - 1;
}

// Gather the sample rows of chunk c into s[kChunk][ldw]: lane l computes
// the id of row l, and the warp copies the rows unit by unit (16 B, or
// 4 B when the rows are not 16-byte aligned), consecutive lanes on
// consecutive units of a row.
template <int KS>
__device__ __forceinline__ void stage_chunk(int* s, const int* points,
                                            int words, int n, int S, int c,
                                            bool vec, int lane) {
  constexpr int kLdw = row_stride(KS);
  const int pos = c * kChunk + lane;
  const int id = pos < S ? sample_id(pos, n, S) : -1;
  if (vec) {
    constexpr int kUnits = 2 * KS;  // 16-byte units of a padded row
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = k * 32 + lane;
      const int r = u / kUnits, w = (u % kUnits) * 4;
      const int rid = __shfl_sync(kFull, id, r);
      const bool ok = rid >= 0 && w < words;
      cp_async16(s + r * kLdw + w,
                 ok ? points + (size_t)rid * words + w : points, ok ? 16 : 0);
    }
  } else {
    constexpr int kUnits = 8 * KS;  // words of a padded row
#pragma unroll 4
    for (int k = 0; k < kUnits; ++k) {
      const int u = k * 32 + lane;
      const int r = u / kUnits, w = u % kUnits;
      const int rid = __shfl_sync(kFull, id, r);
      const bool ok = rid >= 0 && w < words;
      cp_async4(s + r * kLdw + w,
                ok ? points + (size_t)rid * words + w : points, ok ? 4 : 0);
    }
  }
}

using Key = unsigned long long;  // (dist << 32) | pos

__device__ __forceinline__ Key key_min(Key a, Key b) {
  return b < a ? b : a;
}

template <int KS>
__global__ void __launch_bounds__(kWarps * 32)
sampled_entry_kernel(const int* __restrict__ points, int words,
                     const int* __restrict__ queries, int B, int n, int S,
                     int vec, int* __restrict__ out) {
  constexpr int kLdw = row_stride(KS);
  extern __shared__ __align__(16) int smem[];  // [kWarps][2][kChunk][kLdw]
  __shared__ Key s_best[kWarps][kRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  int* const sw = smem + warp * 2 * kChunk * kLdw;

  // this warp's queries: A fragments and popcounts of rows g and g + 8 of
  // each m16 tile (words past `words` and rows past B are zero)
  unsigned af[kWM][KS][4];
  int pa[kWM][2];
#pragma unroll
  for (int i = 0; i < kWM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * i + 8 * h + g;
      const int* qr = queries + (size_t)row * words;
      int pc = 0;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int w = 8 * k + 2 * tig;
        const unsigned x = row < B && w < words ? __ldg(qr + w) : 0;
        const unsigned y = row < B && w + 1 < words ? __ldg(qr + w + 1) : 0;
        af[i][k][h] = x;
        af[i][k][2 + h] = y;
        pc += __popc(x) + __popc(y);
      }
      pc += __shfl_xor_sync(kFull, pc, 1);
      pc += __shfl_xor_sync(kFull, pc, 2);
      pa[i][h] = pc;
    }
  }

  const Key kNone = ~0ull;
  Key best[kWM][2];
#pragma unroll
  for (int i = 0; i < kWM; ++i) best[i][0] = best[i][1] = kNone;

  const int chunks = (S + kChunk - 1) / kChunk;
  int buf = 0;
  if (warp < chunks)
    stage_chunk<KS>(sw, points, words, n, S, warp, vec, lane);
  cp_async_commit();
  for (int c = warp; c < chunks; c += kWarps) {
    if (c + kWarps < chunks)  // the next chunk into the other buffer
      stage_chunk<KS>(sw + (buf ^ 1) * kChunk * kLdw, points, words, n, S,
                      c + kWarps, vec, lane);
    cp_async_commit();
    cp_async_wait_one();  // this chunk's copies have landed
    __syncwarp();
    const int* s = sw + buf * kChunk * kLdw;

    // the popcount of staged row `lane`, once
    int pb = 0;
#pragma unroll
    for (int w = 0; w < 8 * KS; w += 4) {
      const int4 v = *reinterpret_cast<const int4*>(s + lane * kLdw + w);
      pb += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }

    int acc[kWM][kNT][4];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int2 v = *reinterpret_cast<const int2*>(
            s + (8 * t + g) * kLdw + 8 * k + 2 * tig);
#pragma unroll
        for (int i = 0; i < kWM; ++i)
          mma_b1(acc[i][t], af[i][k], static_cast<unsigned>(v.x),
                 static_cast<unsigned>(v.y));
      }
    }

    // popc(q) + popc(s) - 2 dot, folded into the running keys; this
    // thread holds columns 2 tig and 2 tig + 1 of each n8 tile
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * t + 2 * tig + e;
        const int pbc = __shfl_sync(kFull, pb, col);
        const int pos = c * kChunk + col;
        if (pos < S) {
#pragma unroll
          for (int i = 0; i < kWM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int d = pa[i][h] + pbc - 2 * acc[i][t][2 * h + e];
              best[i][h] = key_min(
                  best[i][h], static_cast<Key>(d) << 32 | pos);
            }
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
  }

  // the least key of each row: over the quad, then over the warps
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Key b = best[i][h];
      b = key_min(b, __shfl_xor_sync(kFull, b, 1));
      b = key_min(b, __shfl_xor_sync(kFull, b, 2));
      if (tig == 0) s_best[warp][16 * i + 8 * h + g] = b;
    }
  __syncthreads();
  if (threadIdx.x < kRows && q0 + threadIdx.x < B) {
    Key b = s_best[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) b = key_min(b, s_best[w][threadIdx.x]);
    out[q0 + threadIdx.x] =
        sample_id(static_cast<int>(b & 0xffffffffu), n, S);
  }
}

template <int KS>
int launch(const int* points, int words, const int* queries, int B, int n,
           int S, int vec, int* out, cudaStream_t stream) {
  const auto kernel = sampled_entry_kernel<KS>;
  const int smem = kWarps * 2 * kChunk * row_stride(KS) * sizeof(int);
  if (smem > 40 * 1024) {  // past the 48 KB default with the static keys
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + kRows - 1) / kRows, kWarps * 32, smem, stream>>>(
      points, words, queries, B, n, S, vec, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// points int32[cap, words], queries int32[B, words], out int32[B]; all
// contiguous. out[b] = the id of the sample point nearest queries[b].
int hnsw_sampled_entry(const void* points, int cap, int words,
                       const void* queries, int B, int n, int S, void* out,
                       void* stream) {
  if (B <= 0 || words <= 0 || words > kMaxWords || n <= 0 || n > cap ||
      S <= 0 || S > kMaxSample)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = words % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const auto p = static_cast<const int*>(points);
  const auto q = static_cast<const int*>(queries);
  const auto o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((words + 7) / 8) {
    case 1: return launch<1>(p, words, q, B, n, S, vec, o, s);
    case 2: return launch<2>(p, words, q, B, n, S, vec, o, s);
    case 3: return launch<3>(p, words, q, B, n, S, vec, o, s);
    case 4: return launch<4>(p, words, q, B, n, S, vec, o, s);
    case 5: return launch<5>(p, words, q, B, n, S, vec, o, s);
    case 6: return launch<6>(p, words, q, B, n, S, vec, o, s);
    case 7: return launch<7>(p, words, q, B, n, S, vec, o, s);
    default: return launch<8>(p, words, q, B, n, S, vec, o, s);
  }
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
