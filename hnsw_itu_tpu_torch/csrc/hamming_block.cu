// Dense Hamming block on the tensor cores:
// out[p, i, j] = sum_w popcount(a[p, i, w] ^ b[p, j, w]).
//
// Replaces hnsw_itu_tpu/ops/pallas_hamming.py::_hamming_kernel (reached by
// hamming_block and hamming_block_padded): the same function, popcount of
// the XOR of packed sketch words, without the TPU's 128x128 tiling and
// padding. Here any M and N are taken; the ragged edge is guarded instead
// of padded. Contract: bit-exact with its plain PyTorch version,
// hnsw_itu_tpu_torch/ops/hamming.py::hamming_block_plain.
//
// Arithmetic. ham(a, b) = popc(a) + popc(b) - 2 popc(a & b), every term an
// exact integer. Each staged row's popcount is taken once per tile; the
// dot products popc(a & b) run on the tensor cores as mma.sync m16n8k256
// b1 x b1 -> s32 with .and.popc, straight on the packed words: 8 words
// are one k256 slice. A dot product sums over k in any order, so a
// thread's two registers of A and of B take words 2 tig and 2 tig + 1 of
// the slice (tig = lane % 4; one 8-byte shared load each), the same for
// both operands. Zero words (the padding of words to a power of two >= 8)
// add nothing to a dot or a popcount.
//
// What bounds it on an H100: the int32 output it writes, and the b1
// product rate. Bytes (one read of each input, one read when a is b, and
// the output, at 3.35 TB/s) bound it over the bit products at the int8
// tensor rate (2 ops each at 1,979 TOP/s): at the 1M build's select block
// [4096, 96, 96] x 32 words 201.3 MB = 0.060 ms against 0.039 ms; at the
// 10M chunk's [16384, 96, 96] 0.240 against 0.156 ms; at the M=256
// prune's [256, 264, 264] 0.024 against 0.018 ms. About three quarters of
// the bytes are the output. The b1 products are slower than that rate:
// at [16384, 96, 96] the kernel takes 0.325 ms for 4.72M m16n8k256
// products, about 18 clocks of an SM each at 1.98 GHz, so they take
// about as long as the bytes and the two overlap. The design moves
// each byte once and keeps the products fed: a persistent grid walks
// output tiles (p, tile row, tile column) of at most 128 x 128; each
// block stages the next tile's packed rows with cp.async (16 B a thread
// where the rows allow) into a second buffer while it computes the
// current one; a tile that is the whole of a p's block with a == b (every
// select block of the build) stages its rows once for both operands; the
// sums go from the fragments to device memory in 8-byte stores, each four
// lanes writing a whole 32-byte sector, so no shared-memory round trip or
// barrier holds the next tile back.
//
// Measured slower on the card (PERF.md): mma.sync m16n8k32 u8 x u8 on 0/1
// bytes expanded from the words in registers (3.6x slower at
// [16384, 96, 96]: the expansion's integer work bound it), and output
// tiles staged in shared memory and stored 16 B a thread (1.05x slower
// there, 1.8x at [8192, 65536]: the staging buffer cut the blocks an SM
// holds).
//
// Layout: a int32[P, M, words], b int32[P, N, words], out int32[P, M, N],
// all contiguous; 1 <= words <= 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 64;
constexpr int kMaxTile = 128;  // output rows / columns of one tile
constexpr int kWM = 2;         // m16 tiles of a warp's tile (32 rows)
constexpr int kWN = 3;         // n8 tiles of a warp's tile (24 columns)
constexpr int kMaxThreads = 256;

struct Shape {
  int M, N, words;
  int wpad;     // words rounded up to a power of two >= 8 (zero padded)
  int log_u;    // log2 of the staging units of a row
  int ldw;      // staged row stride in words (= 8 mod 32: no bank conflict)
  int TM, TN;   // tile rows (multiple of 16) and columns (multiple of 8)
  int ntm, ntn; // tiles along M and N
  int share;    // a == b and one tile covers the whole block: stage once
  int vec_in;   // rows staged 16 B at a time (words % 4 == 0, aligned)
  int vec_out;  // column pairs stored 8 B at a time (N even, aligned)
};

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
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + rows) of one p (rows beyond `valid` and words
// beyond `words` are zero) into s[rows][ldw] with cp.async.
__device__ __forceinline__ void stage_rows(int* s, const int* src,
                                           int valid, int rows,
                                           const Shape& sh) {
  const int units = rows << sh.log_u;
  const int umask = (1 << sh.log_u) - 1;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = u >> sh.log_u, c = u & umask;
    if (sh.vec_in) {
      const int w = c * 4;
      const bool ok = r < valid && w < sh.words;
      cp_async16(s + r * sh.ldw + w,
                 ok ? src + (size_t)r * sh.words + w : src, ok ? 16 : 0);
    } else {
      const bool ok = r < valid && c < sh.words;
      cp_async4(s + r * sh.ldw + c,
                ok ? src + (size_t)r * sh.words + c : src, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void tile_coords(long long t, const Shape& sh,
                                            int& p, int& tm, int& tn) {
  const long long per_p = (long long)sh.ntm * sh.ntn;
  p = static_cast<int>(t / per_p);
  const int rem = static_cast<int>(t - (long long)p * per_p);
  tm = rem / sh.ntn;
  tn = rem - tm * sh.ntn;
}

__device__ __forceinline__ void stage_tile(int* sA, int* sB, const int* a,
                                           const int* b, long long t,
                                           const Shape& sh) {
  int p, tm, tn;
  tile_coords(t, sh, p, tm, tn);
  const int r0 = tm * sh.TM, c0 = tn * sh.TN;
  stage_rows(sA, a + ((size_t)p * sh.M + r0) * sh.words, sh.M - r0, sh.TM,
             sh);
  if (!sh.share)
    stage_rows(sB, b + ((size_t)p * sh.N + c0) * sh.words, sh.N - c0, sh.TN,
               sh);
}

__global__ void __launch_bounds__(kMaxThreads)
hamming_block_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     int* __restrict__ out, Shape sh, long long tiles) {
  extern __shared__ __align__(16) int smem[];
  const int in_rows = sh.TM + (sh.share ? 0 : sh.TN);
  const int buf_ints = in_rows * sh.ldw;  // two buffers of staged rows
  int* s_pa = smem + 2 * buf_ints;         // [TM] popcounts of A's rows
  int* s_pb = sh.share ? s_pa : s_pa + sh.TM;  // [TN] of B's rows

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wtr = (sh.TM + 16 * kWM - 1) / (16 * kWM);  // warp tile rows
  const int wtc = (sh.TN + 8 * kWN - 1) / (8 * kWN);    // and columns
  const int mtiles = sh.TM / 16, ntiles = sh.TN / 8;

  long long t = blockIdx.x;
  int cur = 0;
  if (t < tiles) stage_tile(smem, smem + sh.TM * sh.ldw, a, b, t, sh);
  cp_async_commit();
  for (; t < tiles; t += gridDim.x) {
    const long long next = t + gridDim.x;
    if (next < tiles) {  // prefetch the next tile into the other buffer
      int* s = smem + (cur ^ 1) * buf_ints;
      stage_tile(s, s + sh.TM * sh.ldw, a, b, next, sh);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's group has landed
    __syncthreads();

    int p, tm, tn;
    tile_coords(t, sh, p, tm, tn);
    const int r0 = tm * sh.TM, c0 = tn * sh.TN;
    const int rows = min(sh.TM, sh.M - r0), cols = min(sh.TN, sh.N - c0);
    int* dst = out + ((size_t)p * sh.M + r0) * sh.N + c0;

    const int* sA = smem + cur * buf_ints;
    const int* sB = sh.share ? sA : sA + sh.TM * sh.ldw;
    // each staged row's popcount, once
    for (int r = threadIdx.x; r < in_rows; r += blockDim.x) {
      const int* row = sA + r * sh.ldw;  // B's rows follow A's
      int c = 0;
      for (int w = 0; w < sh.wpad; w += 4) {
        const int4 v = *reinterpret_cast<const int4*>(row + w);
        c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
      s_pa[r] = c;
    }
    __syncthreads();

    for (int wt = warp; wt < wtr * wtc; wt += nwarps) {
      const int mt0 = (wt / wtc) * kWM, nt0 = (wt % wtc) * kWN;
      int acc[kWM][kWN][4];
#pragma unroll
      for (int i = 0; i < kWM; ++i)
#pragma unroll
        for (int j = 0; j < kWN; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
      // one k256 slice (8 words) a step; a thread's registers take words
      // 2 tig and 2 tig + 1 of the slice, the same for A and B
      for (int w = 0; w < sh.wpad; w += 8) {
        unsigned af[kWM][4], bf[kWN][2];
#pragma unroll
        for (int i = 0; i < kWM; ++i) {
          if (mt0 + i >= mtiles) break;
          const int r = (mt0 + i) * 16 + g;
          const int2 lo = *reinterpret_cast<const int2*>(
              sA + r * sh.ldw + w + 2 * tig);
          const int2 hi = *reinterpret_cast<const int2*>(
              sA + (r + 8) * sh.ldw + w + 2 * tig);
          af[i][0] = lo.x; af[i][1] = hi.x;
          af[i][2] = lo.y; af[i][3] = hi.y;
        }
#pragma unroll
        for (int j = 0; j < kWN; ++j) {
          if (nt0 + j >= ntiles) break;
          const int2 v = *reinterpret_cast<const int2*>(
              sB + ((nt0 + j) * 8 + g) * sh.ldw + w + 2 * tig);
          bf[j][0] = v.x; bf[j][1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < kWM; ++i) {
          if (mt0 + i >= mtiles) break;
#pragma unroll
          for (int j = 0; j < kWN; ++j) {
            if (nt0 + j >= ntiles) break;
            mma_b1(acc[i][j], af[i], bf[j]);
          }
        }
      }
      // popc(a) + popc(b) - 2 dot
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
        if (mt0 + i >= mtiles) break;
        const int r = (mt0 + i) * 16 + g;
#pragma unroll
        for (int j = 0; j < kWN; ++j) {
          if (nt0 + j >= ntiles) break;
          const int c = (nt0 + j) * 8 + 2 * tig;
          const int pb0 = s_pb[c], pb1 = s_pb[c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = r + 8 * h, pa = s_pa[rr];
            const int v0 = pa + pb0 - 2 * acc[i][j][2 * h];
            const int v1 = pa + pb1 - 2 * acc[i][j][2 * h + 1];
            if (rr < rows) {
              int* o = dst + (size_t)rr * sh.N + c;
              if (sh.vec_out && c + 1 < cols) {
                *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
              } else {
                if (c < cols) o[0] = v0;
                if (c + 1 < cols) o[1] = v1;
              }
            }
          }
        }
      }
    }
    // every warp is done with this tile's buffer and popcounts before the
    // next iteration prefetches into the buffer and rewrites them
    __syncthreads();
    cur ^= 1;
  }
}

int g_sms[64];  // SMs of each device, read once

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int hnsw_hamming_block(const void* a, const void* b, void* out, int P, int M,
                       int N, int words, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || words <= 0 || words > kMaxWords)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.M = M; sh.N = N; sh.words = words;
  sh.wpad = 8;
  while (sh.wpad < words) sh.wpad *= 2;
  sh.ldw = sh.wpad;
  while (sh.ldw % 32 != 8) sh.ldw += 8;
  sh.ntm = (M + kMaxTile - 1) / kMaxTile;
  sh.ntn = (N + kMaxTile - 1) / kMaxTile;
  sh.TM = ((M + sh.ntm - 1) / sh.ntm + 15) / 16 * 16;
  sh.TN = ((N + sh.ntn - 1) / sh.ntn + 7) / 8 * 8;
  // one tile over the whole of each block with a == b (the build's select
  // blocks): B's rows are A's, staged once
  sh.share = a == b && M == N && sh.ntm == 1;
  if (sh.share) sh.TN = sh.TM;
  sh.vec_in = words % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(b) % 16 == 0;
  sh.log_u = 0;
  while ((1 << sh.log_u) < (sh.vec_in ? sh.wpad / 4 : sh.wpad)) ++sh.log_u;
  sh.vec_out = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;

  const int in_rows = sh.TM + (sh.share ? 0 : sh.TN);
  const size_t smem = sizeof(int) * ((size_t)2 * in_rows * sh.ldw + in_rows);
  // warps: the count among 8, 6 and 4 that splits the warp tiles evenly
  const int wt = ((sh.TM + 16 * kWM - 1) / (16 * kWM)) *
                 ((sh.TN + 8 * kWN - 1) / (8 * kWN));
  int warps = 8;
  if (wt % 8 != 0) warps = wt % 6 == 0 ? 6 : (wt % 4 == 0 ? 4 : 8);
  if (warps > wt) warps = wt < 1 ? 1 : wt;
  const int threads = warps * 32;

  cudaError_t err = cudaFuncSetAttribute(
      hamming_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0)
    cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_block_kernel,
                                                threads, smem);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (long long)P * sh.ntm * sh.ntn;
  const long long resident = (long long)per_sm * g_sms[dev];
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  hamming_block_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(out), sh, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
