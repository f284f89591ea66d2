// Dense Hamming block: out[p, i, j] = sum_w popcount(a[p, i, w] ^ b[p, j, w]).
//
// Replaces hnsw_itu_tpu/ops/pallas_hamming.py::_hamming_kernel (reached by
// hamming_block and hamming_block_padded): the same function, popcount of
// the XOR of packed sketch words, without the TPU's 128x128 tiling and
// padding. Here any M and N are taken; the ragged edge is guarded instead
// of padded. Contract: bit-exact with its plain PyTorch version,
// hnsw_itu_tpu_torch/ops/hamming.py::hamming_block_plain.
//
// What bounds it on an H100: the build's blocks are small (96x96 per
// inserted point, 72x72 per pruned row, at 32 words) and many (thousands
// per launch, one per z index of the grid); each output word pair costs an
// XOR, a popcount and an add, and __popc issues at a quarter of the 32-bit
// integer rate. A 32x32 output tile per block, each thread holding 2x2
// outputs, reads each A and B word from shared memory once per pair of
// outputs it feeds; the A tile is stored row-major (a warp reads one
// address per row: a broadcast), the B tile transposed with one word of
// padding per row (a warp reads consecutive banks). Nothing but the
// inputs, read once per tile, and the outputs touch device memory.
//
// Layout: a int32[P, M, words], b int32[P, N, words], out int32[P, M, N],
// all contiguous; words <= 64. gridDim = (ceil(N/32), ceil(M/32),
// min(P, 65535)); a block walks the batch index p in steps of gridDim.z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // outputs per tile side
constexpr int kThreads = 16;   // threads per block side (2x2 outputs each)
constexpr int kMaxWords = 64;

__global__ void __launch_bounds__(kThreads * kThreads)
hamming_block_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     int* __restrict__ out, int P, int M, int N, int words) {
  __shared__ int s_a[kTile][kMaxWords];           // [row][word]
  __shared__ int s_bt[kMaxWords][kTile + 1];      // [word][col], padded

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tile_elems = kTile * words;

  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const int* ap = a + (size_t)p * M * words;
    const int* bp = b + (size_t)p * N * words;
    // stage both tiles: consecutive threads read consecutive words
    for (int t = tid; t < tile_elems; t += kThreads * kThreads) {
      const int r = t / words, w = t - r * words;
      s_a[r][w] = row0 + r < M ? __ldg(ap + (size_t)(row0 + r) * words + w) : 0;
      s_bt[w][r] = col0 + r < N ? __ldg(bp + (size_t)(col0 + r) * words + w) : 0;
    }
    __syncthreads();

    int acc00 = 0, acc01 = 0, acc10 = 0, acc11 = 0;
    for (int w = 0; w < words; ++w) {
      const int a0 = s_a[ty][w], a1 = s_a[ty + kThreads][w];
      const int b0 = s_bt[w][tx], b1 = s_bt[w][tx + kThreads];
      acc00 += __popc(a0 ^ b0);
      acc01 += __popc(a0 ^ b1);
      acc10 += __popc(a1 ^ b0);
      acc11 += __popc(a1 ^ b1);
    }

    int* op = out + (size_t)p * M * N;
    const int r0 = row0 + ty, r1 = r0 + kThreads;
    const int c0 = col0 + tx, c1 = c0 + kThreads;
    if (r0 < M) {
      if (c0 < N) op[(size_t)r0 * N + c0] = acc00;
      if (c1 < N) op[(size_t)r0 * N + c1] = acc01;
    }
    if (r1 < M) {
      if (c0 < N) op[(size_t)r1 * N + c0] = acc10;
      if (c1 < N) op[(size_t)r1 * N + c1] = acc11;
    }
    __syncthreads();  // the next p overwrites the tiles
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int hnsw_hamming_block(const void* a, const void* b, void* out, int P, int M,
                       int N, int words, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || words <= 0 || words > kMaxWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile,
                  P < 65535 ? P : 65535);
  const dim3 block(kThreads, kThreads);
  hamming_block_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(out), P, M, N, words);
  return static_cast<int>(cudaGetLastError());
}

const char* hnsw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
