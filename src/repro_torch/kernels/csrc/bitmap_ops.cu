// Packed scope-mask kernels for Hopper (sm_90a): bitmap_patch and
// mask_and_popcount.
//
// Replaces the Pallas TPU kernels src/repro/kernels/bitmap_ops.py::
// bitmap_patch (_patch_kernel) and ::mask_and_popcount (_kernel).
//
// bitmap_patch: row i of an (R, W) uint32 mask matrix becomes m | delta
// where op[i] > 0, m & ~delta where op[i] < 0, and m where op[i] == 0 -- the
// DSM delta patch of the cached scope masks. mask_and_popcount: a & b and
// the total popcount -- the planner's on-device selectivity check.
//
// What bounds them on an H100 SXM: bytes only. The patch reads R*W + W words
// and writes R*W (16 scopes x 60,625 words: ~7.8 MB, ~2.3 us at 3.35 TB/s);
// the popcount reads 2W and writes W words (~0.73 MB, ~0.2 us). At these
// sizes launch latency (a few us) bounds both in practice.
//
// Design: grid-stride loops over words with coalesced 4-byte accesses (the
// patch puts the row on grid.y so no thread divides by W). The popcount
// takes __popc per word, a warp-shuffle + shared-memory block reduction to
// one int per block, and a second one-block pass that sums the block
// partials in a fixed order: integer sums, no atomics, the same count on
// every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
patch_kernel(const uint32_t* __restrict__ masks,
             const uint32_t* __restrict__ delta, const int* __restrict__ ops,
             uint32_t* __restrict__ out, int n_words) {
  const size_t row = blockIdx.y;
  const int op = ops[row];
  const uint32_t* m = masks + row * n_words;
  uint32_t* o = out + row * n_words;
  for (int w = blockIdx.x * kThreads + threadIdx.x; w < n_words;
       w += gridDim.x * kThreads) {
    const uint32_t v = m[w];
    const uint32_t dw = delta[w];
    o[w] = op > 0 ? (v | dw) : (op < 0 ? (v & ~dw) : v);
  }
}

__device__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
and_popc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int n_words,
                int* __restrict__ partials) {
  int count = 0;
  for (int w = blockIdx.x * kThreads + threadIdx.x; w < n_words;
       w += gridDim.x * kThreads) {
    const uint32_t v = a[w] & b[w];
    out[w] = v;
    count += __popc(v);
  }
  const int total = block_sum(count);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
sum_kernel(const int* __restrict__ partials, int n, int* __restrict__ count) {
  int s = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  const int total = block_sum(s);
  if (threadIdx.x == 0) *count = total;
}

}  // namespace

extern "C" {

int repro_bitmap_patch(const uint32_t* masks, const uint32_t* delta,
                       const int* ops, uint32_t* out, int n_rows, int n_words,
                       int grid_x, void* stream) {
  if (n_rows <= 0 || n_words <= 0) return cudaSuccess;
  if (grid_x < 1 || n_rows > 65535) return cudaErrorInvalidValue;
  patch_kernel<<<dim3(grid_x, n_rows), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(masks, delta, ops, out,
                                                      n_words);
  return cudaGetLastError();
}

int repro_mask_and_popcount(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, int n_words, int n_blocks,
                            int* partials, int* count, void* stream) {
  if (n_blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  and_popc_kernel<<<n_blocks, kThreads, 0, s>>>(a, b, out, n_words, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_kernel<<<1, kThreads, 0, s>>>(partials, n_blocks, count);
  return cudaGetLastError();
}

}  // extern "C"
