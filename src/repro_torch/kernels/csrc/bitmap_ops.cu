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
// Design: the patch is a grid-stride loop over words with coalesced
// 4-byte accesses (the row on grid.y, so no thread divides by W). The
// popcount is one launch of one thread-block cluster of kPopBlocks blocks
// of kPopThreads: a grid-stride loop of 16-byte words where a, b and out
// all start 16-byte aligned, else 4-byte words, each thread keeping up to
// kPopU words' loads in flight, __popc per word, a shuffle + shared-memory
// reduction per block. Each block then sends its total into block rank
// 0's shared memory with st.async (distributed shared memory, after a
// split cluster barrier whose arrive at the start says every block has
// begun), which completes bytes on an mbarrier there; rank 0 alone waits
// on it and adds the totals in rank order, and the others exit. Integer
// sums in a fixed order: no atomics and no ticket in device memory, so the
// count is the same on every run and callers on other streams cannot
// race; no scratch, one launch. (tools/scan_variants.py "popc_*" on the
// H100 at W = 60,625: 8 blocks of 1,024 threads with two cluster barriers
// 3.3 us, 16 of 512 2.9 us, 16 of 512 with the mbarrier 2.4 us, against
// 2.7 us for the first version's two launches, a block reduction then a
// one-block sum.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPopBlocks = 16;      // one cluster (past the portable 8)
constexpr int kPopThreads = 512;
constexpr int kPopU = 4;            // words in flight per thread

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

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// the sum of ``v`` over the block, in thread 0
__device__ int block_sum(int v) {
  __shared__ int warp_sums[kPopThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kPopThreads / 32; ++i) total += warp_sums[i];
  return total;
}

// out = a & b over ``n`` words of type W (uint4 or uint32_t): this
// thread's share of the cluster's grid-stride loop; returns its popcount
template <typename W>
__device__ int and_popc_range(const W* __restrict__ a,
                              const W* __restrict__ b, W* __restrict__ out,
                              int n) {
  constexpr int kStride = kPopBlocks * kPopThreads;
  int count = 0;
  for (int w0 = blockIdx.x * kPopThreads + threadIdx.x; w0 < n;
       w0 += kPopU * kStride) {
    W x[kPopU], y[kPopU];
#pragma unroll
    for (int u = 0; u < kPopU; ++u) {
      const int w = w0 + u * kStride;
      if (w < n) {
        x[u] = a[w];
        y[u] = b[w];
      }
    }
#pragma unroll
    for (int u = 0; u < kPopU; ++u) {
      const int w = w0 + u * kStride;
      if (w < n) {
        if constexpr (sizeof(W) == 16) {
          const uint4 v = make_uint4(x[u].x & y[u].x, x[u].y & y[u].y,
                                     x[u].z & y[u].z, x[u].w & y[u].w);
          out[w] = v;
          count += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        } else {
          const uint32_t v = x[u] & y[u];
          out[w] = v;
          count += __popc(v);
        }
      }
    }
  }
  return count;
}

__global__ void __launch_bounds__(kPopThreads)
    and_popc_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, int n_words,
                    int* __restrict__ count) {
  __shared__ int totals[kPopBlocks];    // rank 0's: each block's count
  __shared__ __align__(8) unsigned long long landed;   // rank 0's: totals in
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned bar = smem_addr(&landed);
  if (rank == 0 && threadIdx.x == 0) {  // expect kPopBlocks totals' bytes
    unsigned long long state;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
                 : "=l"(state)
                 : "r"(bar), "r"(4 * kPopBlocks)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // announce this block's start (and rank 0's barrier); the wait, before
  // the first remote store, overlaps the loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  int c = 0;
  int head = 0;                 // the first word past the 16-byte ones
  if (vec) {
    c = and_popc_range(reinterpret_cast<const uint4*>(a),
                       reinterpret_cast<const uint4*>(b),
                       reinterpret_cast<uint4*>(out), n_words / 4);
    head = n_words / 4 * 4;
  }
  c += and_popc_range(a + head, b + head, out + head, n_words - head);
  const int total = block_sum(c);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  if (threadIdx.x == 0) {       // into rank 0's totals[rank], on its barrier
    unsigned dst, dst_bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(dst)
                 : "r"(smem_addr(totals + rank)));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(dst_bar)
                 : "r"(bar));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
        "[%2];\n" ::"r"(dst),
        "r"(total), "r"(dst_bar)
        : "memory");
  }
  if (rank == 0 && threadIdx.x == 0) {  // the others exit
    asm volatile(
        "{\n .reg .pred p;\n WAIT%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        " @!p bra WAIT%=;\n}\n" ::"r"(bar)
        : "memory");
    int sum = 0;
    for (int r = 0; r < kPopBlocks; ++r) sum += totals[r];
    *count = sum;
  }
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

// a & b over ``n_words`` >= 0 words into ``out`` and the total popcount
// into ``count``: one launch of one cluster of kPopBlocks blocks
int repro_mask_and_popcount(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, int n_words, int* count,
                            void* stream) {
  if (n_words < 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(   // past the portable 8
      and_popc_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kPopBlocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPopBlocks);
  cfg.blockDim = dim3(kPopThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, and_popc_kernel, a, b, out, n_words, count);
}

}  // extern "C"
