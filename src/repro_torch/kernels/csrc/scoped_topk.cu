// Masked fp32 scan + top-k for Hopper (sm_90a): scoped_topk and multi_scope_topk.
//
// Replaces the Pallas TPU kernels src/repro/kernels/scoped_topk.py::scoped_topk
// (_kernel + _merge_topk) and ::multi_scope_topk (_multi_kernel).
//
// What it computes: for every query q and every row x that the query's mask
// admits, score = q.x (ip/cos) or 2 q.x - ||x||^2 (l2), and keeps the k best
// per query ranked by (score descending, id ascending) -- the tie rule of
// jax.lax.top_k. Empty lanes are (-FLT_MAX, -1) == (finfo(float32).min, -1).
//
// What bounds it on an H100 SXM: the rows are read once from HBM (n*d*4
// bytes) and every (query, row) pair costs d FMAs. At the main path's shapes
// (n = 1.94M, d = 128) one query is bound by bytes (~0.30 ms at 3.35 TB/s);
// 64 queries do 31.8 GFLOP, bound by the fp32 rate (~0.47 ms at 67 TFLOP/s).
// The (q, n) score matrix is never written to device memory -- the point of
// the TPU kernel, kept here.
//
// Design. The TPU's sequential n-sweep with a running top-k in VMEM scratch
// does not carry over: Hopper blocks run in parallel and in no order. So:
//   pass 1: grid (query tiles of <= 8, row chunks). A block stages its query
//           tile in shared memory and sweeps its chunk 256 rows at a time:
//           each thread scores one row against the whole tile (one
//           fixed-order fp32 FMA chain over d, so a score's bits do not
//           depend on the tile, the chunking or the entry point), rows no
//           query of the tile admits are skipped, and warp j merges query j's
//           256 scores into its sorted top-k list in shared memory. The block
//           writes its lists as (q, n_chunks, k) partials.
//   pass 2: one warp per query merges the partials into the final top-k.
// Both entry points share the scoring loop and the merge; they differ only
// in where the mask bit comes from (a dense int8 mask, or bit r%32 of word
// r/32 of the query's row of a packed (n_scopes, n_words) matrix). The
// result is the exact top-k under a total order, so it is the same whatever
// the chunking, and no atomics are used: runs are bit-for-bit repeatable.
// Rows are read per thread (one row per thread, float4 loads); the 8 query
// tiles of a chunk are adjacent in launch order, so most re-reads of a chunk
// hit L2. Making the scan reach its bound (staging rows through shared
// memory, tensor-core-free register tiling) is left for a later change.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // = the largest query tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 256;
constexpr int kSlots = kMaxK / 32;        // list entries one lane shifts
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Offer one candidate per lane (``ok`` marks lanes that hold one) to the
// warp's sorted list (lv, li) of length k, in lane order. The list lives in
// shared memory and is owned by the calling warp alone.
__device__ void warp_offer(float* lv, int* li, int k, float cv, int ci,
                           bool ok) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  unsigned want =
      __ballot_sync(0xffffffffu, ok && better(cv, ci, lv[k - 1], li[k - 1]));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float v = __shfl_sync(0xffffffffu, cv, src);
    const int id = __shfl_sync(0xffffffffu, ci, src);
    if (!better(v, id, lv[k - 1], li[k - 1])) continue;  // warp-uniform
    int pos = 0;
    for (int j = lane; j < k; j += 32) pos += better(lv[j], li[j], v, id);
#pragma unroll
    for (int o = 16; o; o >>= 1) pos += __shfl_xor_sync(0xffffffffu, pos, o);
    // shift [pos, k-2] one place down, then write the candidate at pos
    float sv[kSlots];
    int si[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (j > pos && j < k) {
        sv[t] = lv[j - 1];
        si[t] = li[j - 1];
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (j > pos && j < k) {
        lv[j] = sv[t];
        li[j] = si[t];
      } else if (j == pos) {
        lv[j] = v;
        li[j] = id;
      }
    }
    __syncwarp();
  }
}

template <bool kWords, bool kL2, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_pass1(const float* __restrict__ q, const float* __restrict__ rows,
           const float* __restrict__ sq, const int8_t* __restrict__ mask,
           const uint32_t* __restrict__ words, const int* __restrict__ sids,
           int n_scopes, int n_words, int nq, int n, int d, int k, int qt,
           int chunk_rows, float* __restrict__ part_v,
           int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qs = smem;                          // qt * d   query tile
  float* sv = qs + qt * d;                   // qt * 256 scores of one sweep
  float* lv = sv + qt * kThreads;            // qt * k   top-k values
  int* li = reinterpret_cast<int*>(lv + qt * k);  // qt * k top-k ids
  int* tile_sid = li + qt * k;               // qt       scope rows

  const int q0 = blockIdx.x * qt;
  const int nqt = min(qt, nq - q0);
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < nqt * d; i += kThreads)
    qs[i] = q[static_cast<size_t>(q0) * d + i];
  for (int i = threadIdx.x; i < qt * k; i += kThreads) {
    lv[i] = kNegInf;
    li[i] = -1;
  }
  if (kWords && threadIdx.x < nqt) tile_sid[threadIdx.x] = sids[q0 + threadIdx.x];
  __syncthreads();

  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    unsigned admit = 0;                      // bit j: query j admits row r
    if (r < r_end) {
      if (kWords) {
        for (int j = 0; j < nqt; ++j) {
          const int s = tile_sid[j];
          if (s >= 0 && s < n_scopes) {
            const uint32_t w =
                words[static_cast<size_t>(s) * n_words + (r >> 5)];
            admit |= ((w >> (r & 31)) & 1u) << j;
          }
        }
      } else if (mask[r]) {
        admit = (1u << nqt) - 1u;
      }
    }
    float acc[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) acc[j] = 0.0f;
    if (admit) {
      const float* x = rows + static_cast<size_t>(r) * d;
      if (kVec) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (int c = 0; c < d; c += 4) {
          const float4 xv = __ldg(x4 + (c >> 2));
#pragma unroll
          for (int j = 0; j < kWarps; ++j) {
            if (j < nqt) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + j * d + c);
              acc[j] = fmaf(qv.x, xv.x, acc[j]);
              acc[j] = fmaf(qv.y, xv.y, acc[j]);
              acc[j] = fmaf(qv.z, xv.z, acc[j]);
              acc[j] = fmaf(qv.w, xv.w, acc[j]);
            }
          }
        }
      } else {
        for (int c = 0; c < d; ++c) {
          const float xv = __ldg(x + c);
#pragma unroll
          for (int j = 0; j < kWarps; ++j)
            if (j < nqt) acc[j] = fmaf(qs[j * d + c], xv, acc[j]);
        }
      }
    }
    const float sqr = (kL2 && admit) ? sq[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < nqt) {
        float s = kNegInf;
        if ((admit >> j) & 1u) s = kL2 ? 2.0f * acc[j] - sqr : acc[j];
        sv[j * kThreads + threadIdx.x] = s;
      }
    }
    __syncthreads();
    if (warp < nqt) {
      float* wl = lv + warp * k;
      int* wi = li + warp * k;
      for (int t = 0; t < kThreads; t += 32) {
        const int row = base + t + lane;
        const float v = sv[warp * kThreads + t + lane];
        warp_offer(wl, wi, k, v, row, row < r_end && v > kNegInf);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nqt * k; i += kThreads) {
    const int j = i / k;
    const int s = i - j * k;
    const size_t o =
        (static_cast<size_t>(q0 + j) * gridDim.y + chunk) * k + s;
    part_v[o] = lv[j * k + s];
    part_i[o] = li[j * k + s];
  }
}

// One warp per query: merge the (n_chunks, k) partial lists.
__global__ void __launch_bounds__(32)
scan_pass2(const float* __restrict__ part_v, const int* __restrict__ part_i,
           int n_chunks, int k, float* __restrict__ out_v,
           int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* lv = smem;
  int* li = reinterpret_cast<int*>(lv + k);
  const int lane = threadIdx.x;
  const size_t qi = blockIdx.x;
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = -1;
  }
  const int total = n_chunks * k;
  const float* pv = part_v + qi * total;
  const int* pi = part_i + qi * total;
  for (int t = 0; t < total; t += 32) {
    const int idx = t + lane;
    const bool in = idx < total;
    const float v = in ? pv[idx] : kNegInf;
    const int id = in ? pi[idx] : -1;
    warp_offer(lv, li, k, v, id, in && id >= 0);
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    out_v[qi * k + j] = lv[j];
    out_i[qi * k + j] = li[j];
  }
}

template <bool kWords, bool kL2, bool kVec>
cudaError_t launch_pass1(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* q, const float* rows, const float* sq,
                         const int8_t* mask, const uint32_t* words,
                         const int* sids, int n_scopes, int n_words, int nq,
                         int n, int d, int k, int qt, int chunk_rows,
                         float* part_v, int* part_i) {
  auto kern = scan_pass1<kWords, kL2, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(q, rows, sq, mask, words, sids,
                                         n_scopes, n_words, nq, n, d, k, qt,
                                         chunk_rows, part_v, part_i);
  return cudaGetLastError();
}

template <bool kWords>
cudaError_t dispatch_pass1(int l2, dim3 grid, size_t smem,
                           cudaStream_t stream, const float* q,
                           const float* rows, const float* sq,
                           const int8_t* mask, const uint32_t* words,
                           const int* sids, int n_scopes, int n_words, int nq,
                           int n, int d, int k, int qt, int chunk_rows,
                           float* part_v, int* part_i) {
  const bool vec = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
#define REPRO_PASS1(L2, VEC)                                                  \
  return launch_pass1<kWords, L2, VEC>(grid, smem, stream, q, rows, sq, mask, \
                                       words, sids, n_scopes, n_words, nq, n, \
                                       d, k, qt, chunk_rows, part_v, part_i)
  if (l2) {
    if (vec) REPRO_PASS1(true, true);
    REPRO_PASS1(true, false);
  }
  if (vec) REPRO_PASS1(false, true);
  REPRO_PASS1(false, false);
#undef REPRO_PASS1
}

template <bool kWords>
int scan_topk(const float* q, const float* rows, const float* sq,
              const int8_t* mask, const uint32_t* words, const int* sids,
              int n_scopes, int n_words, int nq, int n, int d, int k, int l2,
              int qt, int chunk_rows, int n_chunks, float* part_v,
              int* part_i, float* out_v, int* out_i, void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (k < 1 || k > kMaxK || qt < 1 || qt > kWarps || chunk_rows < 1 ||
      n_chunks < 1 || d < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem1 =
      sizeof(float) * (static_cast<size_t>(qt) * d + qt * kThreads +
                       2 * static_cast<size_t>(qt) * k + qt);
  const dim3 grid1((nq + qt - 1) / qt, n_chunks);
  cudaError_t err = dispatch_pass1<kWords>(
      l2, grid1, smem1, stream, q, rows, sq, mask, words, sids, n_scopes,
      n_words, nq, n, d, k, qt, chunk_rows, part_v, part_i);
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * 2 * static_cast<size_t>(k);
  scan_pass2<<<nq, 32, smem2, stream>>>(part_v, part_i, n_chunks, k, out_v,
                                        out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dense (n,) int8 mask shared by every query.
int repro_scoped_topk_f32(const float* q, const float* rows, const float* sq,
                          const int8_t* mask, int nq, int n, int d, int k,
                          int l2, int qt, int chunk_rows, int n_chunks,
                          float* part_v, int* part_i, float* out_v,
                          int* out_i, void* stream) {
  return scan_topk<false>(q, rows, sq, mask, nullptr, nullptr, 0, 0, nq, n,
                          d, k, l2, qt, chunk_rows, n_chunks, part_v, part_i,
                          out_v, out_i, stream);
}

// Packed (n_scopes, n_words) uint32 masks, one scope row per query.
int repro_multi_scope_topk_f32(const float* q, const float* rows,
                               const float* sq, const uint32_t* words,
                               const int* sids, int n_scopes, int n_words,
                               int nq, int n, int d, int k, int l2, int qt,
                               int chunk_rows, int n_chunks, float* part_v,
                               int* part_i, float* out_v, int* out_i,
                               void* stream) {
  return scan_topk<true>(q, rows, sq, nullptr, words, sids, n_scopes,
                         n_words, nq, n, d, k, l2, qt, chunk_rows, n_chunks,
                         part_v, part_i, out_v, out_i, stream);
}

}  // extern "C"
