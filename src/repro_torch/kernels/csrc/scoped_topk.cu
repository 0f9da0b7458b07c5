// Masked scan + top-k for Hopper (sm_90a): the fp32, int8 and PQ scans, and
// the IVF executor's gathered scans.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/scoped_topk.py:
//   scoped_topk (_kernel + _merge_topk)   multi_scope_topk (_multi_kernel)
//   scoped_topk_i8 (_kernel_i8)           multi_scope_topk_i8 (_multi_kernel_i8)
//   scoped_topk_pq (_kernel_pq)           multi_scope_topk_pq (_multi_kernel_pq)
//   ivf_gather_topk (_ivf_kernel)
// (the PQ pair with _adc_tile_scores), and the IVF executor's int8 and PQ
// jnp twins of src/repro/vectordb/ivf.py (_ivf_batch_i8, _ivf_batch_pq).
//
// What it computes: for every query q and every row r that the query's mask
// admits, a score, and the k best per query ranked by (score descending, id
// ascending) -- the tie rule of jax.lax.top_k. Empty lanes are (-FLT_MAX, -1)
// == (finfo(float32).min, -1). The scorer is a template policy:
//   fp32: q.x, or 2 q.x - ||x||^2 for l2 (one fixed-order fmaf chain over d);
//   int8: float(int32 sum of q_i8 * x_i8) * (q_scale * row_scale), then
//         2 s - sq for l2 (sq: the dequantized rows' squared norms). Integer
//         sums are exact in any order (d * 127^2 << 2^31);
//   PQ:   sum over m = 0..M-1, in that order, of lut[q, m, code[r, m]]; the
//         LUT folds the metric in, so this scorer is metric-free.
// A score's bits depend on neither the query tile, the chunking nor the
// entry point, so dsq_batch can stay bit-identical to a loop of dsq.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32, 1,979 TOP/s
// int8): at the main path's shapes (n = 1.94M, d = 128) the fp32 scan moves
// 0.99 GB of rows (~0.30 ms) and at q = 64 does 31.8 GFLOP (~0.47 ms); the
// int8 scan moves n (d + 8) bytes (~0.08 ms) and is bytes-bound at q = 1 and
// q = 64; the PQ scan moves n M bytes (~0.02 ms at M = 32), but at q = 64
// does 4.0 G shared-memory LUT lookups, which bound it in practice. The
// (q, n) score matrix is never written to device memory.
//
// Design. The TPU's sequential n-sweep with a running top-k in VMEM scratch
// does not carry over: Hopper blocks run in parallel and in no order. So:
//   pass 1: grid (query tiles of qt <= 8, row chunks). A block stages the
//           query side of its tile in shared memory (fp32 or int8 query
//           rows, or the tile's LUTs) and sweeps its chunk 256 rows at a
//           time: each thread scores one row against the whole tile, rows
//           no query of the tile admits are skipped, and warp j merges query
//           j's 256 scores into its sorted top-k list. The block writes its
//           lists as (q, n_chunks, k) partials.
//   pass 2: one warp per query merges the partials into the final top-k.
// Limits lifted by design, with no other code path:
//   any k: the insertion shifts a list 32 entries at a time from its tail,
//          so a list has no length bound in registers; lists live in shared
//          memory while they fit (the wrapper shrinks qt for large k) and in
//          their partial slots in device memory past that;
//   any depth: the query side is staged in slices of the reduction axis (d,
//          or M for PQ) when a whole tile does not fit; each score's chain
//          continues across slices in the same order, so its bits do not
//          change. The wrapper prefers shrinking qt for PQ (a LUT slice per
//          256 rows would cost more bytes than the codes).
// Gathered mode (the IVF executor): query b sweeps candidate positions
// c in [0, C) of its own row of a (B, C) int32 candidate-id matrix and
// scores store row cand[b, c] (-1, CSR padding, admits nothing), read in
// place from the (n, depth) store: the reference's (B, C, d) gathered block
// is never built (8 GB of fp32 at WIKI-Dir scale 1.0, nprobe 8 of 64 lists,
// B = 64). The query tile is one query (each query has its own
// candidates); admission reads bit id & 31 of the query's scope row
// words[sids[b]]; the top-k lists hold positions, so ties fall to the lower
// position (probe rank, then list order), as jax.lax.top_k over the (B, C)
// axis does, and pass 2 maps the winners back to store ids. Bound: every
// admitted (query, candidate) pair reads its row (d * 4 bytes fp32, d + 4
// int8, M PQ), so B * C_admitted row reads; the unique-bytes floor is each
// distinct admitted row once plus the B * C * 4 bytes of candidate ids.
// Overlapping probed lists are re-read from device memory (or L2) once per
// query; sharing them across a query tile is left for a later change.
// The result is the exact top-k under a total order, and no atomics are
// used: runs are bit-for-bit repeatable. Rows are read per thread (one row
// per thread, 16-byte loads where the layout allows); making the scans
// reach their bounds (tensor-core int8, LUTs in registers, staging rows
// through shared memory) is left for a later change.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // = the largest query tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPass2SmemList = 6144;      // pass 2 keeps lists of k <= this
                                          // in shared memory (48 KB)

enum Kind { kF32 = 0, kI8 = 1, kPQ = 2 };
// how a query admits a row: one dense mask shared by every query, packed
// per-query scope words over rows [0, n), or packed scope words over the
// query's own gathered candidates
enum Mode { kDense = 0, kScoped = 1, kGathered = 2 };

struct Scan {
  const void* q;           // f32 (nq, depth) | i8 (nq, depth) | LUT f32 (nq, depth, 256)
  const float* q_scale;    // int8: (nq,)
  const void* rows;        // f32 (n, depth) | i8 (n, depth) | u8 codes (n, depth)
  const float* row_scale;  // int8: (n,)
  const float* sq;         // l2: (n,)
  const int8_t* mask;      // dense (n,) mask, or the packed words below
  const uint32_t* words;   // (n_scopes, n_words)
  const int* sids;         // (nq,) scope row per query
  const int* cand;         // gathered: (nq, n) store row ids, -1 = padding
  int n_scopes, n_words;
  int nq, n, depth, slice, k, qt, chunk_rows, smem_lists;  // gathered: n = C
  float* part_v;
  int* part_i;
};

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Offer one candidate per lane (``ok`` marks lanes that hold one) to the
// warp's sorted list (lv, li) of length k, in lane order. The list is owned
// by the calling warp alone (shared or device memory).
__device__ void warp_offer(float* lv, int* li, int k, float cv, int ci,
                           bool ok) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  unsigned want = __ballot_sync(kAll, ok && better(cv, ci, lv[k - 1],
                                                   li[k - 1]));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float v = __shfl_sync(kAll, cv, src);
    const int id = __shfl_sync(kAll, ci, src);
    if (!better(v, id, lv[k - 1], li[k - 1])) continue;  // warp-uniform
    int pos = 0;
    for (int j = lane; j < k; j += 32) pos += better(lv[j], li[j], v, id);
#pragma unroll
    for (int o = 16; o; o >>= 1) pos += __shfl_xor_sync(kAll, pos, o);
    // shift [pos, k-2] one place down, 32 entries at a time from the tail
    // (each step reads before it writes, and reads only entries the steps
    // below it have not written yet), writing the candidate at pos
    for (int base = ((k - 1) >> 5) << 5; base >= 0 && base + 31 >= pos;
         base -= 32) {
      const int j = base + lane;
      const bool move = j > pos && j < k;
      float sv = 0.0f;
      int si = 0;
      if (move) {
        sv = lv[j - 1];
        si = li[j - 1];
      }
      __syncwarp();
      if (move) {
        lv[j] = sv;
        li[j] = si;
      } else if (j == pos) {
        lv[j] = v;
        li[j] = id;
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- scorers
// stage():      copy the tile's query side for depth [c0, c0 + len) into
//               shared memory, laid out (query, element);
// accumulate(): continue row r's per-query chains over that slice;
// finish():     the score from a finished chain.

template <int kKind>
struct Scorer;

template <>
struct Scorer<kF32> {
  using Acc = float;
  __device__ static void stage(unsigned char* qs, const Scan& p, int q0,
                               int nqt, int c0, int len) {
    float* dst = reinterpret_cast<float*>(qs);
    const float* q = static_cast<const float*>(p.q);
    for (int i = threadIdx.x; i < nqt * len; i += kThreads) {
      const int j = i / len;
      dst[i] = q[static_cast<size_t>(q0 + j) * p.depth + c0 + (i - j * len)];
    }
  }
  template <bool kVec>
  __device__ static void accumulate(Acc (&acc)[kWarps],
                                    const unsigned char* qs, const Scan& p,
                                    int r, int c0, int len, int nqt) {
    const float* qf = reinterpret_cast<const float*>(qs);
    const float* x = static_cast<const float*>(p.rows) +
                     static_cast<size_t>(r) * p.depth + c0;
    if (kVec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int c = 0; c < len; c += 4) {
        const float4 xv = __ldg(x4 + (c >> 2));
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          if (j < nqt) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qf + j * len + c);
            acc[j] = fmaf(qv.x, xv.x, acc[j]);
            acc[j] = fmaf(qv.y, xv.y, acc[j]);
            acc[j] = fmaf(qv.z, xv.z, acc[j]);
            acc[j] = fmaf(qv.w, xv.w, acc[j]);
          }
        }
      }
    } else {
      for (int c = 0; c < len; ++c) {
        const float xv = __ldg(x + c);
#pragma unroll
        for (int j = 0; j < kWarps; ++j)
          if (j < nqt) acc[j] = fmaf(qf[j * len + c], xv, acc[j]);
      }
    }
  }
  template <bool kL2>
  __device__ static float finish(Acc acc, float, float, float sqr) {
    return kL2 ? 2.0f * acc - sqr : acc;
  }
};

template <>
struct Scorer<kI8> {
  using Acc = int;
  __device__ static void stage(unsigned char* qs, const Scan& p, int q0,
                               int nqt, int c0, int len) {
    int8_t* dst = reinterpret_cast<int8_t*>(qs);
    const int8_t* q = static_cast<const int8_t*>(p.q);
    for (int i = threadIdx.x; i < nqt * len; i += kThreads) {
      const int j = i / len;
      dst[i] = q[static_cast<size_t>(q0 + j) * p.depth + c0 + (i - j * len)];
    }
  }
  template <bool kVec>
  __device__ static void accumulate(Acc (&acc)[kWarps],
                                    const unsigned char* qs, const Scan& p,
                                    int r, int c0, int len, int nqt) {
    const int8_t* q8 = reinterpret_cast<const int8_t*>(qs);
    const int8_t* x = static_cast<const int8_t*>(p.rows) +
                      static_cast<size_t>(r) * p.depth + c0;
    if (kVec) {
      const int4* x16 = reinterpret_cast<const int4*>(x);
      for (int c = 0; c < len; c += 16) {
        const int4 xv = __ldg(x16 + (c >> 4));
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          if (j < nqt) {
            const int4 qv = *reinterpret_cast<const int4*>(q8 + j * len + c);
            acc[j] = __dp4a(xv.x, qv.x, acc[j]);
            acc[j] = __dp4a(xv.y, qv.y, acc[j]);
            acc[j] = __dp4a(xv.z, qv.z, acc[j]);
            acc[j] = __dp4a(xv.w, qv.w, acc[j]);
          }
        }
      }
    } else {
      for (int c = 0; c < len; ++c) {
        const int xv = x[c];
#pragma unroll
        for (int j = 0; j < kWarps; ++j)
          if (j < nqt) acc[j] += xv * static_cast<int>(q8[j * len + c]);
      }
    }
  }
  template <bool kL2>
  __device__ static float finish(Acc acc, float qscale, float rscale,
                                 float sqr) {
    const float s = __int2float_rn(acc) * (qscale * rscale);
    return kL2 ? 2.0f * s - sqr : s;
  }
};

template <>
struct Scorer<kPQ> {
  using Acc = float;
  __device__ static void stage(unsigned char* qs, const Scan& p, int q0,
                               int nqt, int c0, int len) {
    // one query's slice is len * 256 contiguous floats of its (M, 256) LUT
    float4* dst = reinterpret_cast<float4*>(qs);
    const float4* lut = static_cast<const float4*>(p.q);
    const int per = len * 64;
    for (int i = threadIdx.x; i < nqt * per; i += kThreads) {
      const int j = i / per;
      dst[i] = lut[(static_cast<size_t>(q0 + j) * p.depth + c0) * 64 +
                   (i - j * per)];
    }
  }
  template <bool kVec>
  __device__ static void accumulate(Acc (&acc)[kWarps],
                                    const unsigned char* qs, const Scan& p,
                                    int r, int c0, int len, int nqt) {
    const float* lut = reinterpret_cast<const float*>(qs);
    const uint8_t* code = static_cast<const uint8_t*>(p.rows) +
                          static_cast<size_t>(r) * p.depth + c0;
    const int stride = len * 256;          // one query's LUT slice
    if (kVec) {
      for (int m = 0; m < len; m += 4) {
        const unsigned w =
            __ldg(reinterpret_cast<const unsigned*>(code + m));
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* l = lut + (m + t) * 256 + ((w >> (8 * t)) & 255u);
#pragma unroll
          for (int j = 0; j < kWarps; ++j)
            if (j < nqt) acc[j] += l[j * stride];
        }
      }
    } else {
      for (int m = 0; m < len; ++m) {
        const float* l = lut + m * 256 + code[m];
#pragma unroll
        for (int j = 0; j < kWarps; ++j)
          if (j < nqt) acc[j] += l[j * stride];
      }
    }
  }
  template <bool kL2>
  __device__ static float finish(Acc acc, float, float, float) {
    return acc;
  }
};

__host__ __device__ inline size_t kind_bytes(int kind) {
  return kind == kF32 ? 4 : kind == kI8 ? 1 : 256 * 4;
}

// Shared memory of pass 1: the staged query side (rounded up to 16 bytes),
// one sweep's scores, the tile's scope rows and, when they fit, its lists.
__host__ __device__ inline size_t q_bytes(int kind, int qt, int slice) {
  return (static_cast<size_t>(qt) * slice * kind_bytes(kind) + 15) / 16 * 16;
}

size_t pass1_smem(int kind, int qt, int slice, int k, int smem_lists) {
  return q_bytes(kind, qt, slice) +
         static_cast<size_t>(qt) * (kThreads * sizeof(float) + sizeof(int)) +
         (smem_lists ? static_cast<size_t>(qt) * k * 8 : 0);
}

template <int kKind, int kMode, bool kL2, bool kVec>
__global__ void __launch_bounds__(kThreads) scan_pass1(const Scan p) {
  using S = Scorer<kKind>;
  using Acc = typename S::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                  // query side
  float* sv = reinterpret_cast<float*>(
      smem + q_bytes(kKind, p.qt, p.slice));                 // qt * 256
  int* tile_sid = reinterpret_cast<int*>(sv + p.qt * kThreads);   // qt
  float* lv_s = reinterpret_cast<float*>(tile_sid + p.qt);   // qt * k
  int* li_s = reinterpret_cast<int*>(lv_s + p.qt * p.k);     // qt * k

  const int k = p.k;
  const int q0 = blockIdx.x * p.qt;
  const int nqt = min(p.qt, p.nq - q0);
  const int chunk = blockIdx.y;
  const int r_begin = chunk * p.chunk_rows;
  const int r_end = min(p.n, r_begin + p.chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // query j's list: in shared memory, or in its own partial slot
  auto list_off = [&](int j) {
    return (static_cast<size_t>(q0 + j) * gridDim.y + chunk) * k;
  };

  for (int i = threadIdx.x; i < nqt * k; i += kThreads) {
    const int j = i / k;
    const int s = i - j * k;
    if (p.smem_lists) {
      lv_s[i] = kNegInf;
      li_s[i] = -1;
    } else {
      p.part_v[list_off(j) + s] = kNegInf;
      p.part_i[list_off(j) + s] = -1;
    }
  }
  if (kMode != kDense && threadIdx.x < nqt)
    tile_sid[threadIdx.x] = p.sids[q0 + threadIdx.x];
  // gathered: the tile is query q0 alone, sweeping its candidate row
  const int* cand =
      kMode == kGathered ? p.cand + static_cast<size_t>(q0) * p.n : nullptr;
  const bool one_slice = p.slice >= p.depth;
  if (one_slice) S::stage(qs, p, q0, nqt, 0, p.depth);
  __syncthreads();

  float* wl = p.smem_lists ? lv_s + warp * k : p.part_v + list_off(warp);
  int* wi = p.smem_lists ? li_s + warp * k : p.part_i + list_off(warp);

  for (int base = r_begin; base < r_end; base += kThreads) {
    const int c = base + threadIdx.x;        // sweep position
    int r = c;                               // the row it reads
    unsigned admit = 0;                      // bit j: query j admits row r
    if (c < r_end) {
      if (kMode == kGathered) {
        r = cand[c];
        const int s = tile_sid[0];
        if (r >= 0 && s >= 0 && s < p.n_scopes) {
          const uint32_t w =
              p.words[static_cast<size_t>(s) * p.n_words + (r >> 5)];
          admit = (w >> (r & 31)) & 1u;
        }
      } else if (kMode == kScoped) {
        for (int j = 0; j < nqt; ++j) {
          const int s = tile_sid[j];
          if (s >= 0 && s < p.n_scopes) {
            const uint32_t w =
                p.words[static_cast<size_t>(s) * p.n_words + (r >> 5)];
            admit |= ((w >> (r & 31)) & 1u) << j;
          }
        }
      } else if (p.mask[r]) {
        admit = (1u << nqt) - 1u;
      }
    }
    Acc acc[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) acc[j] = Acc(0);
    for (int c0 = 0; c0 < p.depth; c0 += p.slice) {
      const int len = min(p.slice, p.depth - c0);
      if (!one_slice) {                      // block-uniform
        __syncthreads();
        S::stage(qs, p, q0, nqt, c0, len);
        __syncthreads();
      }
      if (admit) S::template accumulate<kVec>(acc, qs, p, r, c0, len, nqt);
    }
    const float rscale =
        (kKind == kI8 && admit) ? p.row_scale[r] : 1.0f;
    const float sqr = (kL2 && admit) ? p.sq[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < nqt) {
        float s = kNegInf;
        if ((admit >> j) & 1u) {
          const float qscale = kKind == kI8 ? p.q_scale[q0 + j] : 1.0f;
          s = S::template finish<kL2>(acc[j], qscale, rscale, sqr);
        }
        sv[j * kThreads + threadIdx.x] = s;
      }
    }
    __syncthreads();
    if (warp < nqt) {
      for (int t = 0; t < kThreads; t += 32) {
        const int row = base + t + lane;
        const float v = sv[warp * kThreads + t + lane];
        warp_offer(wl, wi, k, v, row, row < r_end && v > kNegInf);
      }
    }
    __syncthreads();
  }

  if (p.smem_lists) {
    for (int i = threadIdx.x; i < nqt * k; i += kThreads) {
      const int j = i / k;
      const int s = i - j * k;
      p.part_v[list_off(j) + s] = lv_s[i];
      p.part_i[list_off(j) + s] = li_s[i];
    }
  }
}

// One warp per query: merge the (n_chunks, k) partial lists. The list
// lives in shared memory for k <= kPass2SmemList, else in the output row.
// Gathered mode (``cand`` non-null) ranks positions and writes the store
// ids at them, cand[qi, pos].
__global__ void __launch_bounds__(32)
scan_pass2(const float* __restrict__ part_v, const int* __restrict__ part_i,
           int n_chunks, int k, const int* __restrict__ cand, int n_cand,
           float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem2[];
  const int lane = threadIdx.x;
  const size_t qi = blockIdx.x;
  const bool in_smem = k <= kPass2SmemList;
  float* lv = in_smem ? smem2 : out_v + qi * k;
  int* li = in_smem ? reinterpret_cast<int*>(smem2 + k) : out_i + qi * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = -1;
  }
  const size_t total = static_cast<size_t>(n_chunks) * k;
  const float* pv = part_v + qi * total;
  const int* pi = part_i + qi * total;
  for (size_t t = 0; t < total; t += 32) {
    const size_t idx = t + lane;
    const bool in = idx < total;
    const float v = in ? pv[idx] : kNegInf;
    const int id = in ? pi[idx] : -1;
    warp_offer(lv, li, k, v, id, in && id >= 0);
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {      // each lane its own entries
    const float v = lv[j];
    int id = li[j];
    if (cand != nullptr && id >= 0) id = cand[qi * n_cand + id];
    out_v[qi * k + j] = v;
    out_i[qi * k + j] = id;
  }
}

template <int kKind, int kMode, bool kL2, bool kVec>
cudaError_t launch_pass1(dim3 grid, size_t smem, cudaStream_t stream,
                         const Scan& p) {
  auto kern = scan_pass1<kKind, kMode, kL2, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kKind, int kMode>
cudaError_t dispatch_pass1(bool l2, bool vec, dim3 grid, size_t smem,
                           cudaStream_t stream, const Scan& p) {
  if constexpr (kKind == kPQ) {              // metric-free: no l2 variant
    if (vec) return launch_pass1<kKind, kMode, false, true>(grid, smem, stream, p);
    return launch_pass1<kKind, kMode, false, false>(grid, smem, stream, p);
  } else {
    if (l2) {
      if (vec) return launch_pass1<kKind, kMode, true, true>(grid, smem, stream, p);
      return launch_pass1<kKind, kMode, true, false>(grid, smem, stream, p);
    }
    if (vec) return launch_pass1<kKind, kMode, false, true>(grid, smem, stream, p);
    return launch_pass1<kKind, kMode, false, false>(grid, smem, stream, p);
  }
}

template <int kKind>
cudaError_t dispatch_mode(int mode, bool l2, bool vec, dim3 grid,
                          size_t smem, cudaStream_t stream, const Scan& p) {
  if (mode == kGathered)
    return dispatch_pass1<kKind, kGathered>(l2, vec, grid, smem, stream, p);
  if (mode == kScoped)
    return dispatch_pass1<kKind, kScoped>(l2, vec, grid, smem, stream, p);
  return dispatch_pass1<kKind, kDense>(l2, vec, grid, smem, stream, p);
}

}  // namespace

extern "C" {

// One entry point for the nine scans. kind: 0 fp32, 1 int8, 2 PQ. Exactly
// one of ``mask`` (dense (n,) int8, shared by every query) and ``words``
// (packed (n_scopes, n_words) masks, row sids[i] for query i) is non-null.
// A non-null ``cand`` (nq, n) selects gathered mode: n is then the
// candidate count C per query, ``words`` is required and qt must be 1.
// ``slice`` is the depth staged at once (depth = d, or M for PQ), ``qt``
// the query tile, ``smem_lists`` whether the tile's lists fit in shared
// memory; the partials are (nq, n_chunks, k).
int repro_scan_topk(int kind, const void* q, const float* q_scale,
                    const void* rows, const float* row_scale, const float* sq,
                    const int8_t* mask, const uint32_t* words,
                    const int* sids, const int* cand, int n_scopes,
                    int n_words, int nq, int n,
                    int depth, int slice, int k, int l2, int qt,
                    int chunk_rows, int n_chunks, int smem_lists,
                    float* part_v, int* part_i, float* out_v, int* out_i,
                    void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (kind < kF32 || kind > kPQ || k < 1 || qt < 1 || qt > kWarps ||
      depth < 1 || slice < 1 || slice > depth || chunk_rows < 1 ||
      n_chunks < 1 || n_chunks > 65535 ||
      (mask == nullptr) == (words == nullptr) ||
      (cand != nullptr && (words == nullptr || qt != 1 || n < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Scan p{q, q_scale, rows, row_scale, sq, mask, words, sids, cand, n_scopes,
         n_words, nq, n, depth, slice, k, qt, chunk_rows, smem_lists,
         part_v, part_i};
  const uintptr_t base = reinterpret_cast<uintptr_t>(rows);
  const int unit = kind == kF32 ? 4 : kind == kI8 ? 16 : 4;
  const bool vec = depth % unit == 0 && slice % unit == 0 &&
                   base % (kind == kPQ ? 4 : 16) == 0;
  const size_t smem1 = pass1_smem(kind, qt, slice, k, smem_lists);
  const dim3 grid1((nq + qt - 1) / qt, n_chunks);
  const int mode = cand != nullptr ? kGathered
                   : words != nullptr ? kScoped : kDense;
  cudaError_t err =
      kind == kF32 ? dispatch_mode<kF32>(mode, l2, vec, grid1, smem1, stream, p)
      : kind == kI8 ? dispatch_mode<kI8>(mode, l2, vec, grid1, smem1, stream, p)
                    : dispatch_mode<kPQ>(mode, false, vec, grid1, smem1, stream, p);
  if (err != cudaSuccess) return err;
  const size_t smem2 = k <= kPass2SmemList ? sizeof(float) * 2 * k : 0;
  scan_pass2<<<nq, 32, smem2, stream>>>(part_v, part_i, n_chunks, k, cand, n,
                                        out_v, out_i);
  return cudaGetLastError();
}

}  // extern "C"
