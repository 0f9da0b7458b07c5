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
// int8; 132 SMs, each serving 32 4-byte shared-memory reads a clock): at
// the main path's shapes (n = 1.94M, d = 128) the fp32 scan moves 0.99 GB
// of rows (~0.30 ms) and at q = 64 does 31.8 GFLOP (~0.47 ms); the int8
// scan moves n (d + 8) bytes (~0.08 ms) and is bytes-bound at q = 1 and
// q = 64; the PQ scan moves n M bytes (~0.02 ms at M = 32), but each
// admitted (query, row) pair reads M LUT entries from shared memory: at
// q = 64 with 74.5M admitted pairs that is 2.4G reads, ~0.29 ms at 32 a
// clock on 132 SMs at 1.98 GHz, and several times that in practice, since
// rows' codes are random and 32 lanes' reads fall on random banks. The
// (q, n) score matrix is never written to device memory.
//
// Every pass 1 writes per-chunk partial lists (q, n_chunks, k) and one
// pass 2 merges them; the TPU's sequential n-sweep with a running top-k in
// VMEM scratch does not carry over (Hopper blocks run in parallel and in
// no order). Pass 2 is one block per query, warp w merging chunks w,
// w + 8, ..., then warp 0 the warps' lists; a list is sorted, so a warp
// stops reading it at its first entry that loses. Which pass 1 runs which
// kernel:
//
//   scan_pass1_stream  kernel 1 (scoped_topk): fp32, one dense mask
//   scan_pass1_tiled   kernels 2, 6 (multi_scope_topk, _i8): scope words
//   scan_pass1_pq      kernel 8 (multi_scope_topk_pq): PQ, scope words
//   scan_pass1         kernels 5, 7 (scoped_topk_i8, _pq): dense mask, and
//                      kernel 9 in all three modes (gathered)
//
// scan_pass1_stream: bytes-bound (one pass over the rows).
//   grid (query tiles of qt <= 8, row chunks): one wave of blocks of 4
//   warps, two per SM at q = 1 (105 KB of shared memory each), so 262
//   chunks of whole 128-row tiles over 1.94M rows; a gather plan's few
//   thousand rows get one tile per block.
//   staging: item = (128-row tile, 64-float depth slice); all 128 threads
//           copy an item with 16-byte cp.async (neighbouring threads on
//           neighbouring bytes, 256 contiguous bytes of each row; 4-byte
//           copies where rows start off 16-byte alignment), with the query
//           tile's slice, into a ring of 3 stages of 35 KB, two items ahead
//           of the one computed: 64 KB of rows in flight per block, 128 KB
//           per SM, against the ~25 KB per SM that 3.35 TB/s x ~1 us of
//           loaded latency needs. (tools/scan_variants.py on the H100,
//           pass 1: 256-row tiles of 32-float slices 2% slower, of
//           16-float slices with 4 stages 50% slower; whole 128-float rows
//           in 64-row tiles 22% slower, in 128-row tiles with one block
//           per SM 29% slower.) Row strides are padded to an odd number of
//           16-byte units (272 bytes), so a quarter warp's float4 reads hit
//           8 bank groups.
//   compute: thread t owns row t of each tile and runs its chain
//           acc = fmaf(q[c], x[c], acc), c = 0..d-1 from 0.0f, out of
//           shared memory (the query slice is a broadcast), across the
//           slices; kQ = 1 compiles the one-query scan of dsq alone. This
//           is kernel 2's chain, so kernel 2 == kernel 1 bit for bit.
//   epilogue: each warp keeps its own list per query and its tail in
//           registers; only lanes whose score beats the tail take part,
//           several at once through warp_merge. No barrier waits on a
//           merge: the ring's one barrier per item is the only one, and
//           the warps' lists are merged once, at the chunk's end. Lists
//           live in shared memory (the tile shrinks until they fit) or,
//           past that, as one partial per warp in device memory.
//
// scan_pass1_tiled: the fp32 and int8 scans with per-query scope words
// (multi_scope_topk, multi_scope_topk_i8), the batched scans of dsq_batch.
//   grid (query tiles of qt <= 64, row chunks, ~1 block per SM in all);
//   each block reads its chunk's rows once for its whole query tile.
//   staging: row tiles (256 rows fp32, 128 int8), in depth slices (32
//           floats, 128 bytes), go through a ring of 2 shared-memory
//           stages with cp.async (16-byte copies where rows start 16-byte
//           aligned, else 4-byte, else byte copies), with the tile's scope
//           words (rows / 32 per query), row scales and l2 norms; the copy
//           of the next stage overlaps the work on this one (3 and 4
//           stages measured no faster on the H100). The query
//           side stays resident when it fits 64 KB, else rides in each
//           stage as a depth slice; every chain continues across slices in
//           the same order. Row strides are padded to an odd number of
//           16-byte units: 8 rows read at one depth hit 8 bank groups.
//   int8:   16 warps; mma.sync m16n8k32 s8*s8 -> s32 on the tensor cores.
//           Queries are A (row-major, zero-padded to 16 rows), staged rows
//           are B as stored (n, d) = column-major, ldmatrix.x4 feeds both;
//           d is zero-padded to 32 on the query side. Warp w owns rows
//           16 (w % 8)..+15 against query groups 2 (w / 8) and 2 (w / 8) + 1;
//           int32 sums are exact, so every score equals the __dp4a chain's
//           bits.
//   fp32:   8 warps, register-tiled on the CUDA cores: warp w owns query
//           group w / 2 (16 queries) x rows 128 (w % 2)..+127, each thread
//           8 queries x 8 rows = 64 accumulators, fed by float4 loads per
//           depth quad (shared memory, not the FMA pipe, bounds this loop).
//           acc = fmaf(q[c], x[c], acc) for c = 0..d-1 in order from 0.0f,
//           the chain of Scorer<kF32> and of kernel 1, so scores keep
//           their bits: no TF32, no split-k, no reassociation, and the file
//           is built without -use_fast_math (padding adds fmaf(0, 0, acc),
//           which leaves a chain that starts at +0 unchanged).
//   skip:   a (16-query group x warp's rows) product runs only when some
//           query of the group admits one of those rows, so the
//           block-diagonal masks of gather_rescore cost about one tile per
//           query.
//   epilogue: per query, the scores of admitted pairs (bit r & 31 of the
//           staged words, r inside the chunk) that beat its list's tail; a
//           warp with any writes its rows' scores to shared memory and
//           flags the query. Warp w then gathers each flagged query's
//           candidates into its 32-entry buffer and merges a full buffer
//           into the query's list (warp_merge: a bitonic sort of the 32 and
//           a rank-based merge); the list's tail is the next tile's filter.
//           Lists live in shared memory, the query tile halved until
//           qt k 8 bytes fit beside the ring, and in their partial slots in
//           device memory only when one query's do not fit (tiled_plan,
//           which also picks the depth slice and the query side's
//           residency: the wrapper passes only a cap on the tile).
//
// scan_pass1_pq: bound by shared-memory LUT reads (above).
//   grid (query tiles, row chunks): at most one block per SM in all (one
//   wave). The tile is the most queries whose (M, 256) LUTs stay resident
//   in shared memory beside the ring and the lists (5 at M = 32, k = 80:
//   160 KB), so the codes are read once per tile and no LUT is re-staged;
//   a LUT larger than shared memory rides in each stage in slices of M
//   (pq_plan).
//   staging: 512-row tiles of codes (32 bytes a row, 16-byte cp.async,
//           strides padded to an odd number of 16-byte units) and the
//           tile's scope words, through a ring of 2 stages.
//   compute: 16 warps, thread t owns row t of the tile and reads its codes
//           16 at a time; it looks up only the queries that admit its row,
//           acc += lut[j, m, code[m]] for m = 0..M-1 in order from 0.0f
//           (Scorer<kPQ>'s chain, so kernel 8 == kernel 7 bit for bit),
//           16 reads in flight before their 16 adds; a warp skips a query
//           that none of its rows admits. On the H100 this loop, not the
//           epilogue, takes most of the time, and it runs well below the
//           shared-memory read rate: codes whose reads never conflict save
//           only about a quarter, 8 warps are slower than 16
//           (tools/scan_variants.py, PERF.md).
//   epilogue: scan_pass1_tiled's (tail filter, flags per warp, 32-entry
//           buffers merged by warp_merge, warp j serving query j).
//
// scan_pass1: the int8 and PQ dense-mask scans and the gathered scans.
//   grid (query tiles of qt <= 8, row chunks). A block stages the query
//   side of its tile in shared memory (int8 query rows, or the tile's
//   LUTs) and sweeps its chunk 256 rows at a time: each thread scores one
//   row against the whole tile (16-byte loads where the layout allows),
//   rows no query of the tile admits are skipped, and warp j merges query
//   j's 256 scores into its sorted top-k list.
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
// query; sharing them across a query tile is left for a later change, as
// is the int8 and PQ dense-mask scans' move to a streaming design.
// The result is the exact top-k under a total order, and no atomics are
// used: runs are bit-for-bit repeatable.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // = scan_pass1's largest query tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPass2SmemList = 6144;      // pass 2 keeps lists of k <= this
                                          // in shared memory (48 KB)

enum Kind { kF32 = 0, kI8 = 1, kPQ = 2 };
// how scan_pass1's query admits a row: one dense mask shared by every
// query, or packed scope words over the query's own gathered candidates
enum Mode { kDense = 0, kGathered = 1 };

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

// warp_merge holds a list of k <= 32 * kSlots entries in registers: 8
// slots for the tiled pass 1 at k <= 256 (its registers are scarce), 16 for
// larger k and for pass 2
constexpr int kMergeSlots = 8;
constexpr int kMergeSlotsWide = 16;

// Merge the lanes' candidates (``ok`` lanes; ids distinct from the list's)
// into the warp's sorted list (lv, li) of length k <= 32 * kSlots at
// once: a bitonic sort of the 32 lanes (best first; skipped with kSorted,
// where the ok lanes are a prefix in that order), then each list entry
// moves down by the candidates better than it (binary search over the
// sorted lanes) and candidate c lands at c plus the list entries better
// than it (binary search over the list). Ranks under a total order are a
// permutation, so the list equals the one-by-one insertion's.
template <int kSlots, bool kSorted = false>
__device__ void warp_merge(float* lv, int* li, int k, float cv, int ci,
                           bool ok) {
  constexpr int kSentinel = 0x7fffffff;
  const int lane = threadIdx.x & 31;
  float v = ok ? cv : kNegInf;              // a sentinel ranks below every
  int id = ok ? ci : kSentinel;             // entry, empty lanes included
  if constexpr (!kSorted) {                 // kSorted: lanes already in order
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float ov = __shfl_xor_sync(kAll, v, stride);
        const int oi = __shfl_xor_sync(kAll, id, stride);
        const bool keep_better =
            ((lane & stride) == 0) == ((lane & size) == 0);
        if (better(ov, oi, v, id) == keep_better) {
          v = ov;
          id = oi;
        }
      }
    }
  }
  const float v31 = __shfl_sync(kAll, v, 31);
  const int i31 = __shfl_sync(kAll, id, 31);
  float ev[kSlots];
  int ei[kSlots], epos[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int j = lane + 32 * t;
    ev[t] = kNegInf;
    ei[t] = -1;
    epos[t] = k;
    if (32 * t < k) {                       // warp-uniform
      if (j < k) {
        ev[t] = lv[j];
        ei[t] = li[j];
      }
      int cnt = 0;                          // candidates better than entry j
#pragma unroll
      for (int step = 16; step; step >>= 1) {
        const float pv = __shfl_sync(kAll, v, cnt + step - 1);
        const int pi = __shfl_sync(kAll, id, cnt + step - 1);
        if (better(pv, pi, ev[t], ei[t])) cnt += step;
      }
      if (cnt == 31 && better(v31, i31, ev[t], ei[t])) cnt = 32;
      epos[t] = j + cnt;
    }
  }
  int lo = 0, hi = k;                       // list entries better than lane's
  if (id != kSentinel) {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(lv[mid], li[mid], v, id))
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  const int cpos = id == kSentinel ? k : lane + lo;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (32 * t < k && lane + 32 * t < k && epos[t] < k) {
      lv[epos[t]] = ev[t];
      li[epos[t]] = ei[t];
    }
  }
  if (cpos < k) {
    lv[cpos] = v;
    li[cpos] = id;
  }
  __syncwarp();
}

// Insert the candidates of lanes ``want`` one by one, in lane order.
__device__ void warp_insert(float* lv, int* li, int k, float cv, int ci,
                            unsigned want) {
  const int lane = threadIdx.x & 31;
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

// Offer one candidate per lane (``ok`` marks lanes that hold one) to the
// warp's sorted list (lv, li) of length k, in lane order (kSorted: the
// lanes hold a sorted list's entries, best first). The list is owned
// by the calling warp alone (shared or device memory). Several winners at
// once go through warp_merge<kSlots> where k <= 32 kSlots; else, and with
// kSlots = 0 (scan_pass1, whose registers the merge would crowd), one by
// one. Returns the lanes whose candidate beat the list's tail on entry.
template <int kSlots, bool kSorted = false>
__device__ unsigned warp_offer(float* lv, int* li, int k, float cv, int ci,
                               bool ok) {
  __syncwarp();
  const bool win = ok && better(cv, ci, lv[k - 1], li[k - 1]);
  unsigned want = __ballot_sync(kAll, win);
  const unsigned won = want;
  if constexpr (kSlots > 0) {
    if (__popc(want) > 1 && k <= 32 * kSlots) {
      warp_merge<kSlots, kSorted>(lv, li, k, cv, ci, win);
      return won;
    }
  }
  if (want) warp_insert(lv, li, k, cv, ci, want);
  return won;
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
        warp_offer<0>(wl, wi, k, v, row, row < r_end && v > kNegInf);
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

// Pass 2, one block per query: warp w merges the partial lists of chunks
// w, w + nw, ... into its own list, loading the head of its next list
// while it merges this one. Every list merged is sorted best first, so a
// warp stops reading one at its first entry that does not beat its tail,
// and a presorted merge skips warp_merge's sort; the warps' lists then
// merge in a tree of log2(nw) rounds. nw = 16 for 32 lists or more, else
// 8, while the warps' lists fit kPass2SmemList entries, else one warp
// whose list lives in shared memory for k <= kPass2SmemList, else in the
// output row. Gathered mode (``cand`` non-null) ranks positions and
// writes the store ids at them, cand[qi, pos].
constexpr int kPass2Warps = 16;

// the lane's entry of a sorted list's first 32 (-FLT_MAX, -1 past k)
__device__ __forceinline__ void list_head(const float* sv, const int* si,
                                          int k, float& v, int& id) {
  const int lane = threadIdx.x & 31;
  v = lane < k ? sv[lane] : kNegInf;
  id = lane < k ? si[lane] : -1;
}

// merge sorted list (sv, si) of length k, whose first 32 entries the lanes
// already hold in (v0, i0), into the warp's list (lv, li)
__device__ void merge_sorted(float* lv, int* li, int k,
                             const float* __restrict__ sv,
                             const int* __restrict__ si, float v0, int i0) {
  const int lane = threadIdx.x & 31;
  for (int e = 0; e < k; e += 32) {
    const int j = e + lane;
    const bool in = j < k;
    const float v = e == 0 ? v0 : in ? sv[j] : kNegInf;
    const int id = e == 0 ? i0 : in ? si[j] : -1;
    const bool ok = in && id >= 0;
    if (warp_offer<kMergeSlotsWide, true>(lv, li, k, v, id, ok) !=
        __ballot_sync(kAll, in))
      break;
  }
}

__device__ void merge_sorted(float* lv, int* li, int k,
                             const float* __restrict__ sv,
                             const int* __restrict__ si) {
  float v0;
  int i0;
  list_head(sv, si, k, v0, i0);
  merge_sorted(lv, li, k, sv, si, v0, i0);
}

__global__ void __launch_bounds__(kPass2Warps * 32)
scan_pass2(const float* __restrict__ part_v, const int* __restrict__ part_i,
           int n_chunks, int k, const int* __restrict__ cand, int n_cand,
           float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem2[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qi = blockIdx.x;
  const bool in_smem = static_cast<size_t>(nw) * k <= kPass2SmemList;
  float* lists_v = smem2;
  int* lists_i = reinterpret_cast<int*>(smem2 + static_cast<size_t>(nw) * k);
  float* lv = in_smem ? lists_v + static_cast<size_t>(warp) * k
                      : out_v + qi * k;
  int* li = in_smem ? lists_i + static_cast<size_t>(warp) * k
                    : out_i + qi * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = -1;
  }
  const size_t total = static_cast<size_t>(n_chunks) * k;
  const float* pv = part_v + qi * total;
  const int* pi = part_i + qi * total;
  float hv = kNegInf;           // the head of the warp's next list
  int hi = -1;
  if (warp < n_chunks)
    list_head(pv + static_cast<size_t>(warp) * k,
              pi + static_cast<size_t>(warp) * k, k, hv, hi);
  for (int c = warp; c < n_chunks; c += nw) {
    const float v0 = hv;
    const int i0 = hi;
    if (c + nw < n_chunks)
      list_head(pv + static_cast<size_t>(c + nw) * k,
                pi + static_cast<size_t>(c + nw) * k, k, hv, hi);
    merge_sorted(lv, li, k, pv + static_cast<size_t>(c) * k,
                 pi + static_cast<size_t>(c) * k, v0, i0);
  }
  for (int step = 1; step < nw; step <<= 1) {   // a tree of the warps' lists
    __syncthreads();
    if ((warp & (2 * step - 1)) == 0 && warp + step < nw)
      merge_sorted(lv, li, k, lists_v + static_cast<size_t>(warp + step) * k,
                   lists_i + static_cast<size_t>(warp + step) * k);
  }
  if (warp != 0) return;
  __syncwarp();
  for (int j = lane; j < k; j += 32) {      // each lane its own entries
    const float v = lv[j];
    int id = li[j];
    if (cand != nullptr && id >= 0) id = cand[qi * n_cand + id];
    out_v[qi * k + j] = v;
    out_i[qi * k + j] = id;
  }
}

// ------------------------------------------------- tiled pass 1 (fp32, int8)
constexpr int kTileQ = 64;                // largest query tile
// rows per row tile: 256 for fp32 (8 x 8 register tiles), 128 for int8
__host__ __device__ constexpr int tile_rows(int kind) {
  return kind == kF32 ? 256 : 128;
}
constexpr int kStages = 2;     // ring: tile t + 1 is copied while t computes
constexpr int kSmemLimit = 232448;        // dynamic shared memory per block
constexpr int kQResident = 64 * 1024;     // query side kept resident up to
// depth one ring stage holds: 32 floats (fp32), 128 bytes (int8)
__host__ __device__ constexpr int tiled_slice(int kind) {
  return kind == kF32 ? 32 : 128;
}

struct TiledScan {
  const void* q;           // f32 | i8 (nq, depth)
  const float* q_scale;    // int8: (nq,)
  const void* rows;        // f32 | i8 (n, depth)
  const float* row_scale;  // int8: (n,)
  const float* sq;         // l2: (n,)
  const uint32_t* words;   // (n_scopes, n_words)
  const int* sids;         // (nq,)
  int n_scopes, n_words;
  int nq, n, depth, slice, k, qt, q_resident, chunk_rows, smem_lists;
  int row_width, q_width;  // copy width in bytes: 16, 4 or 1
  float* part_v;
  int* part_i;
};

// a staged row's stride: an odd number of 16-byte units, so 8 rows read at
// one depth (ldmatrix, float4) fall on 8 distinct bank groups
__host__ __device__ inline int pad_stride(int bytes) {
  int u = (bytes + 15) / 16;
  if (!(u & 1)) ++u;
  return u * 16;
}

// bytes of a depth slice of ``len`` elements, padded to the compute unit
// (4 floats for fp32, one 32-byte mma step for int8)
__host__ __device__ inline int depth_pad(int kind, int len) {
  return kind == kF32 ? (len + 3) / 4 * 16 : (len + 31) / 32 * 32;
}

// Shared memory of the tiled pass 1, in this order: the resident query side,
// the ring of stages (rows, then the query slice when not resident), the
// ring's meta slots (words, row scales, norms), the scores, per query the
// candidate flags (one word per row slot of 8), its list's tail (value,
// id), scale, scope id, candidate count and 32-entry candidate buffer, then
// the lists. Every part but the lists is a multiple of 16 bytes.
struct TiledLayout {
  int qta, q_stride, r_stride;
  size_t q_res, stage, meta, sv, misc, lists, total;
};

__host__ __device__ inline TiledLayout tiled_layout(int kind, int qt,
                                                    int depth, int slice,
                                                    int q_resident, int k,
                                                    int smem_lists) {
  TiledLayout L;
  L.qta = (qt + 15) / 16 * 16;
  L.r_stride = pad_stride(depth_pad(kind, slice));
  L.q_stride = q_resident ? pad_stride(depth_pad(kind, depth)) : L.r_stride;
  L.q_res = q_resident ? static_cast<size_t>(L.qta) * L.q_stride : 0;
  const int rows = tile_rows(kind);
  L.stage = static_cast<size_t>(rows) * L.r_stride +
            (q_resident ? 0 : static_cast<size_t>(L.qta) * L.r_stride);
  L.meta = static_cast<size_t>(L.qta) * (rows / 8) + rows * 8;
  L.sv = static_cast<size_t>(L.qta) * (rows + 8) * 4;
  L.misc = static_cast<size_t>(L.qta) * (kWarps * 4 + 20 + 32 * 8);
  L.lists = smem_lists ? static_cast<size_t>(qt) * k * 8 : 0;
  L.total = L.q_res + kStages * (L.stage + L.meta) + L.sv + L.misc + L.lists;
  return L;
}

// The launch plan for a query tile of at most ``qt_cap``: the tile is
// halved while its top-k lists do not fit shared memory beside the ring
// (the lists go to their partial slots in device memory only when one
// query's do not fit); the query side stays resident when its padded rows
// fit kQResident. smem is 0 when nothing fits.
struct TiledPlan {
  int qt, slice, q_resident, smem_lists;
  size_t smem;
};

TiledPlan tiled_plan(int kind, int qt_cap, int depth, int k) {
  const int slice = depth < tiled_slice(kind) ? depth : tiled_slice(kind);
  auto fit = [&](int qt, int smem_lists) {
    const int q_resident = static_cast<size_t>((qt + 15) / 16 * 16) *
                               pad_stride(depth_pad(kind, depth)) <=
                           static_cast<size_t>(kQResident);
    const size_t smem =
        tiled_layout(kind, qt, depth, slice, q_resident, k, smem_lists).total;
    return TiledPlan{qt, slice, q_resident, smem_lists,
                     smem <= static_cast<size_t>(kSmemLimit) ? smem : 0};
  };
  int lists_qt = qt_cap;
  while (fit(lists_qt, 1).smem == 0 && lists_qt > 1)
    lists_qt = lists_qt / 2 > 1 ? lists_qt / 2 : 1;
  const TiledPlan with_lists = fit(lists_qt, 1);
  return with_lists.smem != 0 ? with_lists : fit(qt_cap, 0);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's cp.async groups have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy ``nrows`` rows of ``row_bytes`` bytes (source rows ``src_stride``
// apart) into shared rows ``dst_stride`` apart, neighbouring threads on
// neighbouring bytes: cp.async of ``width`` (16 or 4) bytes, or byte loads
// and stores for width 1 (synchronous; the next __syncthreads publishes
// them like the cp.async groups).
__device__ void stage_copy(unsigned char* dst, int dst_stride,
                           const unsigned char* src, size_t src_stride,
                           int nrows, int row_bytes, int width) {
  const int per = row_bytes / width;
  const int total = nrows * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per;
    const int c = (i - r * per) * width;
    unsigned char* d = dst + r * dst_stride + c;
    const unsigned char* s = src + r * src_stride + c;
    if (width == 16)
      cp_async16(d, s);
    else if (width == 4)
      cp_async4(d, s);
    else
      *d = __ldg(s);
  }
}

// zero bytes [from, to) of ``nrows`` shared rows ``stride`` apart
__device__ void zero_cols(unsigned char* dst, int stride, int nrows, int from,
                          int to) {
  const int w = to - from;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < nrows * w; i += blockDim.x) {
    const int r = i / w;
    dst[r * stride + from + (i - r * w)] = 0;
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D = A (16 x 32, s8, row) * B (32 x 8, s8, col) + D, int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// threads of the tiled pass 1: 8 warps for fp32, 16 for int8
__host__ __device__ constexpr int tiled_threads(int kind) {
  return kind == kI8 ? 512 : 256;
}

template <int kKind, bool kL2, bool kWide>
__global__ void __launch_bounds__(tiled_threads(kKind), 1)
scan_pass1_tiled(const TiledScan p) {
  constexpr int kNw = tiled_threads(kKind) / 32;   // warps
  constexpr int kTileR = tile_rows(kKind);          // rows per row tile
  constexpr int kSvStride = kTileR + 8;             // score row stride
  constexpr int kWq = kTileR / 32;                  // words per query
  constexpr int kEb = kKind == kF32 ? 4 : 1;    // bytes per element
  extern __shared__ __align__(16) unsigned char smem[];
  const TiledLayout L = tiled_layout(kKind, p.qt, p.depth, p.slice,
                                     p.q_resident, p.k, p.smem_lists);
  unsigned char* q_res = smem;
  unsigned char* ring = smem + L.q_res;
  unsigned char* meta = ring + kStages * L.stage;
  float* sv = reinterpret_cast<float*>(meta + kStages * L.meta);
  unsigned* flags = reinterpret_cast<unsigned*>(sv + L.qta * kSvStride);
  float* tail_v = reinterpret_cast<float*>(flags + L.qta * kWarps);
  int* tail_i = reinterpret_cast<int*>(tail_v + L.qta);
  float* qsc = reinterpret_cast<float*>(tail_i + L.qta);
  int* sid_s = reinterpret_cast<int*>(qsc + L.qta);
  int* bcnt = sid_s + L.qta;
  float* buf_v = reinterpret_cast<float*>(bcnt + L.qta);
  int* buf_i = reinterpret_cast<int*>(buf_v + L.qta * 32);
  float* lv_s = reinterpret_cast<float*>(buf_i + L.qta * 32);
  int* li_s = reinterpret_cast<int*>(lv_s + p.qt * p.k);

  const int k = p.k;
  const int q0 = blockIdx.x * p.qt;
  const int nqt = min(p.qt, p.nq - q0);
  const int chunk = blockIdx.y;
  const int r_begin = chunk * p.chunk_rows;
  const int r_end = min(p.n, r_begin + p.chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_bytes = static_cast<size_t>(p.depth) * kEb;
  const unsigned char* q_src =
      static_cast<const unsigned char*>(p.q) + q0 * row_bytes;
  const unsigned char* r_src = static_cast<const unsigned char*>(p.rows);
  auto list_off = [&](int j) {
    return (static_cast<size_t>(q0 + j) * gridDim.y + chunk) * k;
  };

  for (int i = threadIdx.x; i < nqt * k; i += blockDim.x) {
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
  for (int i = threadIdx.x; i < L.qta * kWarps; i += blockDim.x)
    flags[i] = 0u;
  for (int j = threadIdx.x; j < L.qta; j += blockDim.x) {
    tail_v[j] = kNegInf;        // an empty list's tail
    tail_i[j] = -1;
    bcnt[j] = 0;
    sid_s[j] = j < nqt ? p.sids[q0 + j] : -1;
    qsc[j] = (kKind == kI8 && j < nqt) ? p.q_scale[q0 + j] : 0.0f;
  }
  if (p.q_resident) {           // padding: the depth tail, missing queries
    zero_cols(q_res, L.q_stride, nqt, static_cast<int>(row_bytes),
              L.q_stride);
    zero_cols(q_res + nqt * L.q_stride, L.q_stride, L.qta - nqt, 0,
              L.q_stride);
  }
  __syncthreads();              // sid_s before the first meta copy
  if (p.q_resident)             // joins the first item's group
    stage_copy(q_res, L.q_stride, q_src, row_bytes, nqt,
               static_cast<int>(row_bytes), p.q_width);

  const int ns = (p.depth + p.slice - 1) / p.slice;
  const int n_tiles =
      r_end > r_begin ? (r_end - r_begin + kTileR - 1) / kTileR : 0;
  const int total = n_tiles * ns;

  // item = (row tile t, depth slice s), staged into ring stage
  // item % kStages; a tile's first slice also stages its meta into slot
  // t % kStages (at most kStages tiles are in flight)
  auto issue = [&](int item) {
    if (item < total) {
      const int t = item / ns;
      const int s = item - t * ns;
      const int r0 = r_begin + t * kTileR;
      const int c0 = s * p.slice;
      const int len = min(p.slice, p.depth - c0);
      const int padb = depth_pad(kKind, len);
      unsigned char* stage = ring + (item % kStages) * L.stage;
      const int nr = min(kTileR, r_end - r0);
      const unsigned char* src = r_src + r0 * row_bytes + c0 * kEb;
      stage_copy(stage, L.r_stride, src, row_bytes, nr, len * kEb,
                 p.row_width);
      if (kKind == kF32)        // fp32 pads must be 0 (0 * NaN is NaN)
        zero_cols(stage, L.r_stride, kTileR, len * kEb, padb);
      if (!p.q_resident) {
        unsigned char* qs = stage + kTileR * L.r_stride;
        stage_copy(qs, L.r_stride, q_src + c0 * kEb, row_bytes, nqt,
                   len * kEb, p.q_width);
        zero_cols(qs, L.r_stride, nqt, len * kEb, padb);
      }
      if (s == 0) {
        unsigned char* m = meta + (t % kStages) * L.meta;
        uint32_t* ws = reinterpret_cast<uint32_t*>(m);
        float* rsc = reinterpret_cast<float*>(ws + L.qta * kWq);
        float* sqs = rsc + kTileR;
        for (int i = threadIdx.x; i < L.qta * kWq; i += blockDim.x) {
          const int sid = sid_s[i / kWq];
          const int wi = (r0 >> 5) + i % kWq;
          if (sid >= 0 && sid < p.n_scopes && wi < p.n_words)
            cp_async4(ws + i,
                      p.words + static_cast<size_t>(sid) * p.n_words + wi);
          else
            ws[i] = 0u;
        }
        for (int i = threadIdx.x; i < kTileR; i += blockDim.x) {
          const bool in = r0 + i < r_end;
          if (kKind == kI8) {
            if (in)
              cp_async4(rsc + i, p.row_scale + r0 + i);
            else
              rsc[i] = 0.0f;
          }
          if (kL2) {
            if (in)
              cp_async4(sqs + i, p.sq + r0 + i);
            else
              sqs[i] = 0.0f;
          }
        }
      }
    }
    cp_async_commit();          // empty groups keep the count uniform
  };

  issue(0);

  // merge query j's ``cnt`` buffered candidates into its list (warp-owned),
  // then publish the list's tail
  auto flush = [&](int j, int cnt) {
    __syncwarp();
    float* wl = p.smem_lists ? lv_s + j * k : p.part_v + list_off(j);
    int* wi = p.smem_lists ? li_s + j * k : p.part_i + list_off(j);
    const bool in = lane < cnt;
    warp_offer<kWide ? kMergeSlotsWide : kMergeSlots>(
        wl, wi, k, in ? buf_v[j * 32 + lane] : kNegInf,
        in ? buf_i[j * 32 + lane] : -1, in);
    __syncwarp();
    if (lane == 0) {
      tail_v[j] = wl[k - 1];
      tail_i[j] = wi[k - 1];
      bcnt[j] = 0;
    }
    __syncwarp();
  };

  // fp32: warp w = (query group w / 2, row half w % 2), lane = (query
  // half lane % 2, row sixteenth lane / 2): queries 16 g + q2 + 2 i, rows
  // 128 h + r16 + 16 r, 8 x 8 accumulators. int8: warp w = rows
  // 16 (w % 8)..+15 against query groups 2 (w / 8) and 2 (w / 8) + 1 (the
  // mma fragments' own lane layout). Either way flags slot w % 8 of a query
  // is the warp that scored row rr: rr / 128 + 2 (j / 16) (fp32), rr / 16
  // (int8).
  const int fg = warp >> 1, fh = warp & 1;
  const int fq = lane & 1, fr = lane >> 1;
  const int rb = warp & 7, mp = warp >> 3;
  float facc[8][8];
  int iacc[2][2][4];
  bool live[2] = {false, false};  // fp32: [0]; int8: its two query groups

  for (int item = 0; item < total; ++item) {
    cp_async_wait_all();        // item's stage has landed ...
    __syncthreads();            // ... for every thread, and item - 1 is done
    issue(item + 1);
    const int t = item / ns;
    const int s = item - t * ns;
    const int r0 = r_begin + t * kTileR;
    const int c0 = s * p.slice;
    const int len = min(p.slice, p.depth - c0);
    const unsigned char* stage = ring + (item % kStages) * L.stage;
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(meta + (t % kStages) * L.meta);
    const float* rsc = reinterpret_cast<const float*>(ws + L.qta * kWq);
    const float* sqs = rsc + kTileR;
    const unsigned char* qbase =
        p.q_resident ? q_res + c0 * kEb : stage + kTileR * L.r_stride;

    if (s == 0) {               // a new row tile: which products run
      if constexpr (kKind == kF32) {
        const int j = 16 * fg + (lane & 15);
        const int w = j * kWq + 4 * fh + 2 * (lane >> 4);
        const bool any = j < L.qta && (ws[w] | ws[w + 1]) != 0u;
        live[0] = __any_sync(kAll, any);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < 8; ++r) facc[i][r] = 0.0f;
      } else {
        const uint32_t rmask = 0xffffu << ((16 * rb) & 31);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int j = 16 * (2 * mp + m) + (lane & 15);
          const bool any =
              j < L.qta && (ws[j * kWq + (rb >> 1)] & rmask) != 0u;
          live[m] = __any_sync(kAll, any);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[m][nt][e] = 0;
        }
      }
    }

    if constexpr (kKind == kF32) {
      if (live[0]) {
        const int qs = L.q_stride / 4, xs = L.r_stride / 4;
        const float* qp =
            reinterpret_cast<const float*>(qbase) + (16 * fg + fq) * qs;
        const float* xp =
            reinterpret_cast<const float*>(stage) + (128 * fh + fr) * xs;
        const int len4 = depth_pad(kF32, len) / 4;
#pragma unroll 1
        for (int c = 0; c < len4; c += 4) {
          float4 qv[8], xv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qp + 2 * i * qs + c);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            xv[r] = *reinterpret_cast<const float4*>(xp + 16 * r * xs + c);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              facc[i][r] = fmaf(qv[i].x, xv[r].x, facc[i][r]);
              facc[i][r] = fmaf(qv[i].y, xv[r].y, facc[i][r]);
              facc[i][r] = fmaf(qv[i].z, xv[r].z, facc[i][r]);
              facc[i][r] = fmaf(qv[i].w, xv[r].w, facc[i][r]);
            }
        }
      }
    } else {
      if (live[0] || live[1]) {
        const int qs = L.q_stride;
        const unsigned xa = smem_addr(
            stage + (16 * rb + (lane & 7) + (lane >> 4) * 8) * L.r_stride +
            ((lane >> 3) & 1) * 16);
        const unsigned qa = smem_addr(
            qbase + (32 * mp + (lane & 7) + ((lane >> 3) & 1) * 8) * qs +
            (lane >> 4) * 16);
        const int len32 = depth_pad(kI8, len);
        for (int kk = 0; kk < len32; kk += 32) {
          unsigned b[4];
          ldmatrix_x4(b, xa + kk);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (live[m]) {
              unsigned a[4];
              ldmatrix_x4(a, qa + m * 16 * qs + kk);
              mma_s8(iacc[m][0], a, b[0], b[1]);
              mma_s8(iacc[m][1], a, b[2], b[3]);
            }
          }
        }
      }
    }

    if (s != ns - 1) continue;
    // epilogue: per query, the scores of admitted pairs that beat its list
    // tail; a warp that has any for query j writes its rows' scores
    // (-FLT_MAX for the others) and flags[j * 8 + w], which says so
    if constexpr (kKind == kF32) {
      if (16 * fg < L.qta) {
        float sqr[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          sqr[r] = kL2 ? sqs[128 * fh + fr + 16 * r] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = 16 * fg + fq + 2 * i;
          const float tv = tail_v[j];
          const int ti = tail_i[j];
          uint32_t wq[4];                            // rows 128 fh..+127
#pragma unroll
          for (int w = 0; w < 4; ++w) wq[w] = ws[j * kWq + 4 * fh + w];
          float v[8];
          bool any = false;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int rr = 128 * fh + fr + 16 * r;   // word 4 fh + r / 2
            v[r] = kNegInf;
            if (live[0] && r0 + rr < r_end &&
                ((wq[r >> 1] >> (fr + 16 * (r & 1))) & 1u)) {
              const float sc = Scorer<kF32>::template finish<kL2>(
                  facc[i][r], 1.0f, 1.0f, sqr[r]);
              if (better(sc, r0 + rr, tv, ti)) v[r] = sc;
            }
            any |= v[r] > kNegInf;
          }
          const unsigned mine =
              (__ballot_sync(kAll, any) >> fq) & 0x55555555u;
          if (mine) {
#pragma unroll
            for (int r = 0; r < 8; ++r)
              sv[j * kSvStride + 128 * fh + fr + 16 * r] = v[r];
          }
          if (fr == 0) flags[j * kWarps + warp] = mine;
        }
      }
    } else {
      const int g8 = lane >> 2, t4 = lane & 3;
      float rs[4], sqr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {               // e = 2 nt + lo
        const int rr = 16 * rb + 8 * (e >> 1) + 2 * t4 + (e & 1);
        rs[e] = rsc[rr];
        sqr[e] = kL2 ? sqs[rr] : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (16 * (2 * mp + m) >= L.qta) continue;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int j = 16 * (2 * mp + m) + g8 + 8 * hi;
          const float tv = tail_v[j];
          const int ti = tail_i[j];
          const float qscale = qsc[j];
          const uint32_t wd = ws[j * kWq + (rb >> 1)];
          float v[4];
          bool any = false;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = 16 * rb + 8 * (e >> 1) + 2 * t4 + (e & 1);
            v[e] = kNegInf;
            if (live[m] && r0 + rr < r_end && ((wd >> (rr & 31)) & 1u)) {
              const float sc = Scorer<kI8>::template finish<kL2>(
                  iacc[m][e >> 1][2 * hi + (e & 1)], qscale, rs[e], sqr[e]);
              if (better(sc, r0 + rr, tv, ti)) v[e] = sc;
            }
            any |= v[e] > kNegInf;
          }
          const unsigned mine = (__ballot_sync(kAll, any) >> (4 * g8)) & 0xfu;
          if (mine) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sv[j * kSvStride + 16 * rb + 8 * (e >> 1) + 2 * t4 +
                 (e & 1)] = v[e];
          }
          if (t4 == 0) flags[j * kWarps + rb] = mine;
        }
      }
    }
    __syncthreads();
    // warp w gathers the candidates of queries w, w + kNw, ... into their
    // 32-entry buffers; a full buffer is merged into the list first
    for (int j = warp; j < nqt; j += kNw) {
      // f[s]: flags slot s of query j (fp32 uses slots 2 (j / 16) + h)
      unsigned f[kWarps] = {};
      if constexpr (kKind == kF32) {
        f[0] = flags[j * kWarps + 2 * (j >> 4)];
        f[1] = flags[j * kWarps + 2 * (j >> 4) + 1];
        if ((f[0] | f[1]) == 0u) continue;
      } else {
        const uint4 f0 = *reinterpret_cast<const uint4*>(flags + j * kWarps);
        const uint4 f1 =
            *reinterpret_cast<const uint4*>(flags + j * kWarps + 4);
        f[0] = f0.x, f[1] = f0.y, f[2] = f0.z, f[3] = f0.w;
        f[4] = f1.x, f[5] = f1.y, f[6] = f1.z, f[7] = f1.w;
        if ((f[0] | f[1] | f[2] | f[3] | f[4] | f[5] | f[6] | f[7]) == 0u)
          continue;
      }
      int cnt = bcnt[j];
#pragma unroll
      for (int b = 0; b < kTileR; b += 32) {
        // the warp that wrote rows b..b+31 of query j: row half b / 128
        // (fp32), or the warps of rows b..b+15 and b+16..b+31 (int8)
        const int s0 = kKind == kF32 ? b >> 7 : b >> 4;
        const int s1 = kKind == kF32 ? s0 : s0 + 1;
        if ((f[s0] | f[s1]) == 0u) continue;
        const unsigned fl = lane < 16 ? f[s0] : f[s1];
        const int rr = b + lane;
        const float v = fl ? sv[j * kSvStride + rr] : kNegInf;
        const bool ok = v > kNegInf;
        const unsigned bal = __ballot_sync(kAll, ok);
        if (bal == 0u) continue;
        if (cnt + __popc(bal) > 32) {
          flush(j, cnt);
          cnt = 0;
        }
        if (ok) {
          const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
          buf_v[j * 32 + pos] = v;
          buf_i[j * 32 + pos] = r0 + rr;
        }
        cnt += __popc(bal);
      }
      __syncwarp();
      if (lane == 0) bcnt[j] = cnt;
    }
  }
  __syncwarp();
  for (int j = warp; j < nqt; j += kNw)
    if (bcnt[j] > 0) flush(j, bcnt[j]);
  cp_async_wait_all();
  __syncthreads();
  if (p.smem_lists) {
    for (int i = threadIdx.x; i < nqt * k; i += blockDim.x) {
      const int j = i / k;
      const int s = i - j * k;
      p.part_v[list_off(j) + s] = lv_s[i];
      p.part_i[list_off(j) + s] = li_s[i];
    }
  }
}

template <int kKind, bool kL2>
cudaError_t launch_tiled(dim3 grid, size_t smem, cudaStream_t stream,
                         const TiledScan& p) {
  // lists past 32 kMergeSlots entries take the wide merge's variant
  auto kern = p.k > 32 * kMergeSlots ? scan_pass1_tiled<kKind, kL2, true>
                                     : scan_pass1_tiled<kKind, kL2, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, tiled_threads(kKind), smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ streaming pass 1 (dense fp32)
constexpr int kStreamThreads = 128;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamRows = kStreamThreads;   // rows per tile: one a thread
constexpr int kStreamStages = 3;          // ring: 2 items in flight
constexpr int kStreamSlice = 64;          // floats of a row per item
constexpr int kStreamBlocks = 4;          // most blocks an SM is planned for
constexpr int kStreamQ = 8;               // largest query tile
constexpr int kSmemPerSM = 233472;        // shared memory of one SM
constexpr int kSmemPerBlock = 1024;       // ... the system keeps per block

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct StreamScan {
  const float* q;          // (nq, depth)
  const float* rows;       // (n, depth)
  const float* sq;         // l2: (n,)
  const int8_t* mask;      // (n,), non-zero admits the row
  int nq, n, depth, slice, k, qt, chunk_rows, smem_lists, lists;
  int row_width, q_width;  // copy width in bytes: 16 or 4
  float* part_v;
  int* part_i;
};

// Shared memory of the streaming pass 1: the ring (each stage a row tile's
// depth slice and the query tile's, rows padded to an odd number of
// 16-byte units), then per warp and query a top-k list when they fit.
struct StreamLayout {
  int r_stride;
  size_t stage, lists, total;
};

__host__ __device__ inline StreamLayout stream_layout(int qt, int slice,
                                                      int k,
                                                      int smem_lists) {
  StreamLayout L;
  L.r_stride = pad_stride(depth_pad(kF32, slice));
  L.stage = static_cast<size_t>(kStreamRows + qt) * L.r_stride;
  L.lists = smem_lists ? static_cast<size_t>(kStreamWarps) * qt * k * 8 : 0;
  L.total = kStreamStages * L.stage + L.lists;
  return L;
}

// The largest query tile up to ``qt_cap`` whose per-warp lists fit shared
// memory beside the ring; past that the lists live in device memory, one
// partial per warp (``lists`` partials per chunk). ``blocks``: how many
// such blocks one SM holds (1 or 2), which the wrapper sizes the grid by.
struct StreamPlan {
  int qt, slice, smem_lists, lists, blocks;
  size_t smem;
};

StreamPlan stream_plan(int qt_cap, int depth, int k) {
  StreamPlan P{qt_cap, depth < kStreamSlice ? depth : kStreamSlice, 0,
               kStreamWarps, 1, 0};
  for (int qt = qt_cap; qt >= 1; --qt) {
    const size_t smem = stream_layout(qt, P.slice, k, 1).total;
    if (smem <= static_cast<size_t>(kSmemLimit)) {
      P.qt = qt;
      P.smem_lists = 1;
      P.lists = 1;
      P.smem = smem;
      break;
    }
  }
  if (P.smem == 0) P.smem = stream_layout(qt_cap, P.slice, k, 0).total;
  const int fit = kSmemPerSM / static_cast<int>(P.smem + kSmemPerBlock);
  P.blocks = fit < 1 ? 1 : fit > kStreamBlocks ? kStreamBlocks : fit;
  return P;
}

// Kernel 1 (scoped_topk): query tile of qt <= 8 (kQ = 1 compiles the
// q = 1 scan alone) x row chunk. Item = (128-row tile, 64-float depth
// slice), copied with cp.async into ring stage item % 3 by all threads
// (neighbouring threads on neighbouring 16 bytes), two items ahead of the
// one computed. Thread t owns row t of every tile: its chain
// acc = fmaf(q[c], x[c], acc), c = 0..d-1 from 0.0f, continues across the
// slices out of shared memory (the query slice is a broadcast). At a
// tile's end each warp offers its 32 rows' scores to its own per-query
// lists: only lanes that beat the list's tail (kept in registers) take
// part, and several winners merge at once (warp_merge). No block barrier
// waits on a merge; the warps' lists are merged once at the chunk's end.
template <bool kL2, int kQ, bool kWide>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocks)
scan_pass1_stream(const StreamScan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StreamLayout L = stream_layout(p.qt, p.slice, p.k, p.smem_lists);
  unsigned char* ring = smem;
  float* lv_s = reinterpret_cast<float*>(smem + kStreamStages * L.stage);
  int* li_s = reinterpret_cast<int*>(
      lv_s + static_cast<size_t>(kStreamWarps) * p.qt * p.k);

  const int k = p.k;
  const int q0 = blockIdx.x * p.qt;
  const int nqt = min(p.qt, p.nq - q0);
  const int chunk = blockIdx.y;
  const int r_begin = chunk * p.chunk_rows;
  const int r_end = min(p.n, r_begin + p.chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_bytes = static_cast<size_t>(p.depth) * 4;
  // warp w's list of query j: in shared memory, or partial w of the chunk
  auto list_at = [&](int w, int j) {
    return p.smem_lists
               ? (static_cast<size_t>(w) * p.qt + j) * k
               : ((static_cast<size_t>(q0 + j) * gridDim.y + chunk) *
                      p.lists + w) * k;
  };
  float* const lv = p.smem_lists ? lv_s : p.part_v;
  int* const li = p.smem_lists ? li_s : p.part_i;
  float tv[kQ];                 // the warp's lists' tails
  int ti[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    tv[j] = kNegInf;
    ti[j] = -1;
  }
  for (int j = 0; j < nqt; ++j)
    for (int e = lane; e < k; e += 32) {
      lv[list_at(warp, j) + e] = kNegInf;
      li[list_at(warp, j) + e] = -1;
    }
  __syncwarp();

  const int ns = (p.depth + p.slice - 1) / p.slice;
  const int n_tiles = r_end > r_begin
                          ? (r_end - r_begin + kStreamRows - 1) / kStreamRows
                          : 0;
  const int total = n_tiles * ns;
  const unsigned char* r_src = reinterpret_cast<const unsigned char*>(p.rows);
  const unsigned char* q_src =
      reinterpret_cast<const unsigned char*>(p.q) + q0 * row_bytes;
  auto issue = [&](int item) {
    if (item < total) {
      const int t = item / ns;
      const int s = item - t * ns;
      const int r0 = r_begin + t * kStreamRows;
      const int c0 = s * p.slice;
      const int len = min(p.slice, p.depth - c0);
      const int padb = depth_pad(kF32, len);
      unsigned char* stage = ring + (item % kStreamStages) * L.stage;
      unsigned char* qs = stage + kStreamRows * L.r_stride;
      stage_copy(stage, L.r_stride, r_src + r0 * row_bytes + c0 * 4,
                 row_bytes, min(kStreamRows, r_end - r0), len * 4,
                 p.row_width);
      stage_copy(qs, L.r_stride, q_src + c0 * 4, row_bytes, nqt, len * 4,
                 p.q_width);
      if (padb > len * 4) {     // fp32 pads must be 0 (0 * NaN is NaN)
        zero_cols(stage, L.r_stride, kStreamRows, len * 4, padb);
        zero_cols(qs, L.r_stride, nqt, len * 4, padb);
      }
    }
    cp_async_commit();          // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < kStreamStages - 1; ++i) issue(i);

  float acc[kQ];
  float sqr = 0.0f;
  int8_t mk = 0;
  const int qs4 = L.r_stride / 4;
  for (int item = 0; item < total; ++item) {
    cp_async_wait<kStreamStages - 2>();  // item's stage has landed ...
    __syncthreads();            // ... for all, and item - 1 is consumed
    issue(item + kStreamStages - 1);
    const int t = item / ns;
    const int s = item - t * ns;
    const int r = r_begin + t * kStreamRows + threadIdx.x;
    const int len = min(p.slice, p.depth - s * p.slice);
    const unsigned char* stage = ring + (item % kStreamStages) * L.stage;
    if (s == 0) {               // a new tile; its mask and norm are read
#pragma unroll                  // here and used at its end
      for (int j = 0; j < kQ; ++j) acc[j] = 0.0f;
      mk = r < r_end ? p.mask[r] : 0;
      if (kL2) sqr = r < r_end ? p.sq[r] : 0.0f;
    }
    const float* xr =
        reinterpret_cast<const float*>(stage + threadIdx.x * L.r_stride);
    const float* qv0 =
        reinterpret_cast<const float*>(stage + kStreamRows * L.r_stride);
    const int len4 = depth_pad(kF32, len) / 4;
    for (int c = 0; c < len4; c += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + c);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (kQ == 1 || j < nqt) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qv0 + j * qs4 + c);
          acc[j] = fmaf(qv.x, xv.x, acc[j]);
          acc[j] = fmaf(qv.y, xv.y, acc[j]);
          acc[j] = fmaf(qv.z, xv.z, acc[j]);
          acc[j] = fmaf(qv.w, xv.w, acc[j]);
        }
      }
    }
    if (s != ns - 1) continue;
    const bool adm = mk != 0;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (kQ == 1 || j < nqt) {
        const float sc =
            Scorer<kF32>::template finish<kL2>(acc[j], 1.0f, 1.0f, sqr);
        const bool win = adm && better(sc, r, tv[j], ti[j]);
        if (__any_sync(kAll, win)) {
          float* wl = lv + list_at(warp, j);
          int* wi = li + list_at(warp, j);
          warp_offer<kWide ? kMergeSlotsWide : kMergeSlots>(wl, wi, k, sc,
                                                            r, win);
          __syncwarp();
          tv[j] = wl[k - 1];
          ti[j] = wi[k - 1];
        }
      }
    }
  }
  cp_async_wait_all();
  if (!p.smem_lists) return;    // each warp's list is a partial of its own
  __syncthreads();
  for (int j = warp; j < nqt; j += kStreamWarps) {
    float* lv0 = lv_s + list_at(0, j);
    int* li0 = li_s + list_at(0, j);
    for (int w = 1; w < kStreamWarps; ++w)
      merge_sorted(lv0, li0, k, lv_s + list_at(w, j), li_s + list_at(w, j));
    __syncwarp();
    const size_t off = (static_cast<size_t>(q0 + j) * gridDim.y + chunk) * k;
    for (int e = lane; e < k; e += 32) {
      p.part_v[off + e] = lv0[e];
      p.part_i[off + e] = li0[e];
    }
  }
}

template <bool kL2, int kQ>
cudaError_t launch_stream(dim3 grid, size_t smem, cudaStream_t stream,
                          const StreamScan& p) {
  auto kern = p.k > 32 * kMergeSlots ? scan_pass1_stream<kL2, kQ, true>
                                     : scan_pass1_stream<kL2, kQ, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kStreamThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------- tiled pass 1 (PQ, scope words)
constexpr int kPQWarps = 16;
constexpr int kPQThreads = kPQWarps * 32;
constexpr int kPQRows = kPQThreads;       // rows per tile: one per thread
constexpr int kPQMaxQ = 8;                // largest query tile
constexpr int kPQStages = 2;
constexpr int kPQWords = kPQRows / 32;    // scope words per query and tile

struct PQScan {
  const float* lut;        // (nq, depth, 256)
  const uint8_t* codes;    // (n, depth)
  const uint32_t* words;   // (n_scopes, n_words)
  const int* sids;         // (nq,)
  int n_scopes, n_words;
  int nq, n, depth, slice, k, qt, resident, chunk_rows, smem_lists;
  int code_width, lut_width;   // copy width in bytes: 16, 4 or 1
  float* part_v;
  int* part_i;
};

// Shared memory of the PQ pass 1, in this order: the tile's resident LUTs
// (qt x depth x 256 floats, when they fit), the ring (each stage: the row
// tile's code slice, rows padded to an odd number of 16-byte units, the
// query tile's LUT slice when not resident, and the tile's scope words),
// the winners' scores, per query its flags (one word per warp), list tail
// (value, id), scope id, candidate count and 32-entry candidate buffer,
// then the lists. Every part but the lists is a multiple of 16 bytes.
struct PQLayout {
  int c_stride;
  size_t lut, codes, lut_slice, stage, sv, misc, lists, total;
};

__host__ __device__ inline PQLayout pq_layout(int qt, int depth, int slice,
                                              int resident, int k,
                                              int smem_lists) {
  PQLayout L;
  L.c_stride = pad_stride(slice);
  L.lut = resident ? static_cast<size_t>(qt) * depth * 1024 : 0;
  L.codes = static_cast<size_t>(kPQRows) * L.c_stride;
  L.lut_slice = resident ? 0 : static_cast<size_t>(qt) * slice * 1024;
  L.stage = L.codes + L.lut_slice + static_cast<size_t>(qt) * kPQWords * 4;
  L.sv = static_cast<size_t>(qt) * kPQRows * 4;
  L.misc = static_cast<size_t>(qt) * (kPQWords + 4 + 64) * 4;
  L.lists = smem_lists ? static_cast<size_t>(qt) * k * 8 : 0;
  L.total = L.lut + kPQStages * L.stage + L.sv + L.misc + L.lists;
  return L;
}

// The largest query tile up to min(qt_cap, 8) whose LUTs stay resident
// with the lists in shared memory, else with the lists in their partial
// slots; when one query's LUT does not fit, a tile of one query whose LUT
// rides in each stage in slices of the M axis (multiples of 16 where
// possible). smem is 0 when nothing fits.
struct PQPlan {
  int qt, slice, resident, smem_lists;
  size_t smem;
};

PQPlan pq_plan(int qt_cap, int depth, int k) {
  const size_t limit = static_cast<size_t>(kSmemLimit);
  if (qt_cap > kPQMaxQ) qt_cap = kPQMaxQ;
  for (int lists = 1; lists >= 0; --lists)
    for (int qt = qt_cap; qt >= 1; --qt) {
      const size_t smem = pq_layout(qt, depth, depth, 1, k, lists).total;
      if (smem <= limit) return PQPlan{qt, depth, 1, lists, smem};
    }
  for (int lists = 1; lists >= 0; --lists)
    for (int slice = depth - 1; slice >= 1; --slice) {
      if (slice > 16 && slice % 16 != 0) continue;
      const size_t smem = pq_layout(1, depth, slice, 0, k, lists).total;
      if (smem <= limit) return PQPlan{1, slice, 0, lists, smem};
    }
  return PQPlan{1, 1, 0, 0, 0};
}

// Kernel 8 (multi_scope_topk_pq): query tile of qt <= 8 x row chunk, 16
// warps. The tile's LUTs are copied once into shared memory; code rows
// (and the tile's scope words) come through a two-stage cp.async ring,
// 512 rows a tile, thread t owning row t. A thread looks up only the
// queries that admit its row, acc += lut[j, m, code[m]] for m = 0..M-1 in
// order from 0.0f (Scorer<kPQ>'s chain); a warp whose rows no query of the
// tile admits skips the tile. Epilogue as scan_pass1_tiled's: scores that
// beat the list's tail go to shared memory, flagged per warp; warp j then
// gathers query j's into its 32-entry buffer and merges full buffers with
// warp_merge.
template <bool kWide>
__global__ void __launch_bounds__(kPQThreads, 1)
scan_pass1_pq(const PQScan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PQLayout L =
      pq_layout(p.qt, p.depth, p.slice, p.resident, p.k, p.smem_lists);
  float* lut_res = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L.lut;
  float* sv = reinterpret_cast<float*>(ring + kPQStages * L.stage);
  unsigned* flags = reinterpret_cast<unsigned*>(sv + p.qt * kPQRows);
  float* tail_v = reinterpret_cast<float*>(flags + p.qt * kPQWords);
  int* tail_i = reinterpret_cast<int*>(tail_v + p.qt);
  int* sid_s = tail_i + p.qt;
  int* bcnt = sid_s + p.qt;
  float* buf_v = reinterpret_cast<float*>(bcnt + p.qt);
  int* buf_i = reinterpret_cast<int*>(buf_v + p.qt * 32);
  float* lv_s = reinterpret_cast<float*>(buf_i + p.qt * 32);
  int* li_s = reinterpret_cast<int*>(lv_s + p.qt * p.k);

  const int k = p.k;
  const int q0 = blockIdx.x * p.qt;
  const int nqt = min(p.qt, p.nq - q0);
  const int chunk = blockIdx.y;
  const int r_begin = chunk * p.chunk_rows;
  const int r_end = min(p.n, r_begin + p.chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t lut_bytes = static_cast<size_t>(p.depth) * 1024;  // a query's
  auto list_off = [&](int j) {
    return (static_cast<size_t>(q0 + j) * gridDim.y + chunk) * k;
  };

  for (int i = threadIdx.x; i < nqt * k; i += kPQThreads) {
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
  for (int j = threadIdx.x; j < p.qt; j += kPQThreads) {
    tail_v[j] = kNegInf;        // an empty list's tail
    tail_i[j] = -1;
    bcnt[j] = 0;
    sid_s[j] = j < nqt ? p.sids[q0 + j] : -1;
  }
  __syncthreads();              // sid_s before the first words copy
  const unsigned char* lut_src =
      reinterpret_cast<const unsigned char*>(p.lut) + q0 * lut_bytes;
  if (p.resident)               // joins the first item's group
    stage_copy(smem, static_cast<int>(lut_bytes), lut_src, lut_bytes, nqt,
               static_cast<int>(lut_bytes), p.lut_width);

  const int ns = (p.depth + p.slice - 1) / p.slice;
  const int n_tiles =
      r_end > r_begin ? (r_end - r_begin + kPQRows - 1) / kPQRows : 0;
  const int total = n_tiles * ns;
  auto issue = [&](int item) {
    if (item < total) {
      const int t = item / ns;
      const int s = item - t * ns;
      const int r0 = r_begin + t * kPQRows;
      const int c0 = s * p.slice;
      const int len = min(p.slice, p.depth - c0);
      unsigned char* stage = ring + (item % kPQStages) * L.stage;
      stage_copy(stage, L.c_stride,
                 p.codes + static_cast<size_t>(r0) * p.depth + c0, p.depth,
                 min(kPQRows, r_end - r0), len, p.code_width);
      if (!p.resident)
        stage_copy(stage + L.codes, p.slice * 1024,
                   lut_src + static_cast<size_t>(c0) * 1024, lut_bytes, nqt,
                   len * 1024, p.lut_width);
      if (s == 0) {
        uint32_t* ws =
            reinterpret_cast<uint32_t*>(stage + L.codes + L.lut_slice);
        for (int i = threadIdx.x; i < p.qt * kPQWords; i += kPQThreads) {
          const int sid = sid_s[i / kPQWords];
          const int wi = (r0 >> 5) + i % kPQWords;
          if (sid >= 0 && sid < p.n_scopes && wi < p.n_words)
            cp_async4(ws + i,
                      p.words + static_cast<size_t>(sid) * p.n_words + wi);
          else
            ws[i] = 0u;
        }
      }
    }
    cp_async_commit();          // empty groups keep the count uniform
  };
  issue(0);

  // merge query j's ``cnt`` buffered candidates into its list (warp-owned),
  // then publish the list's tail
  auto flush = [&](int j, int cnt) {
    __syncwarp();
    float* wl = p.smem_lists ? lv_s + j * k : p.part_v + list_off(j);
    int* wi = p.smem_lists ? li_s + j * k : p.part_i + list_off(j);
    const bool in = lane < cnt;
    warp_offer<kWide ? kMergeSlotsWide : kMergeSlots>(
        wl, wi, k, in ? buf_v[j * 32 + lane] : kNegInf,
        in ? buf_i[j * 32 + lane] : -1, in);
    __syncwarp();
    if (lane == 0) {
      tail_v[j] = wl[k - 1];
      tail_i[j] = wi[k - 1];
      bcnt[j] = 0;
    }
    __syncwarp();
  };

  float acc[kPQMaxQ];
  unsigned admit = 0;           // bit j: query j admits this thread's row
  for (int item = 0; item < total; ++item) {
    cp_async_wait_all();        // item's stage has landed ...
    __syncthreads();            // ... for every thread, and item - 1 is done
    issue(item + 1);
    const int t = item / ns;
    const int s = item - t * ns;
    const int r0 = r_begin + t * kPQRows;
    const int r = r0 + threadIdx.x;
    const int c0 = s * p.slice;
    const int len = min(p.slice, p.depth - c0);
    const unsigned char* stage = ring + (item % kPQStages) * L.stage;
    if (s == 0) {               // a new tile: which queries admit the row
      const uint32_t* ws =
          reinterpret_cast<const uint32_t*>(stage + L.codes + L.lut_slice);
      admit = 0u;
#pragma unroll
      for (int j = 0; j < kPQMaxQ; ++j) {
        acc[j] = 0.0f;
        if (j < nqt && r < r_end)
          admit |= ((ws[j * kPQWords + warp] >> lane) & 1u) << j;
      }
    }
    // query by query: a lane runs query j's chain only when j admits its
    // row (one branch per query and slice, not per lookup), and a warp
    // skips query j when none of its rows is admitted
    const unsigned char* cr = stage + threadIdx.x * L.c_stride;
    const float* lq = p.resident
                          ? lut_res + c0 * 256
                          : reinterpret_cast<const float*>(stage + L.codes);
    const int qstride = (p.resident ? p.depth : p.slice) * 256;
#pragma unroll
    for (int j = 0; j < kPQMaxQ; ++j) {
      const bool in = (admit >> j) & 1u;
      if (j >= nqt || !__any_sync(kAll, in)) continue;
      if (in) {                 // 16 reads in flight, then 16 adds in order
        const float* lj = lq + j * qstride;
        float a = acc[j];
        int m = 0;
        for (; m + 16 <= len; m += 16) {
          const uint4 cw = *reinterpret_cast<const uint4*>(cr + m);
          const unsigned wd[4] = {cw.x, cw.y, cw.z, cw.w};
          const float* lm = lj + m * 256;
          float v[16];
#pragma unroll
          for (int b = 0; b < 16; ++b)   // byte b & 3 of the word, as an int
            v[b] = lm[b * 256 + static_cast<int>(__byte_perm(
                                    wd[b >> 2], 0u, 0x4440u + (b & 3)))];
#pragma unroll
          for (int b = 0; b < 16; ++b) a += v[b];
        }
        for (; m < len; ++m) a += lj[m * 256 + cr[m]];
        acc[j] = a;
      }
    }
    if (s != ns - 1) continue;
    // epilogue: per query, the admitted scores that beat its list's tail;
    // a warp with any writes its rows' scores and flags[j * 16 + w]
#pragma unroll
    for (int j = 0; j < kPQMaxQ; ++j) {
      if (j < nqt) {
        float v = kNegInf;
        if (((admit >> j) & 1u) && better(acc[j], r, tail_v[j], tail_i[j]))
          v = acc[j];
        const unsigned bal = __ballot_sync(kAll, v > kNegInf);
        if (bal) sv[j * kPQRows + threadIdx.x] = v;
        if (lane == 0) flags[j * kPQWords + warp] = bal;
      }
    }
    __syncthreads();
    // warp j gathers query j's candidates into its 32-entry buffer; a full
    // buffer is merged into the list first
    for (int j = warp; j < nqt; j += kPQWarps) {
      int cnt = bcnt[j];
      // lane w holds warp w's flags; only the warps with candidates are read
      const unsigned fw = lane < kPQWords ? flags[j * kPQWords + lane] : 0u;
      for (unsigned live = __ballot_sync(kAll, fw != 0u); live;
           live &= live - 1) {
        const int w = __ffs(live) - 1;
        const unsigned f = __shfl_sync(kAll, fw, w);
        if (cnt + __popc(f) > 32) {
          flush(j, cnt);
          cnt = 0;
        }
        if ((f >> lane) & 1u) {
          const int pos = cnt + __popc(f & ((1u << lane) - 1u));
          buf_v[j * 32 + pos] = sv[j * kPQRows + 32 * w + lane];
          buf_i[j * 32 + pos] = r0 + 32 * w + lane;
        }
        cnt += __popc(f);
      }
      __syncwarp();
      if (lane == 0) bcnt[j] = cnt;
    }
  }
  __syncwarp();
  for (int j = warp; j < nqt; j += kPQWarps)
    if (bcnt[j] > 0) flush(j, bcnt[j]);
  cp_async_wait_all();
  __syncthreads();
  if (p.smem_lists) {
    for (int i = threadIdx.x; i < nqt * k; i += kPQThreads) {
      const int j = i / k;
      const int s = i - j * k;
      p.part_v[list_off(j) + s] = lv_s[i];
      p.part_i[list_off(j) + s] = li_s[i];
    }
  }
}

cudaError_t launch_pq(dim3 grid, size_t smem, cudaStream_t stream,
                      const PQScan& p) {
  auto kern = p.k > 32 * kMergeSlots ? scan_pass1_pq<true>
                                     : scan_pass1_pq<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kPQThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the widest copy (16, 4 or 1 bytes) that every row start and slice start
// of ``base`` allows
int copy_width(const void* base, int row_bytes, int slice_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0 && row_bytes % 16 == 0 && slice_bytes % 16 == 0) return 16;
  if (a % 4 == 0 && row_bytes % 4 == 0 && slice_bytes % 4 == 0) return 4;
  return 1;
}

cudaError_t launch_pass2(const float* part_v, const int* part_i, int nq,
                         int n_chunks, int k, const int* cand, int n_cand,
                         float* out_v, int* out_i, cudaStream_t stream) {
  int nw = n_chunks >= 2 * kPass2Warps ? kPass2Warps : kWarps;
  if (static_cast<size_t>(nw) * k > kPass2SmemList)
    nw = static_cast<size_t>(kWarps) * k <= kPass2SmemList ? kWarps : 1;
  const size_t smem2 = static_cast<size_t>(nw) * k <= kPass2SmemList
                           ? sizeof(float) * 2 * nw * k
                           : 0;
  scan_pass2<<<nq, 32 * nw, smem2, stream>>>(part_v, part_i, n_chunks, k,
                                             cand, n_cand, out_v, out_i);
  return cudaGetLastError();
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

// scan_pass1 runs the gathered scans of every kind and the int8 and PQ
// dense-mask scans; the fp32 dense scan and every scoped scan have passes
// of their own
template <int kKind>
cudaError_t dispatch_mode(int mode, bool l2, bool vec, dim3 grid,
                          size_t smem, cudaStream_t stream, const Scan& p) {
  if (mode == kGathered)
    return dispatch_pass1<kKind, kGathered>(l2, vec, grid, smem, stream, p);
  if constexpr (kKind != kF32) {
    if (mode == kDense)
      return dispatch_pass1<kKind, kDense>(l2, vec, grid, smem, stream, p);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The entry point of scan_pass1's five scans (kind 0 fp32, 1 int8, 2 PQ):
// the int8 and PQ scans with one dense (n,) int8 ``mask`` shared by every
// query (scoped_topk_i8, scoped_topk_pq), and the gathered scans of every
// kind (ivf_gather_topk*): a non-null ``cand`` (nq, n) selects gathered
// mode, n is then the candidate count C per query, ``words`` (packed
// (n_scopes, n_words) masks, row sids[i] for query i) is required and qt
// must be 1. ``slice`` is the depth staged at once (depth = d, or M for
// PQ), ``qt`` the query tile, ``smem_lists`` whether the tile's lists fit
// in shared memory; the partials are (nq, n_chunks, k).
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
  const bool gathered = cand != nullptr;
  if (kind < kF32 || kind > kPQ || k < 1 || qt < 1 || qt > kWarps ||
      depth < 1 || slice < 1 || slice > depth || chunk_rows < 1 ||
      n_chunks < 1 || n_chunks > 65535 ||
      (gathered ? (words == nullptr || mask != nullptr || qt != 1 || n < 1)
                : (mask == nullptr || words != nullptr || kind == kF32)))
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
  const int mode = gathered ? kGathered : kDense;
  cudaError_t err =
      kind == kF32 ? dispatch_mode<kF32>(mode, l2, vec, grid1, smem1, stream, p)
      : kind == kI8 ? dispatch_mode<kI8>(mode, l2, vec, grid1, smem1, stream, p)
                    : dispatch_mode<kPQ>(mode, false, vec, grid1, smem1, stream, p);
  if (err != cudaSuccess) return err;
  return launch_pass2(part_v, part_i, nq, n_chunks, k, cand, n, out_v, out_i,
                      stream);
}

// The streaming pass 1's plan (kernel 1) for a query tile of at most
// ``qt_cap`` <= 8, depth ``depth`` and lists of ``k``: writes the query tile
// to ``qt``, the partial lists per chunk to ``lists`` (1, or 8 when the
// warps' lists live in device memory) and the blocks one SM holds to
// ``blocks``; returns the shared memory a block takes, 0 for bad arguments.
int repro_stream_plan(int qt_cap, int depth, int k, int* qt, int* lists,
                      int* blocks) {
  if (qt_cap < 1 || qt_cap > kStreamQ || depth < 1 || k < 1) return 0;
  const StreamPlan plan = stream_plan(qt_cap, depth, k);
  *qt = plan.qt;
  *lists = plan.lists;
  *blocks = plan.blocks;
  return static_cast<int>(plan.smem);
}

// Kernel 1, the fp32 scan with one dense (n,) int8 ``mask`` shared by every
// query (scoped_topk): scan_pass1_stream, then pass 2. ``qt_cap`` <= 8
// caps the query tile (stream_plan picks it); the partials are
// (nq, n_chunks * lists, k) for the plan's ``lists``.
int repro_scan_topk_stream(const float* q, const float* rows, const float* sq,
                           const int8_t* mask, int nq, int n, int depth,
                           int k, int l2, int qt_cap, int chunk_rows,
                           int n_chunks, float* part_v, int* part_i,
                           float* out_v, int* out_i, void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (k < 1 || qt_cap < 1 || qt_cap > kStreamQ || depth < 1 ||
      chunk_rows < 1 || n_chunks < 1 || n_chunks > 65535 || mask == nullptr ||
      (l2 && sq == nullptr))
    return cudaErrorInvalidValue;
  const StreamPlan plan = stream_plan(qt_cap, depth, k);
  StreamScan p{q, rows, sq, mask, nq, n, depth, plan.slice, k, plan.qt,
               chunk_rows, plan.smem_lists, plan.lists,
               copy_width(rows, depth * 4, plan.slice * 4),
               copy_width(q, depth * 4, plan.slice * 4), part_v, part_i};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((nq + plan.qt - 1) / plan.qt, n_chunks);
  cudaError_t err =
      plan.qt == 1
          ? (l2 ? launch_stream<true, 1>(grid, plan.smem, stream, p)
                : launch_stream<false, 1>(grid, plan.smem, stream, p))
          : (l2 ? launch_stream<true, kStreamQ>(grid, plan.smem, stream, p)
                : launch_stream<false, kStreamQ>(grid, plan.smem, stream, p));
  if (err != cudaSuccess) return err;
  return launch_pass2(part_v, part_i, nq, n_chunks * plan.lists, k, nullptr,
                      n, out_v, out_i, stream);
}

// The tiled passes' plan for kind 0 (fp32), 1 (int8) or 2 (PQ), a query
// tile of at most ``qt_cap``, depth ``depth`` (M for PQ) and lists of
// ``k``: writes the query tile to ``qt`` (the wrapper sizes the grid with
// it; passed back as the cap, it plans the same tile) and returns the
// shared memory a block takes, 0 when nothing fits.
int repro_tiled_plan(int kind, int qt_cap, int depth, int k, int* qt) {
  if (kind < kF32 || kind > kPQ || qt_cap < 1 || qt_cap > kTileQ ||
      depth < 1 || k < 1)
    return 0;
  if (kind == kPQ) {
    const PQPlan plan = pq_plan(qt_cap, depth, k);
    *qt = plan.qt;
    return static_cast<int>(plan.smem);
  }
  const TiledPlan plan = tiled_plan(kind, qt_cap, depth, k);
  *qt = plan.qt;
  return static_cast<int>(plan.smem);
}

// The scans with per-query scope words: multi_scope_topk and
// multi_scope_topk_i8 (kind 0, 1: scan_pass1_tiled) and multi_scope_topk_pq
// (kind 2: scan_pass1_pq, ``q`` the (nq, depth, 256) LUTs and ``rows`` the
// (n, depth) uint8 codes), then pass 2. ``qt_cap`` <= 64 caps the query
// tile (the plan picks the tile and the rest), ``chunk_rows`` is a multiple
// of 32. The partials are (nq, n_chunks, k).
int repro_scan_topk_tiled(int kind, const void* q, const float* q_scale,
                          const void* rows, const float* row_scale,
                          const float* sq, const uint32_t* words,
                          const int* sids, int n_scopes, int n_words, int nq,
                          int n, int depth, int k, int l2, int qt_cap,
                          int chunk_rows, int n_chunks, float* part_v,
                          int* part_i, float* out_v, int* out_i,
                          void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (kind < kF32 || kind > kPQ || k < 1 || qt_cap < 1 ||
      qt_cap > kTileQ || depth < 1 || chunk_rows < 32 ||
      chunk_rows % 32 != 0 || n_chunks < 1 || n_chunks > 65535 ||
      words == nullptr || sids == nullptr ||
      (kind == kI8 && (q_scale == nullptr || row_scale == nullptr)) ||
      (kind != kPQ && l2 && sq == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (kind == kPQ) {
    const PQPlan plan = pq_plan(qt_cap, depth, k);
    if (plan.smem == 0) return cudaErrorInvalidValue;
    PQScan p{static_cast<const float*>(q), static_cast<const uint8_t*>(rows),
             words, sids, n_scopes, n_words, nq, n, depth, plan.slice, k,
             plan.qt, plan.resident, chunk_rows, plan.smem_lists,
             copy_width(rows, depth, plan.slice),
             copy_width(q, depth * 1024, plan.slice * 1024), part_v, part_i};
    err = launch_pq(dim3((nq + plan.qt - 1) / plan.qt, n_chunks), plan.smem,
                    stream, p);
  } else {
    const TiledPlan plan = tiled_plan(kind, qt_cap, depth, k);
    if (plan.smem == 0) return cudaErrorInvalidValue;
    const int eb = kind == kF32 ? 4 : 1;
    TiledScan p{q, q_scale, rows, row_scale, sq, words, sids, n_scopes,
                n_words, nq, n, depth, plan.slice, k, plan.qt,
                plan.q_resident, chunk_rows, plan.smem_lists,
                copy_width(rows, depth * eb, plan.slice * eb),
                copy_width(q, depth * eb, plan.slice * eb), part_v, part_i};
    const dim3 grid((nq + plan.qt - 1) / plan.qt, n_chunks);
    err = kind == kF32
              ? (l2 ? launch_tiled<kF32, true>(grid, plan.smem, stream, p)
                    : launch_tiled<kF32, false>(grid, plan.smem, stream, p))
              : (l2 ? launch_tiled<kI8, true>(grid, plan.smem, stream, p)
                    : launch_tiled<kI8, false>(grid, plan.smem, stream, p));
  }
  if (err != cudaSuccess) return err;
  return launch_pass2(part_v, part_i, nq, n_chunks, k, nullptr, n, out_v,
                      out_i, stream);
}

}  // extern "C"
