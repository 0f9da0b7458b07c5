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
//   scan_pass1_stream  kernels 1, 5, 7 (scoped_topk, _i8, _pq): fp32 /
//                      int8 / PQ, one dense mask; kernel 9 fp32 / int8
//                      (list mode)
//   scan_pass1_tiled   kernels 2, 6 (multi_scope_topk, _i8): scope words
//   scan_pass1_pq      kernel 8 (multi_scope_topk_pq): PQ, scope words;
//                      kernel 9 PQ (list mode)
//
// scan_pass1_stream: bytes-bound (one pass over the rows).
//   grid (query tiles of qt <= 8, row chunks): one wave of blocks of 4
//   warps, two per SM for fp32 at q = 1 (110 KB of shared memory each),
//   so 262 chunks of whole 128-row tiles over 1.94M rows, three per SM for
//   int8 (62 KB); a gather plan's few thousand rows get one tile per block
//   (PQ: chunks of at least 1,024 rows, below).
//   staging: item = (128-row tile, depth slice: 64 floats, 256 int8 or
//           PQ code bytes); all 128 threads copy an item with 16-byte
//           cp.async (neighbouring threads on neighbouring bytes; 4-byte
//           or byte copies where rows start off 16-byte alignment), with
//           the query tile's slice, into a ring of 3 stages, two items
//           ahead of the one computed: fp32 64 KB of rows in flight per
//           block, 128 KB
//           per SM, against the ~25 KB per SM that 3.35 TB/s x ~1 us of
//           loaded latency needs. A tile's first item also stages the
//           tile's mask bytes, l2 norms and int8 row scales into one of 3
//           meta slots. (tools/scan_variants.py on the H100, kernel 1's
//           pass 1: 256-row tiles of 32-float slices 2% slower, of
//           16-float slices with 4 stages 50% slower; whole 128-float rows
//           in 64-row tiles 22% slower, in 128-row tiles with one block
//           per SM 29% slower.) Row strides are padded to an odd number of
//           16-byte units (272 bytes fp32, 144 int8), so a quarter warp's
//           16-byte reads hit 8 bank groups.
//   compute: thread t owns row t of each tile and runs its chain out of
//           shared memory (the query slice is a broadcast), across the
//           slices; kQ = 1 compiles the one-query scan of dsq alone. fp32:
//           acc = fmaf(q[c], x[c], acc), c = 0..d-1 from 0.0f, kernel 2's
//           chain, so kernel 2 == kernel 1 bit for bit. int8: an int32
//           __dp4a chain (exact in any order), then Scorer<kI8>'s finish,
//           kernel 6's, so kernel 6 == kernel 5 bit for bit.
//   PQ (kernel 7): an item is a 128-row tile's code bytes (up to 256 a
//           row; 48-byte strides at M = 32) and the mask bytes ride in the
//           meta slots. The query tile's (M, 256) LUTs are copied once
//           into shared memory with the first item's group and stay
//           resident (stream_plan); a LUT that does not fit beside the
//           ring rides in each item in slices of M instead, so any M works.
//           The scorer is kernel 8's lookup loop: a thread looks up only
//           queries that admit its row (a warp skips the queries none of
//           its rows admits), 16 reads in flight, then 16 adds in order,
//           acc += lut[j, m, code[m]] for m = 0..M-1 from 0.0f, so kernel
//           8 == kernel 7 bit for bit. The tile's LUT copy (qt M KB) must
//           not dwarf its codes: the wrapper gives a chunk at least 1,024
//           rows (one LUT's bytes of codes at M = 32) and the grid at most
//           one wave; the query tile is set for occupancy (kStreamPQQ = 1:
//           four blocks per SM at M = 32, k <= 80), not to the most LUTs
//           that fit, since re-reading 32-byte code rows once per query
//           costs less than fewer blocks per SM (tools/scan_variants.py on
//           the H100 at the PQ batch's widest gather, q = 5 over 41,829
//           rows, k = 80: tiles of 1 / 2 / 5 queries 0.070 / 0.094 / 0.155
//           ms device; chunk floors of 512 / 1,024 / 2,048 rows 0.066 /
//           0.070 / 0.082, 512 within its own run-to-run spread).
//   epilogue: each warp keeps its own list per query and its tail in
//           registers; rows whose score beats the best of the warps'
//           tails go to a 32-entry buffer per warp and query, merged into
//           the list 32 at a time (warp_merge) when full. A tile's votes
//           for all queries come first, with no branch between them, then
//           the rare appends. No barrier waits on a merge: the ring's one
//           barrier per item is the only one, and the warps' lists are
//           merged once, at the chunk's end. Lists live in shared memory
//           (the tile shrinks until they fit) or, past that, as one partial
//           per warp in device memory. Pass 2 merges a few queries'
//           hundreds of lists in two levels (launch_pass2).
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
//           (kernel 7's chain, so kernel 8 == kernel 7 bit for bit),
//           16 reads in flight before their 16 adds; a warp skips a query
//           that none of its rows admits. On the H100 this loop, not the
//           epilogue, takes most of the time, and it runs well below the
//           shared-memory read rate: codes whose reads never conflict save
//           only about a quarter, 8 warps are slower than 16
//           (tools/scan_variants.py, PERF.md).
//   epilogue: scan_pass1_tiled's (tail filter, flags per warp, 32-entry
//           buffers merged by warp_merge, warp j serving query j).
//   list mode (kernel 9's PQ mode): the chunk's compacted rows take 32 KB,
//           so 4 LUTs stay resident at M = 32, k = 80.
//
// List mode (kernel 9, ivf_gather_topk and its int8 / PQ modes): the IVF
// executor's padded-CSR layout read list by list. Query b probes nprobe
// lists; position p * max_aligned + o of its candidate axis is offset o of
// its p-th probed list (the reference's (B, nprobe * max_aligned) matrix,
// which is never built; offsets past a list's aligned length are padding).
// The wrapper sorts the (query, slot) pairs by list (stably, one small
// launch) and a block of scan_pass1_stream (fp32, int8) or scan_pass1_pq
// (PQ) owns one list's chunk of kListChunk positions and a tile of up to
// 8 queries that probe the list (grid: lists x query tiles, chunks of the
// widest list; blocks past a list's end or its queries return at once).
// The block first reads the chunk's ids and each query's scope bit of
// each, and keeps only the rows some query of the tile admits (padding,
// -1, admits none): each admitted row is then staged once for the whole
// tile, gathered with per-row cp.async (a row is one contiguous 512-,
// 128- or 32-byte run), and scored for the queries that admit it. So a row
// that several queries probe is read once per query tile, not once per
// query, and positions that admit nothing cost 4 bytes of id. A block's
// lists rank by (score, position) and land in the partial slot
// (b, p, chunk); pass 2 ranks by position too -- the reference's tie rule,
// jax.lax.top_k over the candidate axis -- skips the slots of chunks past
// a probed list's end, and maps a winner's position back to its store id,
// flat_ids[offsets[probe[b, p]] + o]. The (B, C) candidate form is the
// layout whose list b is query b's C candidates, probed by b alone.
// Bound: each probed list's ids once, the scope words, and each distinct
// admitted row once per query tile that admits it.
// The result is the exact top-k under a total order, and no atomics decide
// it (a list-mode block keeps its admitted rows in arrival order, which
// the lists' total order makes irrelevant): runs are bit-for-bit
// repeatable.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // pass 2's warps; the tiled
                                          // pass's flag slots per query
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPass2SmemList = 6144;      // pass 2 keeps lists of k <= this
                                          // in shared memory (48 KB)

enum Kind { kF32 = 0, kI8 = 1, kPQ = 2 };

// Kernel 9's list form (the source note's "List mode"): the padded-CSR
// layout, each query's probed lists, and their inversion -- the pairs
// b * nprobe + p sorted stably by the list probe[b, p] (``order``), and
// each list's first sorted pair (``list_start``). flat_ids == nullptr
// outside list mode.
struct ListArgs {
  const long long* offsets;   // (n_lists,) region start in flat_ids
  const long long* aligned;   // (n_lists,) region length, padding included
  const int* flat_ids;        // store ids, -1 = padding
  const int* probe;           // (nq, nprobe) probed lists
  const long long* order;     // (nq * nprobe,) probe pairs sorted by list
  const int* list_start;      // (n_lists + 1,)
  int nprobe, max_aligned;    // position p * max_aligned + o
  int tiles;                  // query tiles per list: grid.x = lists x tiles
  int chunk, cmax;            // positions per block; chunks of the widest
};

constexpr int kListChunk = 4096;   // list positions one block scans
constexpr int kListQ = 8;          // largest query tile of a list block

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
// permutation, so the list equals the one-by-one insertion's. Not inlined:
// the streaming pass calls it from each query's branch of an unrolled
// loop, and eight inlined copies cost more in instruction fetch than the
// calls (tools/scan_variants.py "inline_merge" on the H100: the list
// mode's int8 scan 2.0x and fp32 scan 1.2x slower inlined, the dense
// scans the same).
template <int kSlots, bool kSorted = false>
__device__ __noinline__ void warp_merge(float* lv, int* li, int k, float cv, int ci,
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
__device__ __noinline__ void warp_insert(float* lv, int* li, int k, float cv, int ci,
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
// once go through warp_merge<kSlots> where k <= 32 kSlots; else one by
// one. Returns the lanes whose candidate beat the list's tail on entry.
template <int kSlots, bool kSorted = false>
__device__ unsigned warp_offer(float* lv, int* li, int k, float cv, int ci,
                               bool ok) {
  __syncwarp();
  const bool win = ok && better(cv, ci, lv[k - 1], li[k - 1]);
  unsigned want = __ballot_sync(kAll, win);
  const unsigned won = want;
  if (__popc(want) > 1 && k <= 32 * kSlots) {
    warp_merge<kSlots, kSorted>(lv, li, k, cv, ci, win);
    return won;
  }
  if (want) warp_insert(lv, li, k, cv, ci, want);
  return won;
}

// ------------------------------------------------------------- scorers
// finish(): the score from a finished chain (the streaming and tiled
// passes run the chains themselves; PQ's LUT folds the metric in).

template <int kKind>
struct Scorer;

template <>
struct Scorer<kF32> {
  using Acc = float;
  template <bool kL2>
  __device__ static float finish(Acc acc, float, float, float sqr) {
    return kL2 ? 2.0f * acc - sqr : acc;
  }
};

template <>
struct Scorer<kI8> {
  using Acc = int;
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
  template <bool kL2>
  __device__ static float finish(Acc acc, float, float, float) {
    return acc;
  }
};

// Pass 2, one block per query: warp w merges the partial lists of chunks
// w, w + nw, ... into its own list, loading the head of its next list
// while it merges this one. Every list merged is sorted best first, so a
// warp stops reading one at its first entry that does not beat its tail,
// and a presorted merge skips warp_merge's sort; the warps' lists then
// merge in a tree of log2(nw) rounds. nw = 16 for 32 lists or more, else
// 8, while the warps' lists fit kPass2SmemList entries, else one warp
// whose list lives in shared memory for k <= kPass2SmemList, else in the
// output row. In list mode (``la.flat_ids`` non-null) the lists rank
// positions: partial (p, c, w) of query qi holds a list only when chunk c
// of its probed list probe[qi, p] exists (the others are skipped unread),
// and a winning position p * max_aligned + o becomes the store id
// flat_ids[offsets[probe[qi, p]] + o]. ``slot_lists`` is the partials per
// (p, c): 1, or one per warp of the streaming pass.
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

// One pass 2 block merges partials [g * group, (g + 1) * group) of query
// qi (block qi * groups + g): each query's partials are ``q_stride``
// entries apart, partial c at c * k; the block's list lands at
// out + qi * out_stride + g * k. ``skip_dead``: list mode's unwritten
// slots are skipped; ``map_ids``: list mode's positions become store ids.
struct Pass2 {
  const float* part_v;
  const int* part_i;
  size_t q_stride, out_stride;
  int n_chunks, group, k, slot_lists;
  bool skip_dead, map_ids;
  float* out_v;
  int* out_i;
};

__global__ void __launch_bounds__(kPass2Warps * 32)
scan_pass2(const Pass2 p, const ListArgs la) {
  extern __shared__ float smem2[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int k = p.k;
  const int groups = (p.n_chunks + p.group - 1) / p.group;
  const size_t qi = blockIdx.x / groups;
  const int g = static_cast<int>(blockIdx.x - qi * groups);
  const int c0 = g * p.group;
  const int c1 = min(p.n_chunks, c0 + p.group);
  const bool in_smem = static_cast<size_t>(nw) * k <= kPass2SmemList;
  float* out_v = p.out_v + qi * p.out_stride + static_cast<size_t>(g) * k;
  int* out_i = p.out_i + qi * p.out_stride + static_cast<size_t>(g) * k;
  float* lists_v = smem2;
  int* lists_i = reinterpret_cast<int*>(smem2 + static_cast<size_t>(nw) * k);
  float* lv = in_smem ? lists_v + static_cast<size_t>(warp) * k : out_v;
  int* li = in_smem ? lists_i + static_cast<size_t>(warp) * k : out_i;
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = -1;
  }
  const float* pv = p.part_v + qi * p.q_stride;
  const int* pi = p.part_i + qi * p.q_stride;
  // the head of partial c, or an empty head for a list-mode slot whose
  // chunk lies past its probed list's end (never written)
  auto head = [&](int c, float& v, int& id) {
    if (p.skip_dead) {
      const int s = c / p.slot_lists;
      const int pp = s / la.cmax;
      const long long o0 = static_cast<long long>(s - pp * la.cmax) * la.chunk;
      if (o0 >= la.aligned[la.probe[qi * la.nprobe + pp]]) {
        v = kNegInf;
        id = -1;
        return;
      }
    }
    list_head(pv + static_cast<size_t>(c) * k, pi + static_cast<size_t>(c) * k,
              k, v, id);
  };
  float hv = kNegInf;           // the head of the warp's next list
  int hi = -1;
  if (c0 + warp < c1) head(c0 + warp, hv, hi);
  for (int c = c0 + warp; c < c1; c += nw) {
    const float v0 = hv;
    const int i0 = hi;
    if (c + nw < c1) head(c + nw, hv, hi);
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
    if (p.map_ids && id >= 0) {
      const int pp = id / la.max_aligned;
      const int o = id - pp * la.max_aligned;
      id = la.flat_ids[la.offsets[la.probe[qi * la.nprobe + pp]] + o];
    }
    out_v[j] = v;
    out_i[j] = id;
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
// (4 floats for fp32, one 32-byte mma step for int8; PQ code bytes are
// read up to the slice's end, unpadded)
__host__ __device__ inline int depth_pad(int kind, int len) {
  return kind == kF32 ? (len + 3) / 4 * 16
                      : kind == kI8 ? (len + 31) / 32 * 32 : len;
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

// Copy bytes [col, col + len) of ``nrows`` rows of ``src``, row i being
// source row idx[i] (rows ``row_bytes`` apart), into shared rows
// ``dst_stride`` apart: stage_copy's copies, gathered row by row
__device__ void stage_gather(unsigned char* dst, int dst_stride,
                             const unsigned char* src, size_t row_bytes,
                             const int* idx, int nrows, int col, int len,
                             int width) {
  const int per = len / width;
  const int total = nrows * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per;
    const int c = (i - r * per) * width;
    unsigned char* d = dst + r * dst_stride + c;
    const unsigned char* s =
        src + static_cast<size_t>(idx[r]) * row_bytes + col + c;
    if (width == 16)
      cp_async16(d, s);
    else if (width == 4)
      cp_async4(d, s);
    else
      *d = __ldg(s);
  }
}

// Copy ``nbytes`` contiguous bytes to 16-byte aligned shared memory:
// cp.async of 16 or 4 bytes as far as ``src``'s alignment allows, byte
// loads for the rest
__device__ void stage_span(void* dst_ptr, const void* src_ptr, int nbytes) {
  unsigned char* dst = static_cast<unsigned char*>(dst_ptr);
  const unsigned char* src = static_cast<const unsigned char*>(src_ptr);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int width = a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 1;
  const int units = width == 1 ? 0 : nbytes / width;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    if (width == 16)
      cp_async16(dst + 16 * i, src + 16 * i);
    else
      cp_async4(dst + 4 * i, src + 4 * i);
  }
  for (int i = units * width + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// ------------------------------------------------------------ list mode
// A list-mode block's work: query tile blockIdx.x % tiles of list
// l = blockIdx.x / tiles (sorted pairs list_start[l] + t * qt, ...) and
// positions [o0, o1) of chunk blockIdx.y of the list, which starts at
// flat_ids[base].
struct ListWork {
  int nqt, o0, o1;
  long long base;
};

// Fill ``lw``; threads j < nqt write query j's row ``qid[j]``, its
// position base qkey[j] = p * max_aligned and its partial slot
// (b * nprobe + p) * cmax + chunk. False (block-uniform) when the tile has
// no query or the chunk starts past the list's end: the block has no work.
// (Such blocks cost little: a grid of only the tiles that exist, mapped by
// a one-block kernel, ran kernel 9 no faster on the H100, PERF.md.)
__device__ bool list_work(const ListArgs& a, int qt, ListWork& lw, int* qid,
                          int* qkey, long long* qslot) {
  const int l = blockIdx.x / a.tiles;
  const int s0 = a.list_start[l] + (blockIdx.x - l * a.tiles) * qt;
  lw.nqt = min(qt, a.list_start[l + 1] - s0);
  const long long al = a.aligned[l];
  lw.o0 = blockIdx.y * a.chunk;
  if (lw.nqt <= 0 || lw.o0 >= al) return false;
  lw.o1 = static_cast<int>(
      min(al, static_cast<long long>(lw.o0) + a.chunk));
  lw.base = a.offsets[l];
  if (threadIdx.x < lw.nqt) {
    const long long pair = a.order[s0 + threadIdx.x];
    const int b = static_cast<int>(pair / a.nprobe);
    const int pp = static_cast<int>(pair - static_cast<long long>(b) *
                                               a.nprobe);
    qid[threadIdx.x] = b;
    qkey[threadIdx.x] = pp * a.max_aligned;
    qslot[threadIdx.x] =
        (static_cast<long long>(b) * a.nprobe + pp) * a.cmax + blockIdx.y;
  }
  return true;
}

// Read the ids of the block's positions [o0, o1) and each tile query's
// scope bit of each (bit id & 31 of word id >> 5 of its scope row; -1,
// padding, and a scope id out of range admit nothing), and keep the rows
// some query admits: cid[i] the store row, cmeta[i] its position past o0
// (low 16 bits) and the queries that admit it (bit 16 + j). Each thread
// takes kCompactU positions a round, so their loads are in flight
// together. Returns the count, the same in every thread. The kept rows'
// order is the warps' arrival order; nothing computed depends on it.
constexpr int kCompactU = 8;
__device__ int list_compact(const ListArgs& a, const ListWork& lw,
                            const uint32_t* words, int n_scopes, int n_words,
                            const int* qsid, int* cid, unsigned* cmeta,
                            int* counter) {
  const int lane = threadIdx.x & 31;
  const int npos = lw.o1 - lw.o0;
  const int* ids = a.flat_ids + lw.base + lw.o0;
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  for (int i0 = 0; i0 < npos; i0 += kCompactU * blockDim.x) {
    int id[kCompactU];
    unsigned m[kCompactU];
#pragma unroll
    for (int u = 0; u < kCompactU; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      id[u] = i < npos ? __ldg(ids + i) : -1;
      m[u] = 0u;
    }
#pragma unroll
    for (int j = 0; j < kListQ; ++j) {
      const int s = j < lw.nqt ? qsid[j] : -1;
      const bool ok = s >= 0 && s < n_scopes;
      const uint32_t* row = words + static_cast<size_t>(ok ? s : 0) * n_words;
#pragma unroll
      for (int u = 0; u < kCompactU; ++u)
        if (ok && id[u] >= 0)
          m[u] |= ((__ldg(row + (id[u] >> 5)) >> (id[u] & 31)) & 1u) << j;
    }
#pragma unroll
    for (int u = 0; u < kCompactU; ++u) {
      const bool keep = m[u] != 0u;
      const unsigned bal = __ballot_sync(kAll, keep);
      int at = 0;
      if (lane == 0 && bal != 0u) at = atomicAdd(counter, __popc(bal));
      at = __shfl_sync(kAll, at, 0) + __popc(bal & ((1u << lane) - 1u));
      if (keep) {
        cid[at] = id[u];
        cmeta[at] =
            static_cast<unsigned>(i0 + u * blockDim.x + threadIdx.x) |
            (m[u] << 16);
      }
    }
  }
  __syncthreads();
  return *counter;
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

// -------------------------------------- streaming pass 1 (fp32, int8, PQ)
constexpr int kStreamThreads = 128;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamRows = kStreamThreads;   // rows per tile: one a thread
constexpr int kStreamStages = 3;          // ring: 2 items in flight
constexpr int kStreamBlocks = 4;          // most blocks an SM is planned for
constexpr int kStreamQ = 8;               // largest query tile
constexpr int kStreamPQQ = 1;             // ... of the PQ mode (occupancy)
constexpr int kSmemPerSM = 233472;        // shared memory of one SM
constexpr int kSmemPerBlock = 1024;       // ... the system keeps per block
// a meta slot: the tile's mask bytes, l2 norms and int8 row scales (PQ:
// the mask bytes alone)
__host__ __device__ constexpr int stream_meta(int kind) {
  return kind == kPQ ? kStreamRows : kStreamRows * 9;
}
constexpr int kStreamMisc = 256;          // the query tile's ids, keys, ...

// depth one item holds: 64 floats (fp32; 32 in list mode, whose compacted
// rows take shared memory too), 256 int8 or PQ code bytes
__host__ __device__ constexpr int stream_slice(int kind, int list) {
  return kind == kF32 ? (list ? 32 : 64) : 256;
}

// PQ: the query tile's LUTs stay resident when one item holds a row's
// whole code; else each item carries the tile's LUT slice for its codes
__host__ __device__ constexpr bool lut_resident(int depth, int slice) {
  return slice >= depth;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct StreamScan {
  const void* q;           // f32 | i8 (nq, depth); PQ: LUTs (nq, depth, 256)
  const float* q_scale;    // int8: (nq,)
  const void* rows;        // f32 | i8 (n, depth); PQ: uint8 codes (n, depth)
  const float* row_scale;  // int8: (n,)
  const float* sq;         // l2: (n,)
  const int8_t* mask;      // dense mode: (n,), non-zero admits the row
  const uint32_t* words;   // list mode: (n_scopes, n_words)
  const int* sids;         // list mode: (nq,)
  ListArgs la;             // list mode
  int n_scopes, n_words;
  int nq, n, depth, slice, k, qt, chunk_rows, smem_lists, lists;
  int row_width, q_width;  // copy width in bytes: 16, 4 or 1
  float* part_v;
  int* part_i;
};

// Shared memory of the streaming pass 1: PQ's resident LUTs (qt x depth x
// 1 KB, when they are), the ring (each stage a row tile's depth slice,
// rows padded to an odd number of 16-byte units, and the query tile's:
// its rows' slice, or PQ's LUT slice when not resident), kStreamStages
// meta slots, in list mode the chunk's compacted rows (ids and (position,
// queries) words), the query tile's misc, per warp and query a 32-entry
// candidate buffer and its list's tail, then per warp and query a top-k
// list when they fit.
struct StreamLayout {
  int r_stride;
  size_t lut, stage, compact, bufs, lists, total;
};

__host__ __device__ inline StreamLayout stream_layout(int kind, int list,
                                                      int qt, int depth,
                                                      int slice, int k,
                                                      int smem_lists) {
  StreamLayout L;
  L.r_stride = pad_stride(depth_pad(kind, slice));
  const bool resident = kind == kPQ && lut_resident(depth, slice);
  L.lut = resident ? static_cast<size_t>(qt) * depth * 1024 : 0;
  L.stage = static_cast<size_t>(kStreamRows) * L.r_stride +
            (kind != kPQ ? static_cast<size_t>(qt) * L.r_stride
             : resident  ? 0
                         : static_cast<size_t>(qt) * slice * 1024);
  L.compact = list ? static_cast<size_t>(kListChunk) * 8 : 0;
  L.bufs = static_cast<size_t>(kStreamWarps) * qt * (32 * 8 + 8);
  L.lists = smem_lists ? static_cast<size_t>(kStreamWarps) * qt * k * 8 : 0;
  L.total = L.lut + kStreamStages * (L.stage + stream_meta(kind)) +
            L.compact +
            kStreamMisc + L.bufs + L.lists;
  return L;
}

// The largest query tile up to ``qt_cap`` whose per-warp lists fit shared
// memory beside the ring; past that the lists live in device memory, one
// partial per warp (``lists`` partials per chunk). ``blocks``: how many
// such blocks one SM holds (1 to 4), which the wrapper sizes the grid by.
// PQ (stream_plan_pq): the tile is at most kStreamPQQ, with resident LUTs
// where they fit, else one query whose LUT rides in each item in slices of
// M (multiples of 16 where possible). smem is 0 when nothing fits.
struct StreamPlan {
  int qt, slice, smem_lists, lists, blocks;
  size_t smem;
};

void stream_blocks(StreamPlan& P) {
  const int fit = kSmemPerSM / static_cast<int>(P.smem + kSmemPerBlock);
  P.blocks = fit < 1 ? 1 : fit > kStreamBlocks ? kStreamBlocks : fit;
}

StreamPlan stream_plan_pq(int qt_cap, int depth, int k) {
  const size_t limit = static_cast<size_t>(kSmemLimit);
  if (qt_cap > kStreamPQQ) qt_cap = kStreamPQQ;
  auto plan = [&](int qt, int slice, int lists) {
    StreamPlan P{qt, slice, lists, lists ? 1 : kStreamWarps, 1,
                 stream_layout(kPQ, 0, qt, depth, slice, k, lists).total};
    stream_blocks(P);
    return P;
  };
  if (depth <= stream_slice(kPQ, 0))
    for (int lists = 1; lists >= 0; --lists)
      for (int qt = qt_cap; qt >= 1; --qt)
        if (plan(qt, depth, lists).smem <= limit)
          return plan(qt, depth, lists);
  const int top = depth - 1 < stream_slice(kPQ, 0) ? depth - 1
                                                    : stream_slice(kPQ, 0);
  for (int lists = 1; lists >= 0; --lists)
    for (int slice = top; slice >= 1; --slice) {
      if (slice > 16 && slice % 16 != 0) continue;
      if (plan(1, slice, lists).smem <= limit) return plan(1, slice, lists);
    }
  return StreamPlan{1, 1, 0, kStreamWarps, 1, 0};
}

StreamPlan stream_plan(int kind, int list, int qt_cap, int depth, int k) {
  if (kind == kPQ) return stream_plan_pq(qt_cap, depth, k);
  const int slice = stream_slice(kind, list);
  StreamPlan P{qt_cap, depth < slice ? depth : slice, 0, kStreamWarps, 1,
               0};
  for (int qt = qt_cap; qt >= 1; --qt) {
    const size_t smem =
        stream_layout(kind, list, qt, depth, P.slice, k, 1).total;
    if (smem <= static_cast<size_t>(kSmemLimit)) {
      P.qt = qt;
      P.smem_lists = 1;
      P.lists = 1;
      P.smem = smem;
      break;
    }
  }
  if (P.smem == 0)
    P.smem = stream_layout(kind, list, qt_cap, depth, P.slice, k, 0).total;
  stream_blocks(P);
  return P;
}

// Kernels 1, 5 and 7 (scoped_topk, _i8, _pq), and kernel 9 fp32 / int8
// in list mode: query tile of qt <= 8 (kQ = 1 compiles the q = 1 scan
// alone) x row chunk (dense) or list chunk (kList). Item = (128-row tile,
// depth slice), copied with cp.async into ring stage item % 3 by all
// threads (neighbouring threads on neighbouring 16 bytes; list mode
// gathers each row from its id), two items ahead of the one computed; a
// tile's first item also stages its meta, and the first item's group the
// PQ tile's resident LUTs. Thread t owns row t of every tile: its chain
// (fp32 fmaf, int8 __dp4a, PQ lookups) continues across the slices out of
// shared memory (the query slice is a broadcast). At a tile's end each warp
// appends the scores of its 32 rows that beat the best of the warps'
// tails of the query's lists to the query's 32-entry buffer, and merges a
// buffer into its list (warp_merge, 32 candidates at once) only when the
// next tile's winners would overflow it: a warp merges about once per
// 32 winners, not once per tile and query. (A warp's tail is the k-th
// best of rows the block has seen, so a row that does not beat some
// warp's tail is out of the block's top-k; each warp publishes its tails
// as one 8-byte word, read whole.) No block barrier waits on a merge; the
// warps' lists are merged once at the chunk's end. A list rank's key is
// the row (dense) or the position p * max_aligned + o (list mode).
template <int kKind, bool kL2, int kQ, bool kWide, bool kList>
__global__ void __launch_bounds__(kStreamThreads,
                                  kQ == 1 ? kStreamBlocks : 2)
scan_pass1_stream(const StreamScan p) {
  using Acc = typename Scorer<kKind>::Acc;
  constexpr int kEb = kKind == kF32 ? 4 : 1;    // bytes per element
  constexpr int kMeta = stream_meta(kKind);
  extern __shared__ __align__(16) unsigned char smem[];
  const StreamLayout L = stream_layout(kKind, kList, p.qt, p.depth, p.slice,
                                       p.k, p.smem_lists);
  const float* lut_res = reinterpret_cast<const float*>(smem);  // PQ
  unsigned char* ring = smem + L.lut;
  unsigned char* meta = ring + kStreamStages * L.stage;
  int* cid = reinterpret_cast<int*>(meta + kStreamStages * kMeta);
  unsigned* cmeta = reinterpret_cast<unsigned*>(cid + L.compact / 8);
  unsigned char* misc = reinterpret_cast<unsigned char*>(cid) + L.compact;
  long long* qslot = reinterpret_cast<long long*>(misc);  // kStreamQ each
  int* qid = reinterpret_cast<int*>(qslot + kStreamQ);
  int* qkey = qid + kStreamQ;
  int* qsid = qkey + kStreamQ;
  float* qsc = reinterpret_cast<float*>(qsid + kStreamQ);
  int* counter = reinterpret_cast<int*>(qsc + kStreamQ);
  int2* wt_s = reinterpret_cast<int2*>(misc + kStreamMisc);  // tails
  float* bv_s = reinterpret_cast<float*>(wt_s + kStreamWarps * p.qt);
  int* bi_s = reinterpret_cast<int*>(bv_s + kStreamWarps * p.qt * 32);
  float* lv_s = reinterpret_cast<float*>(bi_s + kStreamWarps * p.qt * 32);
  int* li_s = reinterpret_cast<int*>(
      lv_s + static_cast<size_t>(kStreamWarps) * p.qt * p.k);

  const int k = p.k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_bytes = static_cast<size_t>(p.depth) * kEb;
  int nqt, count = 0, r_begin = 0;   // count: the block's rows
  ListWork lw{};
  if constexpr (kList) {
    if (!list_work(p.la, p.qt, lw, qid, qkey, qslot)) return;
    nqt = lw.nqt;
    if (threadIdx.x < nqt) qsid[threadIdx.x] = p.sids[qid[threadIdx.x]];
  } else {
    const int q0 = blockIdx.x * p.qt;
    nqt = min(p.qt, p.nq - q0);
    r_begin = blockIdx.y * p.chunk_rows;
    count = max(0, min(p.n, r_begin + p.chunk_rows) - r_begin);
    if (threadIdx.x < nqt) {
      qid[threadIdx.x] = q0 + threadIdx.x;
      qslot[threadIdx.x] =
          static_cast<long long>(q0 + threadIdx.x) * gridDim.y + blockIdx.y;
    }
  }
  if (threadIdx.x < nqt)
    qsc[threadIdx.x] = kKind == kI8 ? p.q_scale[qid[threadIdx.x]] : 1.0f;
  __syncthreads();
  if constexpr (kList)
    count = list_compact(p.la, lw, p.words, p.n_scopes, p.n_words, qsid, cid,
                         cmeta, counter);

  // warp w's list of query j: in shared memory, or partial w of its slot
  auto list_at = [&](int w, int j) {
    return p.smem_lists
               ? (static_cast<size_t>(w) * p.qt + j) * k
               : (static_cast<size_t>(qslot[j]) * p.lists + w) * k;
  };
  float* const lv = p.smem_lists ? lv_s : p.part_v;
  int* const li = p.smem_lists ? li_s : p.part_i;
  float tv[kQ];                 // the warp's lists' tails
  int ti[kQ];
  int bc[kQ];                   // ... and its buffers' fill (warp-uniform)
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    tv[j] = kNegInf;
    ti[j] = -1;
    bc[j] = 0;
  }
  // the warp publishes its list tail of query j to the other warps
  auto publish = [&](int j) {
    if (lane == 0)
      wt_s[warp * p.qt + j] = make_int2(__float_as_int(tv[j]), ti[j]);
  };
  if (lane == 0)                // empty lists' tails
    for (int j = 0; j < nqt; ++j)
      wt_s[warp * p.qt + j] = make_int2(__float_as_int(kNegInf), -1);
  // merge the warp's buffer of query j into its list, then read the tail
  auto flush = [&](int j) {
    __syncwarp();
    float* wl = lv + list_at(warp, j);
    int* wi = li + list_at(warp, j);
    const float* bv = bv_s + (warp * p.qt + j) * 32;
    const int* bi = bi_s + (warp * p.qt + j) * 32;
    const bool in = lane < bc[j];
    warp_offer<kWide ? kMergeSlotsWide : kMergeSlots>(
        wl, wi, k, in ? bv[lane] : kNegInf, in ? bi[lane] : -1, in);
    __syncwarp();
    tv[j] = wl[k - 1];
    ti[j] = wi[k - 1];
    bc[j] = 0;
    publish(j);
  };
  for (int j = 0; j < nqt; ++j)
    for (int e = lane; e < k; e += 32) {
      lv[list_at(warp, j) + e] = kNegInf;
      li[list_at(warp, j) + e] = -1;
    }
  __syncwarp();

  const int ns = (p.depth + p.slice - 1) / p.slice;
  const int n_tiles = (count + kStreamRows - 1) / kStreamRows;
  const int total = n_tiles * ns;
  const unsigned char* r_src = static_cast<const unsigned char*>(p.rows) +
                               static_cast<size_t>(r_begin) * row_bytes;
  const unsigned char* q_src = static_cast<const unsigned char*>(p.q);
  // PQ: one query's LUT, and whether the tile's stay resident
  const int lut_bytes = p.depth * 1024;
  const bool resident = kKind == kPQ && lut_resident(p.depth, p.slice);
  if (resident)                 // joins the first item's group
    stage_gather(smem, lut_bytes, q_src, lut_bytes, qid, nqt, 0, lut_bytes,
                 p.q_width);
  auto issue = [&](int item) {
    if (item < total) {
      const int t = item / ns;
      const int s = item - t * ns;
      const int i0 = t * kStreamRows;
      const int nr = min(kStreamRows, count - i0);
      const int c0 = s * p.slice;
      const int lenb = min(p.slice, p.depth - c0) * kEb;
      const int padb = depth_pad(kKind, min(p.slice, p.depth - c0));
      unsigned char* stage = ring + (item % kStreamStages) * L.stage;
      unsigned char* qs = stage + kStreamRows * L.r_stride;
      if (kList)
        stage_gather(stage, L.r_stride, r_src, row_bytes, cid + i0, nr,
                     c0 * kEb, lenb, p.row_width);
      else
        stage_copy(stage, L.r_stride, r_src + i0 * row_bytes + c0 * kEb,
                   row_bytes, nr, lenb, p.row_width);
      if (kKind != kPQ)
        stage_gather(qs, L.r_stride, q_src, row_bytes, qid, nqt, c0 * kEb,
                     lenb, p.q_width);
      else if (!resident)       // the tile's LUT slice, (query, m, 256)
        stage_gather(qs, lenb * 1024, q_src, lut_bytes, qid, nqt, c0 * 1024,
                     lenb * 1024, p.q_width);
      if (padb > lenb) {        // pads are 0 (fp32: 0 * NaN is NaN; int8:
        if (kKind == kF32)      // a zero query byte makes any row byte's
          zero_cols(stage, L.r_stride, kStreamRows, lenb, padb);  // term 0)
        zero_cols(qs, L.r_stride, nqt, lenb, padb);
      }
      if (s == 0) {             // the tile's meta, read at its end
        unsigned char* m = meta + (t % kStreamStages) * kMeta;
        float* sqs = reinterpret_cast<float*>(m + kStreamRows);
        float* scs = sqs + kStreamRows;
        if constexpr (kList) {
          for (int i = threadIdx.x; i < nr; i += kStreamThreads) {
            const int id = cid[i0 + i];
            if (kL2) cp_async4(sqs + i, p.sq + id);
            if (kKind == kI8) cp_async4(scs + i, p.row_scale + id);
          }
        } else {
          const int r0 = r_begin + i0;
          stage_span(m, p.mask + r0, nr);
          if (kL2) stage_span(sqs, p.sq + r0, nr * 4);
          if (kKind == kI8) stage_span(scs, p.row_scale + r0, nr * 4);
        }
      }
    }
    cp_async_commit();          // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < kStreamStages - 1; ++i) issue(i);

  Acc acc[kQ];
  for (int item = 0; item < total; ++item) {
    cp_async_wait<kStreamStages - 2>();  // item's stage has landed ...
    __syncthreads();            // ... for all, and item - 1 is consumed
    issue(item + kStreamStages - 1);
    const int t = item / ns;
    const int s = item - t * ns;
    const int len = min(p.slice, p.depth - s * p.slice);
    const unsigned char* stage = ring + (item % kStreamStages) * L.stage;
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = Acc(0);
    }
    if constexpr (kKind == kF32) {
      const float* xr =
          reinterpret_cast<const float*>(stage + threadIdx.x * L.r_stride);
      const float* qv0 =
          reinterpret_cast<const float*>(stage + kStreamRows * L.r_stride);
      const int qs4 = L.r_stride / 4;
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
    } else if constexpr (kKind == kI8) {
      const int4* xr =
          reinterpret_cast<const int4*>(stage + threadIdx.x * L.r_stride);
      const int4* qv0 =
          reinterpret_cast<const int4*>(stage + kStreamRows * L.r_stride);
      const int qs16 = L.r_stride / 16;
      const int len16 = depth_pad(kI8, len) / 16;
      for (int c = 0; c < len16; ++c) {
        const int4 xv = xr[c];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (kQ == 1 || j < nqt) {
            const int4 qv = qv0[j * qs16 + c];
            acc[j] = __dp4a(xv.x, qv.x, acc[j]);
            acc[j] = __dp4a(xv.y, qv.y, acc[j]);
            acc[j] = __dp4a(xv.z, qv.z, acc[j]);
            acc[j] = __dp4a(xv.w, qv.w, acc[j]);
          }
        }
      }
    } else {
      // PQ: only lanes whose row the tile's mask admits look up (a warp
      // with none skips the item), query by query, kernel 8's loop: 16
      // reads in flight, then 16 adds in order. The LUT of query j: the
      // resident one (then the item holds the whole code, s == 0), or the
      // item's slice of it, rows of ``len`` x 256 floats.
      const unsigned char* mt = meta + (t % kStreamStages) * kMeta;
      if (t * kStreamRows + threadIdx.x < count && mt[threadIdx.x] != 0) {
        const unsigned char* cr = stage + threadIdx.x * L.r_stride;
        const float* lq =
            resident ? lut_res
                     : reinterpret_cast<const float*>(stage +
                                                      kStreamRows * L.r_stride);
        const int qstride = (resident ? p.depth : len) * 256;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (kQ == 1 || j < nqt) {
            const float* lj = lq + j * qstride;
            float a = acc[j];
            int m = 0;
            for (; m + 16 <= len; m += 16) {
              const uint4 cw = *reinterpret_cast<const uint4*>(cr + m);
              const unsigned wd[4] = {cw.x, cw.y, cw.z, cw.w};
              const float* lm = lj + m * 256;
              float v[16];
#pragma unroll
              for (int b = 0; b < 16; ++b)   // byte b & 3 of the word
                v[b] = lm[b * 256 + static_cast<int>(__byte_perm(
                                        wd[b >> 2], 0u, 0x4440u + (b & 3)))];
#pragma unroll
              for (int b = 0; b < 16; ++b) a += v[b];
            }
            for (; m < len; ++m) a += lj[m * 256 + cr[m]];
            acc[j] = a;
          }
        }
      }
    }
    if (s != ns - 1) continue;
    // the tile's end: the thread's row i of the block's rows, which
    // queries admit it, and its rank key
    const int i = t * kStreamRows + threadIdx.x;
    const bool in = i < count;
    const unsigned char* m = meta + (t % kStreamStages) * kMeta;
    const float sqr =
        (kL2 && in) ? reinterpret_cast<const float*>(m + kStreamRows)
                          [threadIdx.x]
                    : 0.0f;
    const float rs =
        (kKind == kI8 && in)
            ? reinterpret_cast<const float*>(m + 5 * kStreamRows)[threadIdx.x]
            : 1.0f;
    unsigned adm;
    int key0;
    if constexpr (kList) {
      const unsigned cm = in ? cmeta[i] : 0u;
      adm = cm >> 16;
      key0 = lw.o0 + static_cast<int>(cm & 0xffffu);
    } else {
      adm = (in && m[threadIdx.x] != 0) ? kAll : 0u;
      key0 = r_begin + i;
    }
    // every query's vote first -- its score against the best of the
    // warps' tails, loads and selects with no branch between queries --
    // then the appends and merges of the queries that have winners
    unsigned bal[kQ];
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      bal[j] = 0u;
      if (kQ == 1 || j < nqt) {
        const float sc = Scorer<kKind>::template finish<kL2>(acc[j], qsc[j],
                                                             rs, sqr);
        float cut_v = tv[j];
        int cut_i = ti[j];
#pragma unroll
        for (int w = 0; w < kStreamWarps; ++w) {
          const int2 t = wt_s[w * p.qt + j];
          if (better(__int_as_float(t.x), t.y, cut_v, cut_i)) {
            cut_v = __int_as_float(t.x);
            cut_i = t.y;
          }
        }
        bal[j] = __ballot_sync(
            kAll, ((adm >> j) & 1u) &&
                      better(sc, kList ? qkey[j] + key0 : key0, cut_v,
                             cut_i));
        any |= bal[j];
      }
    }
    if (any) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (bal[j]) {
          if (bc[j] + __popc(bal[j]) > 32) flush(j);
          if ((bal[j] >> lane) & 1u) {
            const int at = (warp * p.qt + j) * 32 + bc[j] +
                           __popc(bal[j] & ((1u << lane) - 1u));
            bv_s[at] = Scorer<kKind>::template finish<kL2>(acc[j], qsc[j],
                                                           rs, sqr);
            bi_s[at] = kList ? qkey[j] + key0 : key0;
          }
          bc[j] += __popc(bal[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j)
    if ((kQ == 1 || j < nqt) && bc[j] > 0) flush(j);
  cp_async_wait_all();
  if (!p.smem_lists) return;    // each warp's list is a partial of its own
  __syncthreads();
  for (int j = warp; j < nqt; j += kStreamWarps) {
    float* lv0 = lv_s + list_at(0, j);
    int* li0 = li_s + list_at(0, j);
    for (int w = 1; w < kStreamWarps; ++w)
      merge_sorted(lv0, li0, k, lv_s + list_at(w, j), li_s + list_at(w, j));
    __syncwarp();
    const size_t off = static_cast<size_t>(qslot[j]) * k;
    for (int e = lane; e < k; e += 32) {
      p.part_v[off + e] = lv0[e];
      p.part_i[off + e] = li0[e];
    }
  }
}

template <int kKind, bool kL2, int kQ, bool kList>
cudaError_t launch_stream(dim3 grid, size_t smem, cudaStream_t stream,
                          const StreamScan& p) {
  auto kern = p.k > 32 * kMergeSlots
                  ? scan_pass1_stream<kKind, kL2, kQ, true, kList>
                  : scan_pass1_stream<kKind, kL2, kQ, false, kList>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kStreamThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the streaming pass's variant for kind (fp32, int8, PQ: dense mode
// only), metric, query tile (1: kQ = 1) and mode
template <bool kList>
cudaError_t dispatch_stream(int kind, bool l2, dim3 grid, size_t smem,
                            cudaStream_t stream, const StreamScan& p) {
  const bool one = p.qt == 1;
  if (kind == kPQ) {
    if constexpr (kList) {
      return cudaErrorInvalidValue;
    } else {
      return one ? launch_stream<kPQ, false, 1, false>(grid, smem, stream, p)
                 : launch_stream<kPQ, false, kStreamQ, false>(grid, smem,
                                                              stream, p);
    }
  }
  if (kind == kF32) {
    if (l2)
      return one ? launch_stream<kF32, true, 1, kList>(grid, smem, stream, p)
                 : launch_stream<kF32, true, kStreamQ, kList>(grid, smem,
                                                              stream, p);
    return one ? launch_stream<kF32, false, 1, kList>(grid, smem, stream, p)
               : launch_stream<kF32, false, kStreamQ, kList>(grid, smem,
                                                             stream, p);
  }
  if (l2)
    return one ? launch_stream<kI8, true, 1, kList>(grid, smem, stream, p)
               : launch_stream<kI8, true, kStreamQ, kList>(grid, smem, stream,
                                                           p);
  return one ? launch_stream<kI8, false, 1, kList>(grid, smem, stream, p)
             : launch_stream<kI8, false, kStreamQ, kList>(grid, smem, stream,
                                                          p);
}

// ------------------------------------------- tiled pass 1 (PQ, scope words)
constexpr int kPQWarps = 16;
constexpr int kPQThreads = kPQWarps * 32;
constexpr int kPQRows = kPQThreads;       // rows per tile: one per thread
constexpr int kPQMaxQ = 8;                // largest query tile
constexpr int kPQStages = 2;
constexpr int kPQWords = kPQRows / 32;    // scope words per query and tile
constexpr int kPQMisc = 256;              // the query tile's ids, keys, ...

struct PQScan {
  const float* lut;        // (nq, depth, 256)
  const uint8_t* codes;    // (n, depth)
  const uint32_t* words;   // (n_scopes, n_words)
  const int* sids;         // (nq,)
  ListArgs la;             // list mode
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
// in list mode the chunk's compacted rows, the query tile's misc, then the
// lists. Every part but the lists is a multiple of 16 bytes.
struct PQLayout {
  int c_stride;
  size_t lut, codes, lut_slice, stage, sv, misc, compact, lists, total;
};

__host__ __device__ inline PQLayout pq_layout(int list, int qt, int depth,
                                              int slice, int resident, int k,
                                              int smem_lists) {
  PQLayout L;
  L.c_stride = pad_stride(slice);
  L.lut = resident ? static_cast<size_t>(qt) * depth * 1024 : 0;
  L.codes = static_cast<size_t>(kPQRows) * L.c_stride;
  L.lut_slice = resident ? 0 : static_cast<size_t>(qt) * slice * 1024;
  L.stage = L.codes + L.lut_slice + static_cast<size_t>(qt) * kPQWords * 4;
  L.sv = static_cast<size_t>(qt) * kPQRows * 4;
  L.misc = static_cast<size_t>(qt) * (kPQWords + 4 + 64) * 4;
  L.compact = list ? static_cast<size_t>(kListChunk) * 8 : 0;
  L.lists = smem_lists ? static_cast<size_t>(qt) * k * 8 : 0;
  L.total = L.lut + kPQStages * L.stage + L.sv + L.misc + L.compact +
            kPQMisc + L.lists;
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

PQPlan pq_plan(int list, int qt_cap, int depth, int k) {
  const size_t limit = static_cast<size_t>(kSmemLimit);
  if (qt_cap > kPQMaxQ) qt_cap = kPQMaxQ;
  for (int lists = 1; lists >= 0; --lists)
    for (int qt = qt_cap; qt >= 1; --qt) {
      const size_t smem =
          pq_layout(list, qt, depth, depth, 1, k, lists).total;
      if (smem <= limit) return PQPlan{qt, depth, 1, lists, smem};
    }
  for (int lists = 1; lists >= 0; --lists)
    for (int slice = depth - 1; slice >= 1; --slice) {
      if (slice > 16 && slice % 16 != 0) continue;
      const size_t smem =
          pq_layout(list, 1, depth, slice, 0, k, lists).total;
      if (smem <= limit) return PQPlan{1, slice, 0, lists, smem};
    }
  return PQPlan{1, 1, 0, 0, 0};
}

// Kernel 8 (multi_scope_topk_pq), and kernel 9's PQ mode in list mode:
// query tile of qt <= 8 x row chunk (list mode: x list chunk), 16 warps.
// The tile's LUTs are copied once into shared memory; code rows (and the
// tile's scope words) come through a two-stage cp.async ring, 512 rows a
// tile, thread t owning row t (list mode: the chunk's admitted rows,
// gathered by id). A thread looks up only the queries that admit its row,
// acc += lut[j, m, code[m]] for m = 0..M-1 in order from 0.0f (Scorer<kPQ>'s
// chain); a warp whose rows no query of the tile admits skips the tile.
// Epilogue as scan_pass1_tiled's: scores that beat the list's tail go to
// shared memory, flagged per warp; warp j then gathers query j's into its
// 32-entry buffer and merges full buffers with warp_merge. A list's rank
// key is the row, or in list mode the position p * max_aligned + o.
template <bool kWide, bool kList>
__global__ void __launch_bounds__(kPQThreads, 1)
scan_pass1_pq(const PQScan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PQLayout L = pq_layout(kList, p.qt, p.depth, p.slice, p.resident,
                               p.k, p.smem_lists);
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
  int* cid = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(sv) +
                                    L.sv + L.misc);
  unsigned* cmeta = reinterpret_cast<unsigned*>(cid + L.compact / 8);
  unsigned char* misc = reinterpret_cast<unsigned char*>(cid) + L.compact;
  long long* qslot = reinterpret_cast<long long*>(misc);  // kPQMaxQ each
  int* qid = reinterpret_cast<int*>(qslot + kPQMaxQ);
  int* qkey = qid + kPQMaxQ;
  int* counter = qkey + kPQMaxQ;
  float* lv_s = reinterpret_cast<float*>(misc + kPQMisc);
  int* li_s = reinterpret_cast<int*>(lv_s + p.qt * p.k);

  const int k = p.k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t lut_bytes = static_cast<size_t>(p.depth) * 1024;  // a query's
  int nqt, count = 0, r_begin = 0;   // count: the block's rows
  ListWork lw{};
  if constexpr (kList) {
    if (!list_work(p.la, p.qt, lw, qid, qkey, qslot)) return;
    nqt = lw.nqt;
  } else {
    const int q0 = blockIdx.x * p.qt;
    nqt = min(p.qt, p.nq - q0);
    r_begin = blockIdx.y * p.chunk_rows;
    count = max(0, min(p.n, r_begin + p.chunk_rows) - r_begin);
    if (threadIdx.x < nqt) {
      qid[threadIdx.x] = q0 + threadIdx.x;
      qslot[threadIdx.x] =
          static_cast<long long>(q0 + threadIdx.x) * gridDim.y + blockIdx.y;
    }
  }
  for (int j = threadIdx.x; j < p.qt; j += kPQThreads) {
    tail_v[j] = kNegInf;        // an empty list's tail
    tail_i[j] = -1;
    bcnt[j] = 0;
    sid_s[j] = j < nqt ? p.sids[qid[j]] : -1;
  }
  __syncthreads();              // qid, qslot, sid_s
  if constexpr (kList)
    count = list_compact(p.la, lw, p.words, p.n_scopes, p.n_words, sid_s,
                         cid, cmeta, counter);
  auto list_off = [&](int j) { return static_cast<size_t>(qslot[j]) * k; };
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
  const unsigned char* lut_src = reinterpret_cast<const unsigned char*>(p.lut);
  if (p.resident)               // joins the first item's group
    stage_gather(smem, static_cast<int>(lut_bytes), lut_src, lut_bytes, qid,
                 nqt, 0, static_cast<int>(lut_bytes), p.lut_width);

  const int ns = (p.depth + p.slice - 1) / p.slice;
  const int n_tiles = (count + kPQRows - 1) / kPQRows;
  const int total = n_tiles * ns;
  auto issue = [&](int item) {
    if (item < total) {
      const int t = item / ns;
      const int s = item - t * ns;
      const int i0 = t * kPQRows;
      const int nr = min(kPQRows, count - i0);
      const int c0 = s * p.slice;
      const int len = min(p.slice, p.depth - c0);
      unsigned char* stage = ring + (item % kPQStages) * L.stage;
      if (kList)
        stage_gather(stage, L.c_stride, p.codes, p.depth, cid + i0, nr, c0,
                     len, p.code_width);
      else
        stage_copy(stage, L.c_stride,
                   p.codes + static_cast<size_t>(r_begin + i0) * p.depth +
                       c0,
                   p.depth, nr, len, p.code_width);
      if (!p.resident)
        stage_gather(stage + L.codes, p.slice * 1024, lut_src, lut_bytes,
                     qid, nqt, c0 * 1024, len * 1024, p.lut_width);
      if (!kList && s == 0) {
        uint32_t* ws =
            reinterpret_cast<uint32_t*>(stage + L.codes + L.lut_slice);
        for (int i = threadIdx.x; i < p.qt * kPQWords; i += kPQThreads) {
          const int sid = sid_s[i / kPQWords];
          const int wi = ((r_begin + i0) >> 5) + i % kPQWords;
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
  // the rank key of the block's row i for query j
  auto key_of = [&](int j, int i) {
    return kList ? qkey[j] + lw.o0 + static_cast<int>(cmeta[i] & 0xffffu)
                 : r_begin + i;
  };

  float acc[kPQMaxQ];
  unsigned admit = 0;           // bit j: query j admits this thread's row
  int key0 = 0;                 // the row's key past its query's base
  for (int item = 0; item < total; ++item) {
    cp_async_wait_all();        // item's stage has landed ...
    __syncthreads();            // ... for every thread, and item - 1 is done
    issue(item + 1);
    const int t = item / ns;
    const int s = item - t * ns;
    const int i0 = t * kPQRows;
    const int i = i0 + threadIdx.x;
    const int c0 = s * p.slice;
    const int len = min(p.slice, p.depth - c0);
    const unsigned char* stage = ring + (item % kPQStages) * L.stage;
    if (s == 0) {               // a new tile: which queries admit the row
      admit = 0u;
#pragma unroll
      for (int j = 0; j < kPQMaxQ; ++j) acc[j] = 0.0f;
      if constexpr (kList) {
        if (i < count) {
          const unsigned cm = cmeta[i];
          admit = cm >> 16;
          key0 = lw.o0 + static_cast<int>(cm & 0xffffu);
        }
      } else {
        const uint32_t* ws =
            reinterpret_cast<const uint32_t*>(stage + L.codes + L.lut_slice);
        key0 = r_begin + i;
#pragma unroll
        for (int j = 0; j < kPQMaxQ; ++j)
          if (j < nqt && i < count)
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
        const int key = kList ? qkey[j] + key0 : key0;
        if (((admit >> j) & 1u) && better(acc[j], key, tail_v[j], tail_i[j]))
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
          buf_i[j * 32 + pos] = key_of(j, i0 + 32 * w + lane);
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

template <bool kList>
cudaError_t launch_pq(dim3 grid, size_t smem, cudaStream_t stream,
                      const PQScan& p) {
  auto kern = p.k > 32 * kMergeSlots ? scan_pass1_pq<true, kList>
                                     : scan_pass1_pq<false, kList>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kPQThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the widest copy (16, 4 or 1 bytes) that every row start and slice start
// of ``base`` allows
int copy_width(const void* base, size_t row_bytes, size_t slice_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0 && row_bytes % 16 == 0 && slice_bytes % 16 == 0) return 16;
  if (a % 4 == 0 && row_bytes % 4 == 0 && slice_bytes % 4 == 0) return 4;
  return 1;
}

// Pass 2 over (nq, n_chunks, k) partials into (nq, k) outputs. With
// ``groups`` > 1 it runs in two levels: ``groups`` blocks per query each
// merge a share of the query's partials into a list of its own, written
// past all the partials (the wrapper allocates nq * groups more lists),
// then one block per query merges those -- so a few queries' hundreds of
// partials are merged by many blocks, not by one each.
cudaError_t launch_pass2(const float* part_v, const int* part_i, int nq,
                         int n_chunks, int k, const ListArgs& la,
                         int slot_lists, float* out_v, int* out_i,
                         cudaStream_t stream, int groups = 1) {
  auto run = [&](const Pass2& p, int blocks) {
    int nw = p.group >= 2 * kPass2Warps ? kPass2Warps : kWarps;
    if (static_cast<size_t>(nw) * k > kPass2SmemList)
      nw = static_cast<size_t>(kWarps) * k <= kPass2SmemList ? kWarps : 1;
    const size_t smem2 = static_cast<size_t>(nw) * k <= kPass2SmemList
                             ? sizeof(float) * 2 * nw * k
                             : 0;
    scan_pass2<<<blocks, 32 * nw, smem2, stream>>>(p, la);
    return cudaGetLastError();
  };
  const bool listed = la.flat_ids != nullptr;
  const size_t per_query = static_cast<size_t>(n_chunks) * k;
  if (groups <= 1)
    return run(Pass2{part_v, part_i, per_query, static_cast<size_t>(k),
                     n_chunks, n_chunks, k, slot_lists, listed, listed,
                     out_v, out_i},
               nq);
  const int group = (n_chunks + groups - 1) / groups;
  groups = (n_chunks + group - 1) / group;
  const size_t mid_stride = static_cast<size_t>(groups) * k;
  float* mid_v = const_cast<float*>(part_v) + nq * per_query;
  int* mid_i = const_cast<int*>(part_i) + nq * per_query;
  cudaError_t err = run(Pass2{part_v, part_i, per_query, mid_stride,
                              n_chunks, group, k, slot_lists, listed, false,
                              mid_v, mid_i},
                        nq * groups);
  if (err != cudaSuccess) return err;
  return run(Pass2{mid_v, mid_i, mid_stride, static_cast<size_t>(k), groups,
                   groups, k, 1, false, listed, out_v, out_i},
             nq);
}

// the list form's plan: the streaming pass's (fp32, int8) or the PQ pass's
// with room for a chunk's compacted rows
struct ListPlan {
  int qt, lists, blocks;
  size_t smem;
};

ListPlan list_plan(int kind, int qt_cap, int depth, int k) {
  if (qt_cap > kListQ) qt_cap = kListQ;
  if (kind == kPQ) {
    const PQPlan plan = pq_plan(1, qt_cap, depth, k);
    return ListPlan{plan.qt, 1, 1, plan.smem};
  }
  const StreamPlan plan = stream_plan(kind, 1, qt_cap, depth, k);
  return ListPlan{plan.qt, plan.lists, plan.blocks, plan.smem};
}

}  // namespace

extern "C" {

// The streaming pass 1's plan for kind 0 (fp32, kernel 1), 1 (int8,
// kernel 5) or 2 (PQ, kernel 7), a query tile of at most ``qt_cap`` <= 8
// (PQ: at most kStreamPQQ), depth ``depth`` (M for PQ) and lists of
// ``k``: writes the query tile to ``qt``, the partial lists per chunk to
// ``lists`` (1, or 4 when the warps' lists live in device memory) and the
// blocks one SM holds to ``blocks``; returns the shared memory a block
// takes, 0 for bad arguments or when nothing fits.
int repro_stream_plan(int kind, int qt_cap, int depth, int k, int* qt,
                      int* lists, int* blocks) {
  if (kind < kF32 || kind > kPQ || qt_cap < 1 || qt_cap > kStreamQ ||
      depth < 1 || k < 1)
    return 0;
  const StreamPlan plan = stream_plan(kind, 0, qt_cap, depth, k);
  *qt = plan.qt;
  *lists = plan.lists;
  *blocks = plan.blocks;
  return static_cast<int>(plan.smem);
}

// Kernels 1, 5 and 7, the fp32 / int8 / PQ scans (kind 0 / 1 / 2) with
// one dense (n,) int8 ``mask`` shared by every query (scoped_topk,
// scoped_topk_i8, scoped_topk_pq): scan_pass1_stream, then pass 2.
// ``q_scale`` and ``row_scale`` are read for int8, ``sq`` for l2; for PQ
// ``q`` is the (nq, depth, 256) f32 LUTs, ``rows`` the (n, depth) uint8
// codes, and l2 is 0 (the LUTs fold the metric in). ``qt_cap`` <= 8 caps
// the query tile (stream_plan picks it); the partials are
// (nq, n_chunks * lists, k) for
// the plan's ``lists``, and pass 2 merges each query's in ``groups``
// blocks first when ``groups`` > 1 (launch_pass2), writing nq * groups
// lists of k past them.
int repro_scan_topk_stream(int kind, const void* q, const float* q_scale,
                           const void* rows, const float* row_scale,
                           const float* sq, const int8_t* mask, int nq, int n,
                           int depth, int k, int l2, int qt_cap,
                           int chunk_rows, int n_chunks, int groups,
                           float* part_v, int* part_i, float* out_v,
                           int* out_i, void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (kind < kF32 || kind > kPQ || k < 1 || qt_cap < 1 ||
      qt_cap > kStreamQ || depth < 1 || chunk_rows < 1 || n_chunks < 1 ||
      n_chunks > 65535 || groups < 1 || mask == nullptr ||
      (l2 && (sq == nullptr || kind == kPQ)) ||
      (kind == kI8 && (q_scale == nullptr || row_scale == nullptr)))
    return cudaErrorInvalidValue;
  const StreamPlan plan = stream_plan(kind, 0, qt_cap, depth, k);
  if (plan.smem == 0) return cudaErrorInvalidValue;
  const size_t eb = kind == kF32 ? 4 : 1;
  const size_t qeb = kind == kPQ ? 1024 : eb;    // query-side bytes per depth
  StreamScan p{q, q_scale, rows, row_scale, sq, mask, nullptr, nullptr,
               ListArgs{}, 0, 0, nq, n, depth, plan.slice, k, plan.qt,
               chunk_rows, plan.smem_lists, plan.lists,
               copy_width(rows, depth * eb, plan.slice * eb),
               copy_width(q, depth * qeb, plan.slice * qeb), part_v, part_i};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((nq + plan.qt - 1) / plan.qt, n_chunks);
  cudaError_t err =
      dispatch_stream<false>(kind, l2 != 0, grid, plan.smem, stream, p);
  if (err != cudaSuccess) return err;
  return launch_pass2(part_v, part_i, nq, n_chunks * plan.lists, k,
                      ListArgs{}, 1, out_v, out_i, stream, groups);
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
    const PQPlan plan = pq_plan(0, qt_cap, depth, k);
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
    const PQPlan plan = pq_plan(0, qt_cap, depth, k);
    if (plan.smem == 0) return cudaErrorInvalidValue;
    PQScan p{static_cast<const float*>(q), static_cast<const uint8_t*>(rows),
             words, sids, ListArgs{}, n_scopes, n_words, nq, n, depth,
             plan.slice, k, plan.qt, plan.resident, chunk_rows,
             plan.smem_lists, copy_width(rows, depth, plan.slice),
             copy_width(q, depth * 1024, plan.slice * 1024), part_v, part_i};
    err = launch_pq<false>(dim3((nq + plan.qt - 1) / plan.qt, n_chunks),
                           plan.smem, stream, p);
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
  return launch_pass2(part_v, part_i, nq, n_chunks, k, ListArgs{}, 1, out_v,
                      out_i, stream);
}

// The list form's plan (kernel 9) for kind 0 (fp32), 1 (int8) or 2 (PQ), a
// query tile of at most ``qt_cap`` <= 8, depth ``depth`` (M for PQ) and
// lists of ``k``: writes the query tile to ``qt``, the partials per
// (probe slot, chunk) to ``lists``, the blocks one SM holds to ``blocks``
// and the list positions one block scans to ``chunk``; returns the shared
// memory a block takes, 0 when nothing fits or for bad arguments.
int repro_list_plan(int kind, int qt_cap, int depth, int k, int* qt,
                    int* lists, int* blocks, int* chunk) {
  if (kind < kF32 || kind > kPQ || qt_cap < 1 || qt_cap > kListQ ||
      depth < 1 || k < 1)
    return 0;
  const ListPlan plan = list_plan(kind, qt_cap, depth, k);
  *qt = plan.qt;
  *lists = plan.lists;
  *blocks = plan.blocks;
  *chunk = kListChunk;
  return static_cast<int>(plan.smem);
}

// Kernel 9 in its list form, all three kinds (0 fp32 and 1 int8:
// scan_pass1_stream; 2 PQ: scan_pass1_pq, ``q`` the LUTs and ``rows`` the
// codes), then pass 2. Query b probes lists probe[b, 0..nprobe) of the
// padded-CSR layout (offsets, aligned, flat_ids; each row of probe holds
// distinct lists); ``order`` (nq * nprobe,) int64 are the pairs
// b * nprobe + p sorted stably by probe[b, p], ``list_start`` (n_lists + 1)
// each list's first sorted pair; no list is probed by more than
// ``per_list`` queries (nq, or 1 for a candidate matrix's one-query
// lists: only the off-path candidate form passes 1, to trim the grid's
// empty query tiles). Query b admits store row r where bit r % 32 of
// words[sids[b], r / 32] is set. Ranks by (score, position
// p * max_aligned + o); returns store ids. The partials are
// (nq, nprobe * cmax * lists, k), cmax = max(1, ceil(max_aligned / chunk))
// for the plan's chunk and lists.
int repro_scan_topk_list(int kind, const void* q, const float* q_scale,
                         const void* rows, const float* row_scale,
                         const float* sq, const uint32_t* words,
                         const int* sids, int n_scopes, int n_words, int nq,
                         int depth, int k, int l2, const long long* offsets,
                         const long long* aligned, const int* flat_ids,
                         const int* probe, const long long* order,
                         const int* list_start, int n_lists, int nprobe,
                         int max_aligned, int qt_cap, int per_list,
                         float* part_v, int* part_i, float* out_v,
                         int* out_i, void* stream_ptr) {
  if (nq <= 0) return cudaSuccess;
  if (kind < kF32 || kind > kPQ || k < 1 || qt_cap < 1 || qt_cap > kListQ ||
      per_list < 1 || depth < 1 || n_lists < 1 || nprobe < 1 ||
      max_aligned < 0 ||
      static_cast<long long>(nprobe) * max_aligned > 0x7fffffffLL ||
      words == nullptr || sids == nullptr || offsets == nullptr ||
      aligned == nullptr || flat_ids == nullptr || probe == nullptr ||
      order == nullptr || list_start == nullptr ||
      (kind == kI8 && (q_scale == nullptr || row_scale == nullptr)) ||
      (kind != kPQ && l2 && sq == nullptr))
    return cudaErrorInvalidValue;
  const ListPlan plan = list_plan(kind, qt_cap, depth, k);
  if (plan.smem == 0) return cudaErrorInvalidValue;
  const int cmax = max_aligned > 0
                       ? (max_aligned + kListChunk - 1) / kListChunk
                       : 1;
  const int tiles = ((per_list < nq ? per_list : nq) + plan.qt - 1) / plan.qt;
  if (cmax > 65535 || static_cast<long long>(n_lists) * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const ListArgs la{offsets, aligned, flat_ids, probe, order, list_start,
                    nprobe, max_aligned > 0 ? max_aligned : 1, tiles,
                    kListChunk, cmax};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(n_lists * tiles, cmax);
  cudaError_t err;
  if (kind == kPQ) {
    const PQPlan pq = pq_plan(1, plan.qt, depth, k);
    PQScan p{static_cast<const float*>(q), static_cast<const uint8_t*>(rows),
             words, sids, la, n_scopes, n_words, nq, 0, depth, pq.slice, k,
             pq.qt, pq.resident, 0, pq.smem_lists,
             copy_width(rows, depth, pq.slice),
             copy_width(q, depth * 1024, pq.slice * 1024), part_v, part_i};
    err = launch_pq<true>(grid, pq.smem, stream, p);
  } else {
    const StreamPlan sp = stream_plan(kind, 1, plan.qt, depth, k);
    const size_t eb = kind == kF32 ? 4 : 1;
    StreamScan p{q, q_scale, rows, row_scale, sq, nullptr, words, sids, la,
                 n_scopes, n_words, nq, 0, depth, sp.slice, k, sp.qt, 0,
                 sp.smem_lists, sp.lists,
                 copy_width(rows, depth * eb, sp.slice * eb),
                 copy_width(q, depth * eb, sp.slice * eb), part_v, part_i};
    err = dispatch_stream<true>(kind, l2 != 0, grid, sp.smem, stream, p);
  }
  if (err != cudaSuccess) return err;
  return launch_pass2(part_v, part_i, nq, nprobe * cmax * plan.lists, k, la,
                      plan.lists, out_v, out_i, stream);
}

}  // extern "C"
