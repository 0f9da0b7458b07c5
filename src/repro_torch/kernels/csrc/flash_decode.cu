// GQA flash-decode attention for Hopper (sm_90a): one query token per
// sequence against its KV cache, fp32 or bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode (_kernel), the decode hot loop of the LM that the RAG server
// answers with (repro_torch/models/attention.py::decode_attention).
//
// What it computes, per batch row b and query head h (kv head h / group):
//   out = sum_j p_j v_j / max(sum_j p_j, 1e-30), p_j = exp(s_j - max s),
//   s_j = (q . k_j) / sqrt(d), over the positions j that mask[b, j] admits.
// A row that admits nothing gives zeros, not NaN. As in _kernel, scores and
// the running statistics (m, l, acc) are fp32, p is rounded to the cache's
// type before the PV product (p.astype(vv.dtype)) while l sums the unrounded
// p, and the output is cast to q's type. The scale 1/sqrt(d) is rounded once
// from double; masked scores are finfo(float32).min.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Each admitted position's
// K and V rows are read once: at the RAG main shape (b = 64, kv = 8, d = 128,
// bf16, ~525 admitted positions of a 532-slot cache) ~137 MB, ~41 us. The
// arithmetic (4 h d flops per admitted position, 2-5 flops a byte at groups
// 1-5) is far below the tensor cores' ridge (~295 flops a byte). So the
// design spends itself on keeping bytes in flight on every SM:
//
// * The cache is split across blocks (flash-decoding). The grid is
//   (b * kv [* 16-row group slices], n_split); split i owns a contiguous run
//   of whole 64-position tiles (split_span; the wrapper's split_ranges says
//   the same). With one split a block writes the output; with more, each
//   writes its partial (m, l, acc) in fp32 to a workspace, and
//   flash_decode_combine merges the partials in split order (M = max m_i,
//   l = sum l_i e^(m_i - M), acc = sum acc_i e^(m_i - M)). No atomics and no
//   "last block" counter, so two calls on the same inputs are bitwise equal.
//   n_split comes from the wrapper (flash_decode.py::split_plan): as many
//   as keep the blocks within one wave of two on every SM, 1 when b * kv
//   blocks fill more than half of that wave already.
// * The K and V tiles stream through a 2-3 stage ring in shared memory with
//   16-byte cp.async, so the next tiles' bytes are in flight while the
//   current one is computed. A masked row is zero-filled (src-size 0), never
//   read. A tile's mask bytes are loaded two tiles before its copies are
//   issued, into a ring of their own (two slots more than K / V), so
//   neither the copies nor the barrier wait on a load. Odd d and
//   misaligned caches stage with scalar loads instead.
// * bf16 products run on the tensor cores (mma.sync.m16n8k16, fp32
//   accumulate): S = Q K^T with the group's query rows in M (zero-padded to
//   16; a group above 16 takes one block per 16-row slice), K through
//   ldmatrix; O += P V with the S accumulator turned straight into the A
//   fragment, rounded to bf16 (which is the reference's p.astype), V through
//   ldmatrix.trans. d pads with zeros to 16 * DC (exact). Each warp (8 a
//   block up to d = 64; above, 4, or 2 where the grid is large: see
//   launch) owns 16 positions of a tile with its own (m, l, acc) in
//   registers and skips a slice with no admitted position; the warps
//   merge once at the end, as the splits do. So MHA (group 1) keeps every
//   warp busy. Staged rows are 16 bytes longer than their width, so
//   ldmatrix's 8 rows fall in 8 different bank groups. The query fragments
//   stay in registers up to d = 128, and exp is __expf (a few ulp of fp32,
//   far below p's bf16 rounding).
// * fp32 stays on IEEE FMAs (never TF32): the block scores 32-position tiles
//   one thread per (query head, position), one warp per query head for the
//   softmax, one thread per (query head, element) for the PV product, with
//   the group's queries and accumulators in shared memory (a group whose
//   queries and accumulators do not fit is refused). It shares the split
//   and the ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;            // the fp32 kernel and the combine
constexpr int kWarps = kThreads / 32;
constexpr int kSplitTile = 64;            // positions of the unit a split owns
constexpr int kMmaRows = 16;              // query rows of one mma slice
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 65535;          // gridDim.y
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min, as _kernel
constexpr size_t kSmemLimit = 232448;     // dynamic shared memory per block
constexpr size_t kThreeStageMax = 112 * 1024;  // a larger 3-stage ring takes 2

template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static uint32_t bits(const float* p, size_t i) {
    return __float_as_uint(p[i]);
  }
  __device__ static void store(float* p, size_t i, float x) { p[i] = x; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static uint32_t bits(const __nv_bfloat16* p, size_t i) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(p[i]));
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

// Everything a block needs, computed once on the host.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int8_t* mask;
  void* out;
  float* part_ml;    // (b * kv, n_split, group, 2): m, l of each split
  float* part_acc;   // (b * kv, n_split, group, d)
  int h, kv, s, d, group, n_split, n_slices;
  float scale;
  int stride;        // bytes between staged rows (16 B past the width)
  int width_words;   // 32-bit words of a staged row's width
  int words;         // words a row's elements fill (ceil(d * elem / 4))
  int ns;            // ring stages
  int vec;           // rows are 16-byte chunks: stage with cp.async
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// tile i's group has landed when at most ns - 2 later groups are pending
__device__ __forceinline__ void cp_async_wait_tile(int ns) {
  if (ns == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the four lanes of an mma row quad (lane & 3) hold one row's columns
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Positions [begin, end) of split `split`: whole 64-position tiles
// [tiles * split / n_split, tiles * (split + 1) / n_split), cut at s.
struct Span {
  int begin, end;
};

__device__ __forceinline__ Span split_span(int s, int n_split, int split) {
  const long long tiles = (s + kSplitTile - 1) / kSplitTile;
  const int t0 = static_cast<int>(tiles * split / n_split);
  const int t1 = static_cast<int>(tiles * (split + 1) / n_split);
  return {t0 * kSplitTile, min(t1 * kSplitTile, s)};
}

// The streaming state of one block: the K / V rings, the mask ring (two
// slots more: a tile's mask bytes are loaded two tiles before its copies
// are issued) and the span it walks.
template <typename T, int kTile, int kThr>
struct Stream {
  char* kring;
  char* vring;
  uint8_t* mring;
  const char* kbase;      // this (b, kv head)'s cache slice
  const char* vbase;
  const int8_t* mrow;     // this batch row's mask
  int begin, end, n_tiles;

  __device__ int slot_bytes(const Args& a) const { return kTile * a.stride; }

  // Tile j's admitted flags (0 past the span) for thread t < kTile.
  __device__ uint8_t mask_of(int j) const {
    const int p = begin + j * kTile + static_cast<int>(threadIdx.x);
    return j < n_tiles && p < end && mrow[p] != 0;
  }

  __device__ uint8_t* mask_slot(const Args& a, int j) const {
    return mring + (j % (a.ns + 2)) * kTile;
  }

  // Start tile j's copies into ring slot j % ns: admitted rows from device
  // memory, the others as zeros, never read.
  __device__ void issue(const Args& a, int j) const {
    if (j >= n_tiles) return;
    const uint8_t* msk = mask_slot(a, j);
    const size_t row_bytes = static_cast<size_t>(a.d) * sizeof(T);
    const size_t p0 = static_cast<size_t>(begin) + static_cast<size_t>(j) * kTile;
    char* kd = kring + (j % a.ns) * slot_bytes(a);
    char* vd = vring + (j % a.ns) * slot_bytes(a);
    if (a.vec) {
      // chunk c = (row r, 16-byte chunk cc), stepped without a division
      const int cpr = static_cast<int>(row_bytes / 16);
      const int dr = kThr / cpr, dcc = kThr - dr * cpr;
      int r = threadIdx.x / cpr, cc = threadIdx.x - r * cpr;
      for (; r < kTile; r += dr, cc += dcc) {
        if (cc >= cpr) {
          cc -= cpr;
          if (++r == kTile) break;
        }
        const bool ok = msk[r] != 0;
        const size_t off = ok ? (p0 + r) * row_bytes + cc * 16 : 0;
        const int at = r * a.stride + cc * 16;
        cp_async16(smem_u32(kd + at), kbase + off, ok ? 16 : 0);
        cp_async16(smem_u32(vd + at), vbase + off, ok ? 16 : 0);
      }
    } else {
      constexpr int per = 4 / sizeof(T);
      const T* ks = reinterpret_cast<const T*>(kbase);
      const T* vs = reinterpret_cast<const T*>(vbase);
      for (int i = threadIdx.x; i < kTile * a.words; i += kThr) {
        const int r = i / a.words, w = i - r * a.words;
        uint32_t kw = 0, vw = 0;
        if (msk[r]) {
#pragma unroll
          for (int hh = 0; hh < per; ++hh) {
            const int e = w * per + hh;
            if (e < a.d) {
              const size_t at = (p0 + r) * a.d + e;
              kw |= Elem<T>::bits(ks, at) << (32 / per * hh);
              vw |= Elem<T>::bits(vs, at) << (32 / per * hh);
            }
          }
        }
        *reinterpret_cast<uint32_t*>(kd + r * a.stride + 4 * w) = kw;
        *reinterpret_cast<uint32_t*>(vd + r * a.stride + 4 * w) = vw;
      }
    }
  }

  // Zero the words past a row's elements (the padded width) in every ring
  // slot: the copies never write them, and the products read them.
  __device__ void zero_padding(const Args& a) const {
    const int pad = a.width_words - a.words;
    if (pad <= 0) return;
    // kring and vring are adjacent: 2 * ns * kTile rows
    for (int i = threadIdx.x; i < 2 * a.ns * kTile * pad; i += kThr) {
      const int r = i / pad, w = a.words + (i - r * pad);
      *reinterpret_cast<uint32_t*>(kring + r * a.stride + 4 * w) = 0u;
    }
  }

  // The masks of tiles 0..ns, then (after a barrier) the copies of tiles
  // 0..ns-2. The caller syncs between the two. Iteration i of the main loop
  // loads tile i + ns + 2's mask and stores tile i + ns + 1's (loaded one
  // iteration before) into the slot tile i - 1 left.
  __device__ void prime_masks(const Args& a) const {
    if (threadIdx.x < kTile)
      for (int j = 0; j <= a.ns; ++j) mask_slot(a, j)[threadIdx.x] = mask_of(j);
  }

  __device__ void prime_copies(const Args& a) const {
    for (int j = 0; j + 1 < a.ns; ++j) {
      issue(a, j);
      cp_async_commit();
    }
  }
};

// One output element from its (m, l, acc): the output itself with one
// split, else this split's partial.
template <typename T>
__device__ __forceinline__ void finish(const Args& a, int row_blk, int g,
                                       int e, float m, float l, float acc) {
  if (a.n_split == 1) {
    const size_t head = static_cast<size_t>(row_blk / a.kv) * a.h +
                        static_cast<size_t>(row_blk % a.kv) * a.group + g;
    Elem<T>::store(static_cast<T*>(a.out), head * a.d + e,
                   acc / fmaxf(l, 1e-30f));
    return;
  }
  const size_t at = (static_cast<size_t>(row_blk) * a.n_split + blockIdx.y) *
                        a.group + g;
  a.part_acc[at * a.d + e] = acc;
  if (e == 0) {
    a.part_ml[2 * at] = m;
    a.part_ml[2 * at + 1] = l;
  }
}

// bf16 on mma.sync. DC: 16-element chunks of the padded head dim; NW:
// warps, each on 16 positions of a 16 * NW-position tile.
template <int DC, int NW>
__device__ void mma_body(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int kThr = 32 * NW;
  constexpr int kTile = 16 * NW;
  constexpr int kNT = 2 * DC;             // 8-wide n-tiles of the width
  constexpr int kW = 16 * DC;             // padded width, elements
  extern __shared__ __align__(16) char smem[];

  const int row_blk = blockIdx.x / a.n_slices;
  const int g0 = (blockIdx.x - row_blk * a.n_slices) * kMmaRows;
  const int gs = min(kMmaRows, a.group - g0);
  const int bi = row_blk / a.kv;
  const Span span = split_span(a.s, a.n_split, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;

  Stream<T, kTile, kThr> st;
  const size_t ring = static_cast<size_t>(a.ns) * kTile * a.stride;
  st.kring = smem;
  st.vring = smem + ring;
  char* qs = smem + 2 * ring;                       // (16, stride)
  st.mring = reinterpret_cast<uint8_t*>(qs + kMmaRows * a.stride);
  const size_t slice = static_cast<size_t>(row_blk) * a.s * a.d * sizeof(T);
  st.kbase = static_cast<const char*>(a.k) + slice;
  st.vbase = static_cast<const char*>(a.v) + slice;
  st.mrow = a.mask + static_cast<size_t>(bi) * a.s;
  st.begin = span.begin;
  st.end = span.end;
  st.n_tiles = span.end > span.begin
                   ? (span.end - span.begin + kTile - 1) / kTile : 0;

  // the slice's query rows, zero past gs and d
  const T* q = static_cast<const T*>(a.q);
  const size_t head0 = static_cast<size_t>(bi) * a.h +
                       static_cast<size_t>(row_blk % a.kv) * a.group + g0;
  for (int i = tid; i < kMmaRows * (kW / 2); i += kThr) {
    const int r = i / (kW / 2), e = 2 * (i - r * (kW / 2));
    uint32_t word = 0;
    if (r < gs) {
      if (e < a.d) word = Elem<T>::bits(q, (head0 + r) * a.d + e);
      if (e + 1 < a.d) word |= Elem<T>::bits(q, (head0 + r) * a.d + e + 1) << 16;
    }
    *reinterpret_cast<uint32_t*>(qs + r * a.stride + 2 * e) = word;
  }
  st.zero_padding(a);
  st.prime_masks(a);
  __syncthreads();
  st.prime_copies(a);

  // ldmatrix lane addresses. Q (A, 16 x 16): lanes 0-15 rows 0-15 at
  // column 0, lanes 16-31 the same rows at column 8. K (B of S = Q K^T):
  // matrices (positions 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15) of the warp's 16. V (B of O = P V, transposed): (0-7,
  // n-tile 0), (8-15, n-tile 0), (0-7, n-tile 1), (8-15, n-tile 1).
  const uint32_t q_addr =
      smem_u32(qs) + (lane & 15) * a.stride + (lane >> 4) * 16;
  const int k_row = warp * 16 + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t k_off = k_row * a.stride + ((lane >> 3) & 1) * 16;
  const int v_row = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const uint32_t v_off = v_row * a.stride + (lane >> 4) * 16;

  // the query fragments stay in registers up to d = 128 (32 of them)
  constexpr bool kQRegs = DC <= 8;
  uint32_t qf[kQRegs ? DC : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < DC; ++c) ldmatrix_x4(qf[c], q_addr + c * 32);
  }
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8

  uint8_t m_cur = tid < kTile ? st.mask_of(a.ns + 1) : 0;
  for (int i = 0; i < st.n_tiles; ++i) {
    cp_async_wait_tile(a.ns);
    __syncthreads();                     // tile i landed; slot i - 1 free
    st.issue(a, i + a.ns - 1);
    cp_async_commit();
    const uint8_t m_next = tid < kTile ? st.mask_of(i + a.ns + 2) : 0;

    const uint8_t* msk = st.mask_slot(a, i) + warp * 16;
    if (__any_sync(0xffffffffu, lane < 16 && msk[lane & 15])) {
      const uint32_t k_addr = smem_u32(st.kring + (i % a.ns) * st.slot_bytes(a)) + k_off;
      const uint32_t v_addr = smem_u32(st.vring + (i % a.ns) * st.slot_bytes(a)) + v_off;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        uint32_t qa[4], kb[4];
        if constexpr (kQRegs) {
          qa[0] = qf[c][0];
          qa[1] = qf[c][1];
          qa[2] = qf[c][2];
          qa[3] = qf[c][3];
        } else {
          ldmatrix_x4(qa, q_addr + c * 32);
        }
        ldmatrix_x4(kb, k_addr + c * 32);
        mma_bf16(sc[0], qa, kb[0], kb[1]);
        mma_bf16(sc[1], qa, kb[2], kb[3]);
      }
      // sc[n][0..1]: row gid, positions 8n + 2 t4 + {0, 1}; [2..3]: gid + 8
      bool ok[2][2];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ok[n][j] = msk[8 * n + 2 * t4 + j] != 0;
          sc[n][j] = ok[n][j] ? sc[n][j] * a.scale : kNegInf;
          sc[n][j + 2] = ok[n][j] ? sc[n][j + 2] * a.scale : kNegInf;
          mx0 = fmaxf(mx0, sc[n][j]);
          mx1 = fmaxf(mx1, sc[n][j + 2]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[n][j] = ok[n][j] ? __expf(sc[n][j] - mn0) : 0.f;
          sc[n][j + 2] = ok[n][j] ? __expf(sc[n][j + 2] - mn1) : 0.f;
          sum0 += sc[n][j];
          sum1 += sc[n][j + 2];
        }
      const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
      l0 = l0 * al0 + quad_sum(sum0);
      l1 = l1 * al1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
      // the S accumulator is the A fragment of P (16 rows x 16 positions)
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + c * 32);
#pragma unroll
        for (int n = 2 * c; n < 2 * c + 2; ++n) {
          acc[n][0] *= al0;
          acc[n][1] *= al0;
          acc[n][2] *= al1;
          acc[n][3] *= al1;
        }
        mma_bf16(acc[2 * c], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * c + 1], pa, vb[2], vb[3]);
      }
    }
    if (tid < kTile) st.mask_slot(a, i + a.ns + 1)[tid] = m_cur;
    m_cur = m_next;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                       // the rings are free

  // each warp's (m, l, acc) to shared memory, then merged in warp order
  float* wacc = reinterpret_cast<float*>(smem);     // (warps, 16, kW)
  float* wm = wacc + NW * kMmaRows * kW;            // (warps, 16)
  float* wl = wm + NW * kMmaRows;
  float* mine = wacc + (warp * kMmaRows + gid) * kW + 2 * t4;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    mine[8 * n] = acc[n][0];
    mine[8 * n + 1] = acc[n][1];
    mine[8 * kW + 8 * n] = acc[n][2];
    mine[8 * kW + 8 * n + 1] = acc[n][3];
  }
  if (t4 == 0) {
    wm[warp * kMmaRows + gid] = m0;
    wm[warp * kMmaRows + gid + 8] = m1;
    wl[warp * kMmaRows + gid] = l0;
    wl[warp * kMmaRows + gid + 8] = l1;
  }
  __syncthreads();
  for (int i = tid; i < gs * a.d; i += kThr) {
    const int r = i / a.d, e = i - r * a.d;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * kMmaRows + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * kMmaRows + r] - M);
      L += wl[w * kMmaRows + r] * f;
      A += wacc[(w * kMmaRows + r) * kW + e] * f;
    }
    finish<T>(a, row_blk, g0 + r, e, M, L, A);
  }
}

// fp32 on IEEE FMAs, the whole group in one block.
__device__ void simt_body(const Args& a) {
  using T = float;
  constexpr int kTile = 32;               // one lane per position
  extern __shared__ __align__(16) char smem[];

  const int row_blk = blockIdx.x, G = a.group, d = a.d;
  const int bi = row_blk / a.kv;
  const int dq = a.width_words;           // staged width, a multiple of 4
  const Span span = split_span(a.s, a.n_split, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Stream<T, kTile, kThreads> st;
  const size_t ring = static_cast<size_t>(a.ns) * kTile * a.stride;
  st.kring = smem;
  st.vring = smem + ring;
  float* qs = reinterpret_cast<float*>(smem + 2 * ring);   // (G, dq)
  float* acc = qs + G * dq;                                // (G, d)
  float* sc = acc + G * d;                                 // (G, kTile)
  float* m = sc + G * kTile;
  float* l = m + G;
  float* alpha = l + G;
  st.mring = reinterpret_cast<uint8_t*>(alpha + G);
  const size_t slice = static_cast<size_t>(row_blk) * a.s * d * sizeof(T);
  st.kbase = static_cast<const char*>(a.k) + slice;
  st.vbase = static_cast<const char*>(a.v) + slice;
  st.mrow = a.mask + static_cast<size_t>(bi) * a.s;
  st.begin = span.begin;
  st.end = span.end;
  st.n_tiles = span.end > span.begin
                   ? (span.end - span.begin + kTile - 1) / kTile : 0;

  const float* q = static_cast<const float*>(a.q);
  const size_t head0 = static_cast<size_t>(bi) * a.h +
                       static_cast<size_t>(row_blk % a.kv) * G;
  for (int i = tid; i < G * dq; i += kThreads) {
    const int g = i / dq, e = i - g * dq;
    qs[i] = e < d ? q[(head0 + g) * d + e] : 0.f;
  }
  for (int i = tid; i < G * d; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  st.zero_padding(a);
  st.prime_masks(a);
  __syncthreads();
  st.prime_copies(a);

  uint8_t m_cur = tid < kTile ? st.mask_of(a.ns + 1) : 0;
  for (int i = 0; i < st.n_tiles; ++i) {
    cp_async_wait_tile(a.ns);
    const uint8_t* msk = st.mask_slot(a, i);
    // tile i landed; slot i - 1 free; anything admitted here?
    const int any = __syncthreads_or(tid < kTile && msk[tid]);
    st.issue(a, i + a.ns - 1);
    cp_async_commit();
    const uint8_t m_next = tid < kTile ? st.mask_of(i + a.ns + 2) : 0;
    if (any) {
      const char* ks = st.kring + (i % a.ns) * st.slot_bytes(a);
      const char* vs = st.vring + (i % a.ns) * st.slot_bytes(a);
      // scores: one thread per (query head, position)
      for (int idx = tid; idx < G * kTile; idx += kThreads) {
        const int g = idx / kTile, p = idx - g * kTile;
        float sv = kNegInf;
        if (msk[p]) {
          const float4* row = reinterpret_cast<const float4*>(ks + p * a.stride);
          const float4* qg = reinterpret_cast<const float4*>(qs + g * dq);
          float dot = 0.f;
          for (int w = 0; w < dq / 4; ++w) {
            const float4 kk = row[w], qq = qg[w];
            dot = fmaf(qq.x, kk.x, dot);
            dot = fmaf(qq.y, kk.y, dot);
            dot = fmaf(qq.z, kk.z, dot);
            dot = fmaf(qq.w, kk.w, dot);
          }
          sv = dot * a.scale;
        }
        sc[idx] = sv;
      }
      __syncthreads();
      // online softmax: one warp per query head, one lane per position
      for (int g = warp; g < G; g += kWarps) {
        const bool ok = msk[lane] != 0;
        const float sv = sc[g * kTile + lane];
        const float m_prev = m[g];
        const float m_new = fmaxf(m_prev, warp_max(ok ? sv : kNegInf));
        const float pv = ok ? expf(sv - m_new) : 0.f;
        const float sum = warp_sum(pv);
        sc[g * kTile + lane] = pv;
        if (lane == 0) {
          const float al = expf(m_prev - m_new);
          alpha[g] = al;
          l[g] = l[g] * al + sum;
          m[g] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * alpha + p . V: one thread per (query head, element)
      for (int idx = tid; idx < G * d; idx += kThreads) {
        const int g = idx / d, e = idx - g * d;
        const float* pg = sc + g * kTile;
        float dot = 0.f;
#pragma unroll 8
        for (int p = 0; p < kTile; ++p)
          dot = fmaf(pg[p],
                     reinterpret_cast<const float*>(vs + p * a.stride)[e], dot);
        acc[idx] = acc[idx] * alpha[g] + dot;
      }
    }
    if (tid < kTile) st.mask_slot(a, i + a.ns + 1)[tid] = m_cur;
    m_cur = m_next;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, e = i - g * d;
    finish<T>(a, row_blk, g, e, m[g], l[g], acc[i]);
  }
}

// The split kernel. Its name is what the profiler matches as kernel 10's
// launch: one per wrapper call.
template <typename T, int DC, int NW>
__global__ void __launch_bounds__(32 * NW) flash_decode_kernel(Args a) {
  if constexpr (sizeof(T) == 2)
    mma_body<DC, NW>(a);
  else
    simt_body(a);
}

// Merges the n_split partials of one query head (b, kv head, g) in split
// order: one block per head, a thread per element; every thread reads the
// splits' (m, l) (the same addresses: broadcasts), so the loads of the
// splits are independent and in flight together.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int group, int d, int n_split) {
  const int head = blockIdx.x;                   // (b, kv head, g), b-major
  const int row_blk = head / group, g = head - row_blk * group;
  const size_t first = static_cast<size_t>(row_blk) * n_split * group + g;
  float M = kNegInf;
  for (int sp = 0; sp < n_split; ++sp)
    M = fmaxf(M, part_ml[2 * (first + static_cast<size_t>(sp) * group)]);
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float L = 0.f, A = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t at = first + static_cast<size_t>(sp) * group;
      const float f = expf(part_ml[2 * at] - M);
      L += part_ml[2 * at + 1] * f;
      A += part_acc[at * d + e] * f;
    }
    Elem<T>::store(out, static_cast<size_t>(head) * d + e, A / fmaxf(L, 1e-30f));
  }
}

// The max dynamic shared memory attribute, set once per kernel and device,
// and each device's SM count.
constexpr int kMaxDevices = 64;
std::atomic<unsigned> g_smem_set[kMaxDevices];
std::atomic<int> g_sms[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bit, size_t smem, int dev) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (dev < kMaxDevices && (g_smem_set[dev].load() >> bit & 1u)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  if (err == cudaSuccess && dev < kMaxDevices) g_smem_set[dev].fetch_or(1u << bit);
  return err;
}

cudaError_t sm_count(int dev, int* sms) {
  *sms = dev < kMaxDevices ? g_sms[dev].load() : 0;
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) g_sms[dev].store(*sms);
  return err;
}

// The mma kernels' geometry, from the head dim and the grid (measured on an
// H100, tools/flash_variants.py):
// * up to d = 64 (kWideChunks), 8 warps and a 2-stage ring: short rows leave
//   a warp's tile little work to hide the ring's latency behind, so more
//   warps an SM (three such blocks) win;
// * above, 4 warps and 3 stages where they fit (two blocks an SM at
//   d = 128); but 2 warps (four such blocks an SM) once one split already
//   gives kTwoWarpBlocks blocks an SM or more: the RAG main shape's 512
//   blocks then run in one wave, not two. Below that, 2-warp blocks leave
//   SMs short of warps (and the splits are sized for 4-warp blocks).
constexpr int kChunks[] = {1, 2, 4, 6, 8, 16};
constexpr int kWideChunks = 4;            // the largest chunk count on 8 warps
constexpr int kTwoWarpBlocks = 3;

template <int DC>
void (*mma_kernel(int warps))(Args) {
  using T = __nv_bfloat16;
  if constexpr (DC <= kWideChunks) {
    return flash_decode_kernel<T, DC, 8>;
  } else {
    return warps == 2 ? flash_decode_kernel<T, DC, 2>
                      : flash_decode_kernel<T, DC, 4>;
  }
}

template <typename T>
cudaError_t launch(Args a, int b, int dev, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const size_t row_bytes = static_cast<size_t>(a.d) * sizeof(T);
  a.words = static_cast<int>((row_bytes + 3) / 4);
  a.n_slices = kMma ? (a.group + kMmaRows - 1) / kMmaRows : 1;
  const long long rows = static_cast<long long>(b) * a.kv * a.n_slices;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  int idx = 0, warps = kWarps;
  size_t fixed = 0;
  if constexpr (kMma) {
    while (kChunks[idx] < (a.d + 15) / 16) ++idx;
    a.width_words = 8 * kChunks[idx];
    if (kChunks[idx] <= kWideChunks) {
      warps = 8;
    } else {
      int sms = 0;
      const cudaError_t err = sm_count(dev, &sms);
      if (err != cudaSuccess) return err;
      warps = a.n_split == 1 && rows >= kTwoWarpBlocks * static_cast<long long>(sms)
                  ? 2 : 4;
    }
  } else {
    a.width_words = (a.d + 3) / 4 * 4;
  }
  const int tile = kMma ? 16 * warps : 32;
  a.stride = 4 * a.width_words + 16;
  if constexpr (kMma) {
    fixed = static_cast<size_t>(kMmaRows) * a.stride;
  } else {
    const size_t G = a.group;
    fixed = sizeof(float) * (G * a.width_words + G * a.d + G * tile + 3 * G);
  }
  auto smem_of = [&](int ns) {
    return 2 * static_cast<size_t>(ns) * tile * a.stride + fixed +
           static_cast<size_t>(ns + 2) * tile;
  };
  a.ns = warps != 8 && smem_of(3) <= kThreeStageMax ? 3 : 2;
  const size_t smem = smem_of(a.ns);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  a.vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  // 1/sqrt(d) rounded once from double, as the reference's python float
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.d)));

  void (*kernel)(Args) = flash_decode_kernel<float, 0, kWarps>;
  int bit = 12;                            // one bit a kernel
  if constexpr (kMma) {
    switch (kChunks[idx]) {
      case 1: kernel = mma_kernel<1>(warps); break;
      case 2: kernel = mma_kernel<2>(warps); break;
      case 4: kernel = mma_kernel<4>(warps); break;
      case 6: kernel = mma_kernel<6>(warps); break;
      case 8: kernel = mma_kernel<8>(warps); break;
      default: kernel = mma_kernel<16>(warps); break;
    }
    bit = idx + (warps == 2 ? 6 : 0);
  }
  cudaError_t err = allow_smem(kernel, bit, smem, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(a.n_split));
  kernel<<<grid, 32 * warps, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  flash_decode_combine<T><<<b * a.h, kThreads, 0, stream>>>(
      a.part_ml, a.part_acc, static_cast<T*>(a.out), a.group, a.d, a.n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and out alike). q, out (b, h, d); k, v
// (b, kv, s, d); mask (b, s) int8, non-zero = admitted. All contiguous, on
// CUDA device `device`, which is made current for the launch if it is not.
// n_split >= 1 splits of the cache's 64-position tiles; with n_split > 1,
// ws holds b * kv * n_split * (h / kv) * (d + 2) floats of partials.
int repro_flash_decode(int dtype, const void* q, const void* k, const void* v,
                       const int8_t* mask, void* out, void* ws, int b, int h,
                       int kv, int s, int d, int n_split, int device,
                       void* stream_ptr) {
  if (b <= 0) return cudaSuccess;
  if (kv < 1 || h < kv || h % kv != 0 || s < 1 || d < 1 || d > kMaxD ||
      n_split < 1 || n_split > kMaxSplit ||
      n_split > (s + kSplitTile - 1) / kSplitTile ||
      (n_split > 1 && ws == nullptr) ||
      static_cast<long long>(b) * kv > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = out;
  a.h = h;
  a.kv = kv;
  a.s = s;
  a.d = d;
  a.group = h / kv;
  a.n_split = n_split;
  if (n_split > 1) {
    a.part_ml = static_cast<float*>(ws);
    a.part_acc = a.part_ml + 2 * static_cast<size_t>(b) * kv * n_split * a.group;
  }
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = dtype == 0 ? launch<float>(a, b, device, stream)
                   : launch<__nv_bfloat16>(a, b, device, stream);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // extern "C"
