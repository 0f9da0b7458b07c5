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
// p, and the output is cast to q's type.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Each admitted position's
// K and V rows are read once: at the RAG main shape (b = 64, kv = 8, d = 128,
// bf16, ~525 admitted positions of a 532-slot cache) ~137 MB, ~41 us. The
// arithmetic (4 b h d flops per position, ~0.28 GFLOP) is far below any
// rate. Masked positions are neither scored nor read, so a ragged batch
// pays for its own lengths, and the cache is not padded to a tile multiple.
//
// Design. The TPU walks the cache as a sequential grid axis with (m, l, acc)
// in VMEM scratch; Hopper blocks run in parallel, so one block owns one
// (b, kv head) and a loop over the cache takes the grid axis's place. Per
// tile of kTile positions: the tile's mask; its K and V rows staged in
// shared memory (16-byte coalesced loads when rows allow them, zeros for
// masked rows); one thread per (query head, position) score against the
// group's queries (fp32, in shared memory); one warp per query head for the
// tile max, the rescale factor and the rounded weights; one thread per
// (query head, element) for acc = acc * alpha + p . V. Shared-memory rows
// have an odd stride in 32-bit words, so the threads of a warp, which read
// 32 consecutive rows in the score step, hit 32 different banks. The group's
// queries and accumulators live in shared memory, so any group (GQA, MQA,
// MHA) and any d up to 256 take the same code. Splitting the cache across
// blocks (flash-decoding), TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // cache positions per step
constexpr int kMaxD = 256;
constexpr float kNegInf = -FLT_MAX;       // finfo(float32).min, as _kernel
constexpr size_t kSmemLimit = 232448;     // dynamic shared memory per block

struct Layout {
  int words;     // 32-bit words of one row (zero padded past d)
  int stride;    // row stride in shared memory, in words (odd)
  int dq;        // elements of one staged query row (words * per-word)
};

__host__ __device__ inline Layout layout_of(int d, int elem) {
  Layout lay;
  lay.words = (d * elem + 3) / 4;
  lay.stride = lay.words | 1;
  lay.dq = lay.words * (4 / elem);
  return lay;
}

__host__ inline size_t smem_bytes(int group, int d, int elem) {
  const Layout lay = layout_of(d, elem);
  return sizeof(float) * (static_cast<size_t>(group) * lay.dq   // queries
                          + static_cast<size_t>(group) * d      // acc
                          + 2 * static_cast<size_t>(kTile) * lay.stride  // K, V
                          + static_cast<size_t>(group) * kTile  // scores
                          + 3 * static_cast<size_t>(group)      // m, l, alpha
                          + kTile);                             // mask
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float load(const float* p, size_t i) { return p[i]; }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, size_t i, float x) { p[i] = x; }
  __device__ static uint32_t bits(const float* p, size_t i) {
    return __float_as_uint(p[i]);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  // round-to-nearest-even to bf16 and back: jnp's astype(bfloat16)
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
  __device__ static uint32_t bits(const __nv_bfloat16* p, size_t i) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(p[i]));
  }
};

// element e of a staged row (fp32 word, or half of a bf16 pair); bf16 to
// fp32 is exact by shifting its bits into the high half
template <typename T>
__device__ __forceinline__ float staged(const uint32_t* row, int e) {
  if constexpr (Elem<T>::kPerWord == 1) {
    return __uint_as_float(row[e]);
  } else {
    const uint32_t w = row[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
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

// Stage rows [p0, p0 + kTile) of one (b, kv head) cache slice: admitted rows
// from device memory, every other row (masked, or past s) as zeros.
template <typename T, bool kVec>
__device__ void stage_rows(const T* __restrict__ src, uint32_t* dst,
                           const int* msk, int p0, int d, const Layout& lay) {
  if constexpr (kVec) {
    // d * sizeof(T) % 16 == 0: a tile is one contiguous run of 16-byte chunks
    const int cpr = lay.words / 4;                 // chunks per row
    const uint4* base = reinterpret_cast<const uint4*>(src + size_t(p0) * d);
    for (int c = threadIdx.x; c < kTile * cpr; c += kThreads) {
      const int r = c / cpr, cw = (c - r * cpr) * 4;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (msk[r]) v = __ldg(base + c);
      uint32_t* out = dst + r * lay.stride + cw;
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    }
  } else {
    constexpr int per = Elem<T>::kPerWord;
    for (int i = threadIdx.x; i < kTile * lay.words; i += kThreads) {
      const int r = i / lay.words, w = i - r * lay.words;
      uint32_t word = 0;
      if (msk[r]) {
#pragma unroll
        for (int h = 0; h < per; ++h) {
          const int e = w * per + h;
          if (e < d)
            word |= Elem<T>::bits(src, size_t(p0 + r) * d + e)
                    << (32 / per * h);
        }
      }
      dst[r * lay.stride + w] = word;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int8_t* __restrict__ mask,
                    T* __restrict__ out, int h, int kv, int s, int d,
                    float scale) {
  const int bi = blockIdx.x / kv, hi = blockIdx.x - bi * kv;
  const int group = h / kv;
  const Layout lay = layout_of(d, sizeof(T));
  extern __shared__ float smem[];
  float* qs = smem;                                  // (group, dq)
  float* acc = qs + group * lay.dq;                  // (group, d)
  uint32_t* ks = reinterpret_cast<uint32_t*>(acc + group * d);
  uint32_t* vs = ks + kTile * lay.stride;
  float* sc = reinterpret_cast<float*>(vs + kTile * lay.stride);
  float* m = sc + group * kTile;
  float* l = m + group;
  float* alpha = l + group;
  int* msk = reinterpret_cast<int*>(alpha + group);

  const size_t head0 = size_t(bi) * h + size_t(hi) * group;
  for (int i = threadIdx.x; i < group * lay.dq; i += kThreads) {
    const int g = i / lay.dq, e = i - g * lay.dq;
    qs[i] = e < d ? Elem<T>::load(q, (head0 + g) * d + e) : 0.f;
  }
  for (int i = threadIdx.x; i < group * d; i += kThreads) acc[i] = 0.f;
  for (int g = threadIdx.x; g < group; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  const size_t slice = (size_t(bi) * kv + hi) * size_t(s);
  const T* kslice = k + slice * d;
  const T* vslice = v + slice * d;
  const int8_t* mrow = mask + size_t(bi) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int p0 = 0; p0 < s; p0 += kTile) {
    int any = 0;
    if (threadIdx.x < kTile) {
      const int pos = p0 + threadIdx.x;
      any = pos < s && mrow[pos] != 0;
      msk[threadIdx.x] = any;
    }
    if (!__syncthreads_or(any)) continue;          // nothing admitted here

    stage_rows<T, kVec>(kslice, ks, msk, p0, d, lay);
    stage_rows<T, kVec>(vslice, vs, msk, p0, d, lay);
    __syncthreads();

    // scores: one thread per (query head, position)
    for (int i = threadIdx.x; i < group * kTile; i += kThreads) {
      const int g = i / kTile, p = i - g * kTile;
      float sv = kNegInf;
      if (msk[p]) {
        constexpr int per = Elem<T>::kPerWord;
        const uint32_t* row = ks + p * lay.stride;
        const float* qg = qs + g * lay.dq;
        float dot = 0.f;
        for (int w = 0; w < lay.words; ++w) {
          const uint32_t word = row[w];
#pragma unroll
          for (int j = 0; j < per; ++j)
            dot = fmaf(qg[w * per + j], staged<T>(&word, j), dot);
        }
        sv = dot * scale;
      }
      sc[i] = sv;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      float* sg = sc + g * kTile;
      float mt = kNegInf;
      for (int p = lane; p < kTile; p += 32)
        if (msk[p]) mt = fmaxf(mt, sg[p]);
      mt = warp_max(mt);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int p = lane; p < kTile; p += 32) {
        const float pv = msk[p] ? expf(sg[p] - m_new) : 0.f;
        sum += pv;
        sg[p] = Elem<T>::round(pv);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V: one thread per (query head, element)
    for (int i = threadIdx.x; i < group * d; i += kThreads) {
      const int g = i / d, e = i - g * d;
      const float* pg = sc + g * kTile;
      float dot = 0.f;
      for (int p = 0; p < kTile; ++p)
        dot = fmaf(pg[p], staged<T>(vs + p * lay.stride, e), dot);
      acc[i] = acc[i] * alpha[g] + dot;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < group * d; i += kThreads) {
    const int g = i / d, e = i - g * d;
    Elem<T>::store(out, (head0 + g) * d + e, acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int8_t* mask, void* out, int b, int h, int kv, int s,
                   int d, cudaStream_t stream) {
  const int group = h / kv;
  const size_t smem = smem_bytes(group, d, sizeof(T));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = vec ? flash_decode_kernel<T, true> : flash_decode_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // 1/sqrt(d) rounded once from double, as the reference's python float
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  kernel<<<b * kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), h, kv, s, d,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and out alike). q, out (b, h, d); k, v
// (b, kv, s, d); mask (b, s) int8, non-zero = admitted. All contiguous.
int repro_flash_decode(int dtype, const void* q, const void* k, const void* v,
                       const int8_t* mask, void* out, int b, int h, int kv,
                       int s, int d, void* stream_ptr) {
  if (b <= 0) return cudaSuccess;
  if (kv < 1 || h < kv || h % kv != 0 || s < 1 || d < 1 || d > kMaxD ||
      static_cast<long long>(b) * kv > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) return launch<float>(q, k, v, mask, out, b, h, kv, s, d, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, out, b, h, kv, s, d, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
