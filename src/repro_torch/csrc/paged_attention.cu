// Paged single-query decode attention (GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/flash_attention.py (body `_paged_kernel`, launched by
// the pl.pallas_call in `paged_attention`).  The plain PyTorch version is
// repro_torch/kernels/ref.py::paged_attention_ref; the wrapper that
// checks arguments and launches this file is
// repro_torch/kernels/paged_attention.py.
//
// What it computes, for every sequence b and query head h:
//   out[b, h] = sum_t softmax_t(cap(scale * q[b, h] . k_t)) * v_t
// over the row's logical positions t < lengths[b], where position t lives
// in physical page block_tables[b, t / bs] at offset t % bs, in kv head
// h / G (G = H / K).  Entries of -1 in the table are unallocated pages:
// they are skipped and never dereferenced (the Pallas kernel clips them to
// page 0 and masks them).  cap is the tanh softcap when softcap > 0.  For
// an int8 pool, K/V rows are multiplied by their per-(page, offset,
// kv-head) float scales before use.  A row with no valid position returns
// 0, as the Pallas kernel's acc / max(l, 1e-30) does.
//
// Bound: memory.  One call must read q, the valid K/V rows of every
// sequence (plus their scales on an int8 pool), the tables and lengths,
// and write the output; it does about 4 * hd flops per K/V row of
// 2 * hd * elt bytes, far below the ~295 flop/byte ridge of the H100.
// Least time = those bytes / 3.35 TB/s.
//
// Design.  One thread block per (kv head, sequence) covers all G query
// heads of its group, so each page row is read from device memory once
// per kv head (the Pallas grid (B, H, n_blk) reads it G times).  The block
// walks its row's block table itself and stops at the row's length.  Each
// page's rows for this kv head are staged in shared memory as float
// (16-byte loads, so head_dim * element size must be a multiple of 16 and
// the pools 16-byte aligned; dequantized there for int8), scores come
// from warp-wide dot products (lanes split head_dim), and a float32
// online softmax (running max m, denominator l, accumulator acc, all in
// shared memory) carries across pages.  head_dim up to 256 and any page
// size fit; shared memory is 4 * (2*G*hd + 2*bs*hd + G*bs + 3*G) bytes.
// Simple and right first: no split of long rows across blocks, no
// cp.async/TMA staging and no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 128;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of a page row -> 16 / sizeof(T) floats, one vector load
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* o) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ k_pages,
    const TP* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lengths, TQ* __restrict__ out, int H, int K,
    int hd, int bs, int n_blk, float scale, float softcap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // (G, hd)   queries of the group
  float* k_s = q_s + G * hd;     // (bs, hd)  this page's K rows
  float* v_s = k_s + bs * hd;    // (bs, hd)  this page's V rows
  float* acc_s = v_s + bs * hd;  // (G, hd)   unnormalised output
  float* p_s = acc_s + G * hd;   // (G, bs)   scores, then probabilities
  float* m_s = p_s + G * bs;     // (G,)      running max
  float* l_s = m_s + G;          // (G,)      running denominator
  float* a_s = l_s + G;          // (G,)      this page's rescale factor

  const int h0 = kh * G;
  const TQ* q_row = q + (static_cast<size_t>(b) * H + h0) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    q_s[i] = to_float(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  int n_used = len <= 0 ? 0 : (len + bs - 1) / bs;
  if (n_used > n_blk) n_used = n_blk;
  const int32_t* table = block_tables + static_cast<size_t>(b) * n_blk;
  const bool quant = k_scale != nullptr;
  __syncthreads();

  for (int j = 0; j < n_used; ++j) {
    const int page = table[j];  // the same for every thread of the block
    if (page < 0) continue;     // unallocated: skipped, never read
    const int t_valid = min(bs, len - j * bs);  // >= 1 since j < n_used

    // stage this kv head's rows of the page, coalesced along head_dim in
    // 16-byte vector loads (the wrapper admits only rows that are whole,
    // aligned vectors)
    constexpr int N = Vec16<TP>::N;
    for (int i = tid; i < t_valid * (hd / N); i += blockDim.x) {
      const int e = i * N;  // element index within the staged rows
      const int t = e / hd;
      const size_t row = (static_cast<size_t>(page) * bs + t) * K + kh;
      float kf[N], vf[N];
      load16(k_pages + row * hd + (e - t * hd), kf);
      load16(v_pages + row * hd + (e - t * hd), vf);
      const float ks = quant ? k_scale[row] : 1.f;
      const float vs = quant ? v_scale[row] : 1.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        k_s[e + n] = kf[n] * ks;
        v_s[e + n] = vf[n] * vs;
      }
    }
    __syncthreads();

    // scores: one warp per token, lanes split head_dim
    for (int t = warp; t < t_valid; t += n_warps) {
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32)
          part += q_s[g * hd + d] * k_s[t * hd + d];
        part = warp_sum(part);
        if (lane == 0) {
          float s = part * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          p_s[g * bs + t] = s;
        }
      }
    }
    __syncthreads();

    // online-softmax statistics: one warp per query head
    for (int g = warp; g < G; g += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < t_valid; t += 32) mx = fmaxf(mx, p_s[g * bs + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < t_valid; t += 32) {
        const float p = expf(p_s[g * bs + t] - m_new);
        p_s[g * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v   (each thread owns fixed (g, d) entries)
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* p = p_s + g * bs;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < t_valid; ++t) a += p[t] * v_s[t * hd + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  TQ* o_row = out + (static_cast<size_t>(b) * H + h0) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    store(o_row + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* lengths, void* out,
                   int B, int H, int K, int hd, int bs, int n_blk,
                   float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(G) * hd +
                       2 * static_cast<size_t>(bs) * hd +
                       static_cast<size_t>(G) * bs + 3 * static_cast<size_t>(G));
  // rows start at multiples of hd elements: the 16-byte loads need hd to
  // be a whole number of vectors and the pool bases 16-byte aligned
  if (hd % Vec16<TP>::N != 0 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<TQ, TP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<TQ*>(out), H, K, hd,
      bs, n_blk, scale, softcap);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_pages(int page_dtype, const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* block_tables,
                         const void* lengths, void* out, int B, int H, int K,
                         int hd, int bs, int n_blk, float scale,
                         float softcap, cudaStream_t stream) {
  switch (page_dtype) {
    case kF32:
      return launch<TQ, float>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, K, hd, bs,
                               n_blk, scale, softcap, stream);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                       block_tables, lengths, out, B, H, K,
                                       hd, bs, n_blk, scale, softcap, stream);
    case kI8:
      return launch<TQ, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                block_tables, lengths, out, B, H, K, hd, bs,
                                n_blk, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer
// (k_scale / v_scale are null for a float pool); dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (pages only).  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int B, int H, int K, int hd, int bs,
    int n_blk, float scale, float softcap, int q_dtype, int page_dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return static_cast<int>(launch_pages<float>(
          page_dtype, q, k_pages, v_pages, k_scale, v_scale, block_tables,
          lengths, out, B, H, K, hd, bs, n_blk, scale, softcap, s));
    case kBF16:
      return static_cast<int>(launch_pages<__nv_bfloat16>(
          page_dtype, q, k_pages, v_pages, k_scale, v_scale, block_tables,
          lengths, out, B, H, K, hd, bs, n_blk, scale, softcap, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
