// Device helpers shared by the paged-attention kernels of this directory
// (paged_attention.cu, paged_extend_attention.cu): element conversion,
// 16-byte page-row loads, warp reductions, the staging of one page's
// rows for one kv head, and the host-side dispatch over the dtypes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace paged {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
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

// Stage rows [0, t_valid) of physical page `page` for kv head `kh` into
// k_s / v_s (row stride hd), as float, in 16-byte vector loads coalesced
// along head_dim, multiplied by the row's scale on an int8 pool (k_scale
// non-null).  The wrappers admit only rows that are whole, aligned
// vectors.  Every thread of the block takes part.
template <typename TP>
__device__ __forceinline__ void stage_page_rows(
    const TP* __restrict__ k_pages, const TP* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int page, int t_valid, int bs, int K, int kh, int hd, float* k_s,
    float* v_s) {
  constexpr int N = Vec16<TP>::N;
  for (int i = threadIdx.x; i < t_valid * (hd / N); i += blockDim.x) {
    const int e = i * N;  // element index within the staged rows
    const int t = e / hd;
    const size_t row = (static_cast<size_t>(page) * bs + t) * K + kh;
    float kf[N], vf[N];
    load16(k_pages + row * hd + (e - t * hd), kf);
    load16(v_pages + row * hd + (e - t * hd), vf);
    const float ks = k_scale != nullptr ? k_scale[row] : 1.f;
    const float vs = v_scale != nullptr ? v_scale[row] : 1.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      k_s[e + n] = kf[n] * ks;
      v_s[e + n] = vf[n] * vs;
    }
  }
}

constexpr int kMaxChunks = 256 / 32;  // head_dim <= 256 over 32 lanes

// keys a query row sees among t_valid staged keys: all of them in a
// context page, those at or before its own token in the suffix
__device__ __forceinline__ int visible(int r, int G, int t_valid,
                                       bool causal) {
  return causal ? min(t_valid, r / G + 1) : t_valid;
}

// One online-softmax step of the R query rows in q_s (row stride hd) over
// the t_valid keys staged in k_s / v_s (row stride hd): scores into p_s
// (row stride T), running max m_s, denominator l_s and accumulator acc_s
// updated, a_s left holding the step's rescale factors.  Query row r
// belongs to group member r % G; with `causal` it sees only the keys
// t <= r / G.  Ends with the block synchronised.
__device__ __forceinline__ void attend_staged(
    const float* q_s, const float* k_s, const float* v_s, float* acc_s,
    float* p_s, float* m_s, float* l_s, float* a_s, int R, int G, int T,
    int hd, int t_valid, bool causal, float scale, float softcap) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // scores: one warp per key; the lane's slice of the key stays in
  // registers across the query rows
  for (int t = warp; t < t_valid; t += n_warps) {
    float kr[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      kr[c] = d < hd ? k_s[t * hd + d] : 0.f;
    }
    for (int r = 0; r < R; ++r) {
      if (t >= visible(r, G, t_valid, causal)) continue;  // warp-uniform
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) part += q_s[r * hd + d] * kr[c];
      }
      part = warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        p_s[r * T + t] = s;
      }
    }
  }
  __syncthreads();

  // statistics: one warp per query row
  for (int r = warp; r < R; r += n_warps) {
    const int nv = visible(r, G, t_valid, causal);
    float* p = p_s + r * T;
    float mx = kNegInf;
    for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, p[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float e = expf(p[t] - m_new);
      p[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      a_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p @ v   (each thread owns fixed (r, d) entries)
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int nv = visible(r, G, t_valid, causal);
    const float* p = p_s + r * T;
    float a = acc_s[i] * a_s[r];
    for (int t = 0; t < nv; ++t) a += p[t] * v_s[t * hd + d];
    acc_s[i] = a;
  }
  __syncthreads();
}

// Host side: call f(TQ{}, TP{}) for the query/output type code `q_dtype`
// (float32 or bfloat16) and the page type code `page_dtype` (float32,
// bfloat16 or int8); cudaErrorInvalidValue for any other code.
template <typename TQ, typename F>
cudaError_t dispatch_pages(int page_dtype, F&& f) {
  switch (page_dtype) {
    case kF32:
      return f(TQ{}, float{});
    case kBF16:
      return f(TQ{}, __nv_bfloat16{});
    case kI8:
      return f(TQ{}, int8_t{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int q_dtype, int page_dtype, F&& f) {
  switch (q_dtype) {
    case kF32:
      return dispatch_pages<float>(page_dtype, f);
    case kBF16:
      return dispatch_pages<__nv_bfloat16>(page_dtype, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paged
