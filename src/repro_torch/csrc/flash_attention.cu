// Blocked causal GQA attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`, launched by the
// pl.pallas_call in `flash_attention`).  The plain PyTorch version is
// repro_torch/kernels/ref.py::flash_attention_ref (the masked full
// softmax); the wrapper that checks arguments and launches this file is
// repro_torch/kernels/flash_attention.py.
//
// What it computes, as the TPU kernel does, in float32: q (B, S, H, hd),
// k and v (B, T, K, hd), H = G * K (query head h reads kv head h / G),
// positions counting from 0 on both axes.  For query position i and key
// position j, s = scale * (q_i . k_j), then softcap * tanh(s / softcap)
// when softcap > 0, then the mask j <= i (and j > i - window when
// window > 0); an online softmax over the visible keys in float32 with
// the running (max m, sum l, accumulator acc) of the TPU kernel
// (-1e30 for masked scores, masked probabilities 0), and the output
// acc / max(l, 1e-30) in q's type (float32 or bfloat16).  A query row
// with no visible key (only possible when T < S) is 0, as in the TPU
// kernel.  Float32 inputs are computed in float32 (no TF32); bfloat16
// inputs are widened to float32 as they are staged, so every product
// and sum is a float32 one, as on the TPU.
//
// Bound.  The larger of two times: the bytes the call must move (q, k,
// v read once, the output written once) over 3.35 TB/s, and the
// operations it does over the peak rate of the inputs' type (989
// TFLOP/s for bfloat16 on the tensor cores, 67 TFLOP/s for float32).
// Only the visible (causal) pairs need work: S (S + 1) / 2 of them per
// (b, head) for window 0 and S W - W (W - 1) / 2 for window W (S = T),
// each 2 hd operations for q.k and 2 hd for p.v.  At the training
// evaluation's shape (B = 2, S = T = 4096, H = 4, K = 1, hd = 256,
// bfloat16) a global layer is 6.87e10 operations (0.069 ms) and a
// window-512 layer 1.61e10 (0.016 ms), against 42 MB of q/k/v/o bytes
// (0.0125 ms): the call is bound by operations.
//
// Design.  One block of 256 threads per (query tile of 64 rows, query
// head, batch row); tiles with the most keys start first.  The TPU's
// sequential kv grid axis becomes a loop over 64-row key tiles inside
// the block, restricted to the band [max(0, q_lo - window + 1), q_hi]:
// tiles outside the causal / window band are never visited, so a
// windowed layer costs O(S W) structurally, not by masking.  The query
// tile and each key and value tile are staged in shared memory as
// float32 with 16-byte global loads (rows padded by 4 floats so the
// 128-bit reads of 8 different rows hit different banks); ragged S and
// T tails read as zero rows and are masked by position, so no shape has
// to divide the tile.  The 16 x 16 thread grid gives each thread 4 query
// rows: for q.k 4 x 4 scores (columns tx + 16 c), for p.v 4 rows x hd/16
// accumulator columns held in registers (64 floats at hd = 256: the
// 64 x 256 float32 accumulator of a tile is spread over the block, so
// nothing spills).  Row maxima and sums are reduced across the 16
// threads of a row group with warp shuffles; the probability tile goes
// through shared memory to the p.v product.  Head dims up to 64, 128
// and 256 are separate instantiations (columns past hd stage as zeros).
// Simple and right first: every product runs on the CUDA cores in
// float32, far from the bf16 tensor-core bound; wgmma / mma.sync for
// q.k and p.v, TMA / cp.async double buffering and one kv tile feeding
// all G query heads of a group are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;      // a 16 x 16 thread grid over each tile
constexpr int kTile = 64;          // query rows and key rows of a tile
constexpr int kPad = 4;            // floats added to each staged row
constexpr int kPS = kTile + 4;     // row stride of the probability tile
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors of the input type, widened to float32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows [0, kTile) of a slice whose row r starts at src + r * ld
// (elements) into dst (row stride ds floats) as float32: rows at or past
// `rows` and columns at or past hd read as zeros.  hd is a whole number
// of 16-byte vectors and src is 16-byte aligned (the wrapper checks).
template <typename T, int HDP>
__device__ __forceinline__ void stage(float* dst, int ds, const T* src,
                                      long long ld, int rows, int hd) {
  constexpr int V = Vec<T>::n;
  constexpr int per_row = HDP / V;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * V;
    float f[V];
    if (r < rows && c < hd) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + r * ld + c));
      Vec<T>::widen(u, f);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + r * ds + c + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int T_len, int H, int K, int hd,
                           float scale, float softcap, int window) {
  constexpr int DS = HDP + kPad;  // row stride of the staged tiles
  constexpr int NC = HDP / 64;    // float4 accumulator groups per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // kTile x DS
  float* Ks = Qs + kTile * DS;     // kTile x DS
  float* Vs = Ks + kTile * DS;     // kTile x DS
  float* Ps = Vs + kTile * DS;     // kTile x kPS probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n_qt = (S + kTile - 1) / kTile;
  const int q_lo = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const long long q_ld = static_cast<long long>(H) * hd;
  const long long kv_ld = static_cast<long long>(K) * hd;
  const T* qb = q + (static_cast<long long>(b) * S + q_lo) * q_ld +
                static_cast<long long>(h) * hd;
  const T* kb = k + static_cast<long long>(b) * T_len * kv_ld +
                static_cast<long long>(kh) * hd;
  const T* vb = v + static_cast<long long>(b) * T_len * kv_ld +
                static_cast<long long>(kh) * hd;

  stage<T, HDP>(Qs, DS, qb, q_ld, S - q_lo, hd);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // the band of keys any row of this tile can see
  const int q_hi = min(q_lo + kTile, S) - 1;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_last = min(q_hi, T_len - 1);
  const int t_first = k_first / kTile;
  const int t_last = k_last >= k_first ? k_last / kTile : t_first - 1;

  for (int kt = t_first; kt <= t_last; ++kt) {
    const int k_lo = kt * kTile;
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    stage<T, HDP>(Ks, DS, kb + k_lo * kv_ld, kv_ld, T_len - k_lo, hd);
    stage<T, HDP>(Vs, DS, vb + k_lo * kv_ld, kv_ld, T_len - k_lo, hd);
    __syncthreads();

    // scores of rows ty * 4 + i against keys tx + 16 * j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty * 4 + i;
      unsigned visible = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos <= qpos && kpos < T_len &&
                        (window <= 0 || kpos > qpos - window);
        visible |= static_cast<unsigned>(ok) << j;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (visible >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

    // acc[i][4 g + e] is column tx * 4 + 64 g + e of row ty * 4 + i
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPS + j];
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * DS + tx * 4 + 64 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<long long>(b) * S + qpos) * q_ld +
              static_cast<long long>(h) * hd;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * g + e;
        if (col < hd) store(orow + col, acc[i][4 * g + e] / denom);
      }
  }
}

// Dynamic shared memory of one block, in bytes, for head dims padded to
// HDP (the wrapper computes the same number in
// repro_torch/kernels/flash_attention.py::shared_bytes).
size_t shared_bytes(int HDP) {
  return sizeof(float) * (3 * static_cast<size_t>(kTile) * (HDP + kPad) +
                          static_cast<size_t>(kTile) * kPS);
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int K, int hd, float scale,
                   float softcap, int window, cudaStream_t stream) {
  const size_t smem = shared_bytes(HDP);
  auto kernel = flash_attention_kernel<T, HDP>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, K, hd,
      scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_len, int H, int K, int hd,
                     float scale, float softcap, int window,
                     cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, S, T_len, H, K, hd, scale, softcap,
                         window, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                          softcap, window, stream);
  return launch<T, 256>(q, k, v, out, B, S, T_len, H, K, hd, scale, softcap,
                        window, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers: q (B, S, H, hd),
// k and v (B, T, K, hd), out (B, S, H, hd), all contiguous, 16-byte
// aligned and of one type (dtype code 0 float32, 1 bfloat16); hd a whole
// number of 16-byte vectors, at most 256; H a multiple of K; window >= 0
// (0: causal only); softcap >= 0 (0: none).  Launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T, int H, int K, int hd, float scale,
                                     float softcap, int window, int dtype,
                                     void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || K < 1 || H % K != 0 || hd < 1 ||
      hd > kMaxHeadDim || window < 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && hd % Vec<float>::n == 0)
    return static_cast<int>(dispatch<float>(q, k, v, out, B, S, T, H, K, hd,
                                            scale, softcap, window, s));
  if (dtype == kBF16 && hd % Vec<__nv_bfloat16>::n == 0)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, out, B, S, T, H, K, hd, scale, softcap, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
