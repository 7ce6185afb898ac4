// W8A16 weight-quantized matmul for Hopper, sm_90a.
//
// Replaces the TPU kernel `quant_matmul` in
// src/repro/kernels/quant_matmul.py (body `_kernel`, launched by the
// pl.pallas_call in `quant_matmul`).  The plain PyTorch version is
// repro_torch/kernels/ref.py::quant_matmul_ref; the wrapper that checks
// arguments and launches this file is repro_torch/kernels/quant_matmul.py.
//
// What it computes, as the TPU kernel does:
//   out[m, n] = cast_out( scale[n] * sum_k bf16(x[m, k]) * bf16(wq[k, n]) )
// x (M, K) float32 or bfloat16 is rounded to bfloat16; wq (K, N) int8
// becomes bfloat16 exactly (|q| <= 127); products of two bfloat16 values
// are exact in float32 and accumulate in float32; the per-output-channel
// float32 scale multiplies the sum; the result is cast to the output type
// (float32 or bfloat16).  The Pallas grid (M/bm, N/bn, K/bk) carries its
// accumulator across the sequential K axis and needs blocks that divide
// M, N and K; here a loop over K inside each thread block takes the place
// of that axis, and ragged edges in M, N and K are masked, so any shape
// works.
//
// Bound.  The larger of two times: the bytes the call must move (x, the
// int8 weight and the scales read once, the output written once) over
// 3.35 TB/s, and 2 * M * N * K operations over 989 TFLOP/s (bfloat16
// tensor cores).  A draft model's decode step (M = 4 rows) is bound by
// the weight bytes: 91.75 MB of w_gate (5120 x 17920) is 0.027 ms.  Its
// admission prefill (M up to 2048) is bound by the operations: M = 512
// against w_gate is 0.095 ms.
//
// Design: two kernels, picked by M.
//  * M <= 8 (decode): `gemv_kernel`.  A block covers 64 output columns
//    with 256 threads: 4 column lanes x 64 k lanes.  A thread loads 16
//    int8 weights of one k row along N in one 16-byte load (a warp reads
//    8 rows x 64 contiguous bytes, whole 32-byte sectors), converts them
//    once and multiplies them into all M rows of x held in registers
//    (MT = 1, 2, 4 or 8 rows, a template parameter), so each weight byte
//    is read from device memory once per call.  The 64 k lanes are summed
//    by warp shuffles and then across the 8 warps in shared memory, in a
//    fixed order.  N / 64 blocks: 80 for a 5120-wide output, 280 for
//    17920, 20 for 1280.
//  * M > 8 (prefill): `mma_kernel`.  64 x 64 output tiles, 4 warps of
//    32 x 32, K in steps of 32: each step stages the x tile (rounded to
//    bfloat16) and the int8 weight tile (converted to bfloat16, stored
//    n-major so a B fragment is two 32-bit shared-memory loads) in shared
//    memory with padded rows, then runs mma.sync m16n8k16 bf16 with
//    float32 accumulators.
// Simple and right first: no cp.async/TMA pipeline, no wgmma and no
// split of K across blocks yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x as the TPU kernel feeds it to the matrix unit: rounded to bfloat16
template <typename TX>
__device__ __forceinline__ __nv_bfloat16 x_bf16(TX v) {
  return __float2bfloat16(to_float(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 int8 weights of one row starting at column n (row base `row`), as
// floats; columns >= N read as 0 and are never dereferenced.  One 16-byte
// load when all 16 are in range and the address is aligned.
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ row,
                                         int n, int N, float* w) {
  const int8_t* p = row + n;
  if (n + 16 <= N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = static_cast<float>(b[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j] = n + j < N ? static_cast<float>(p[j]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// M <= 8: one pass over the weight, all rows of x at once
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvCols = 64;                       // output columns a block
constexpr int kColLanes = kGemvCols / 16;           // 16 columns a thread
constexpr int kKLanes = kGemvThreads / kColLanes;   // k rows in flight
constexpr int kGemvWarps = kGemvThreads / 32;

template <typename TX, typename TO, int MT>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, TO* __restrict__ out, int M, int K,
    int N) {
  __shared__ float red[kGemvWarps][MT][kGemvCols];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % kColLanes;   // lane & 3: the 16-column group
  const int ty = tid / kColLanes;   // the k lane
  const int nb = blockIdx.x * kGemvCols;
  const int n0 = nb + tx * 16;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
#pragma unroll 4
    for (int k = ty; k < K; k += kKLanes) {
      float w[16];
      load_w16(wq + static_cast<size_t>(k) * N, n0, N, w);
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[m] = m < M ? __bfloat162float(
                            x_bf16(x[static_cast<size_t>(m) * K + k]))
                      : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
    }
  }

  // sum the 8 k lanes of a warp that share a column group (lane bits
  // 2-4), then the 8 warps in shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < kColLanes) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][m][tx * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < MT * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols;
    const int c = i % kGemvCols;
    const int n = nb + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][m][c];
    store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
  }
}

// ---------------------------------------------------------------------------
// M > 8: tiled bf16 tensor-core product
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kPad = kBK + 8;   // row stride (bf16): conflict-free fragments
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(kMmaThreads) mma_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, TO* __restrict__ out, int M, int K,
    int N) {
  // x tile [m][k] and weight tile stored n-major [n][k], both bf16
  __shared__ __align__(16) __nv_bfloat16 a_s[kBM][kPad];
  __shared__ __align__(16) __nv_bfloat16 b_s[kBN][kPad];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment row group
  const int t = lane & 3;           // thread in group
  const int wm = (warp >> 1) * 32;  // warp tile origin in the block tile
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // staging roles: x tile row ar, k half ah; weight tile row br, columns bc
  const int ar = tid >> 1, ah = (tid & 1) * 16;
  const int br = tid >> 2, bc = (tid & 3) * 16;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int m = m0 + ar;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + ah + i;
        a_s[ar][ah + i] = (m < M && k < K)
                              ? x_bf16(x[static_cast<size_t>(m) * K + k])
                              : __float2bfloat16(0.f);
      }
    }
    {
      const int k = k0 + br;
      float w[16];
      if (k < K) {
        load_w16(wq + static_cast<size_t>(k) * N, n0 + bc, N, w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) b_s[bc + j][br] = __float2bfloat16(w[j]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = ld32(&a_s[r][ks + 2 * t]);
        a[i][1] = ld32(&a_s[r + 8][ks + 2 * t]);
        a[i][2] = ld32(&a_s[r][ks + 2 * t + 8]);
        a[i][3] = ld32(&a_s[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = ld32(&b_s[c][ks + 2 * t]);
        b[j][1] = ld32(&b_s[c][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                   b[j][1]);
    }
    __syncthreads();
  }

  // accumulator r of tile (i, j): row g (+8 for r >= 2), column 2t + r % 2
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (m < M && n < N)
          store(out + static_cast<size_t>(m) * N + n, acc[i][j][r] * scale[n]);
      }
}

template <typename TX, typename TO, int MT>
cudaError_t launch_gemv(const void* x, const void* wq, const void* scale,
                        void* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kGemvCols - 1) / kGemvCols);
  gemv_kernel<TX, TO, MT><<<grid, kGemvThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 1) return launch_gemv<TX, TO, 1>(x, wq, scale, out, M, K, N, stream);
  if (M <= 2) return launch_gemv<TX, TO, 2>(x, wq, scale, out, M, K, N, stream);
  if (M <= 4) return launch_gemv<TX, TO, 4>(x, wq, scale, out, M, K, N, stream);
  if (M <= 8) return launch_gemv<TX, TO, 8>(x, wq, scale, out, M, K, N, stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mma_kernel<TX, TO><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* wq,
                         const void* scale, void* out, int M, int K, int N,
                         cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<TX, float>(x, wq, scale, out, M, K, N, stream);
  if (out_dtype == kBF16)
    return launch<TX, __nv_bfloat16>(x, wq, scale, out, M, K, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer to
// a contiguous row-major tensor: x (M, K), wq (K, N) int8, scale (N,)
// float32, out (M, N).  dtype codes: 0 float32, 1 bfloat16.  M, K, N >= 1.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int repro_quant_matmul(const void* x, const void* wq,
                                  const void* scale, void* out, int M, int K,
                                  int N, int x_dtype, int out_dtype,
                                  void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kF32)
    e = dispatch_out<float>(out_dtype, x, wq, scale, out, M, K, N, s);
  else if (x_dtype == kBF16)
    e = dispatch_out<__nv_bfloat16>(out_dtype, x, wq, scale, out, M, K, N, s);
  return static_cast<int>(e);
}
