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
//  * M <= 8 (decode): `gemv_kernel`, bound by the weight bytes.  The
//    first version ran one block per 64 output columns over all of K
//    (20 blocks for N = 1280 on 132 SMs), re-read x from device memory
//    for every k and converted each weight with the int8 -> float
//    instruction.  Now a block of 256 threads covers 64 or 256 output
//    columns x one slice of K; the wrapper's plan
//    (repro_torch/kernels/quant_matmul.py::gemv_plan) picks 256 columns
//    for wide outputs (each warp reads two rows x 256 contiguous bytes,
//    a whole row segment of the DRAM page) and 64 for narrow ones (so K
//    is not cut into slices too thin to pay for their partial sums), and
//    cuts K so that every shape launches at least two blocks an SM and
//    the last round of resident blocks is not left mostly empty.  A
//    thread owns 16 columns (one 16-byte load of a k row) and issues 4
//    independent loads, rows one k-lane stride apart, before it uses
//    any; x comes through L1, rounded to bfloat16 (a slice's x is a few
//    KB that stay in L1 after the first touch; staging it in shared
//    memory behind a block barrier took 5-14% longer at the four phi3
//    decode shapes on an H100 80GB HBM3 at 700 W, PERF.md).  Each weight byte
//    becomes a float by a byte permute into the mantissa of 2^23 and one
//    subtract (exact for |q| <= 128, off the quarter-rate conversion
//    pipe) and is multiplied into all M rows of x (MT = 1, 2, 4 or 8
//    rows, a template parameter), so each weight byte is read from device
//    memory once per call.  The k lanes are summed by warp shuffles and
//    then across the 8 warps in shared memory, in a fixed order.  A
//    split K writes float32 partials to a workspace; the last block of
//    each column block (a counter the kernel resets) sums them in slice
//    order: two calls give bitwise-equal outputs, and no float atomics
//    are used.
//  * M > 8 (prefill): `mma_kernel`.  64 x 64 output tiles, 4 warps of
//    32 x 32, K in steps of 32: each step stages the x tile (rounded to
//    bfloat16) and the int8 weight tile (converted to bfloat16, stored
//    n-major so a B fragment is two 32-bit shared-memory loads) in shared
//    memory with padded rows, then runs mma.sync m16n8k16 bf16 with
//    float32 accumulators.  Simple and right first: no cp.async/TMA
//    pipeline and no wgmma yet.

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
// M <= 8: one pass over the weight, all rows of x at once, K split
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kLoads = 4;                   // weight loads in flight a thread

// 16 int8 weights of one row starting at column n (row base `row`) as an
// int4, bytes of columns >= N zero; for rows that are not 16-byte aligned
// or run past N
__device__ __forceinline__ int4 load_w16_ragged(const int8_t* __restrict__ row,
                                                int n, int N) {
  int4 v;
  int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = n + j < N ? row[n + j] : 0;
  return v;
}

// The 4 signed bytes of `word` as floats, exactly, without the
// conversion pipe: biased to unsigned (xor 0x80), each byte permuted into
// the mantissa of 2^23, then 2^23 + 128 subtracted.
__device__ __forceinline__ void bytes_to_float(uint32_t word, float* f) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
           8388736.0f;
}

// Shared memory of a block: each warp's column sums (MT x COLS floats).
constexpr size_t gemv_smem(int MT, int COLS) {
  return sizeof(float) * kGemvWarps * MT * COLS;
}

// Block (column block blockIdx.x of COLS columns, K slice blockIdx.y of
// k_chunk rows), 256 threads = COLS / 16 column lanes x KL k lanes.  A
// thread owns 16 columns and rows ty, ty + KL, ... of the slice: it
// issues kLoads independent 16-byte loads (rows KL apart, streamed past
// L1) before it uses any, takes the rows' M values of x through L1,
// rounded to bfloat16, and multiplies.  The k lanes of a warp that share
// columns are summed by shuffles, then the 8 warps in shared memory, in
// a fixed order.  With one slice the block writes out; otherwise it
// writes its float32 partial to ws[slice][m][n], and the last block of
// the column (a per-column counter) sums the partials in slice order,
// writes out and resets the counter: two calls give bitwise-equal
// results.
template <typename TX, typename TO, int MT, int COLS>
__global__ void __launch_bounds__(kGemvThreads, MT <= 4 ? 2 : 1)
    gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, TO* __restrict__ out,
                float* __restrict__ ws, unsigned* __restrict__ counters,
                int M, int K, int N, int k_chunk) {
  constexpr int CL = COLS / 16;             // column lanes
  constexpr int KL = kGemvThreads / CL;     // k lanes
  extern __shared__ float red[];            // [warp][m][column]
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % CL;
  const int ty = tid / CL;
  const int nb = blockIdx.x * COLS;
  const int n0 = nb + tx * 16;
  const int splits = gridDim.y;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  // every row's 16 bytes at n0 are in range and 16-byte aligned
  const bool vec = n0 + 16 <= N && N % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(wq + n0) & 15) == 0;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
    for (int k0 = k_begin + ty; k0 < k_end; k0 += KL * kLoads) {
      int4 w[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = k0 + KL * i;
        const int8_t* row = wq + static_cast<size_t>(k) * N;
        if (k >= k_end)
          w[i] = make_int4(0, 0, 0, 0);
        else if (vec)
          w[i] = __ldcs(reinterpret_cast<const int4*>(row + n0));
        else
          w[i] = load_w16_ragged(row, n0, N);
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = k0 + KL * i;
        if (k >= k_end) break;
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[m] = m < M ? __bfloat162float(
                              x_bf16(x[static_cast<size_t>(m) * K + k]))
                        : 0.f;
        const uint32_t words[4] = {static_cast<uint32_t>(w[i].x),
                                   static_cast<uint32_t>(w[i].y),
                                   static_cast<uint32_t>(w[i].z),
                                   static_cast<uint32_t>(w[i].w)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[4];
          bytes_to_float(words[q], f);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[m][4 * q + j] = fmaf(xv[m], f[j], acc[m][4 * q + j]);
        }
      }
    }
  }

  // the k lanes of a warp that share a column group (lane bits from CL
  // up), then the 8 warps in shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = CL; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[m][j] = v;
    }
  if (lane < CL) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        red[(warp * MT + m) * COLS + tx * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < MT * COLS; i += kGemvThreads) {
    const int m = i / COLS;
    const int c = i % COLS;
    const int n = nb + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[(w * MT + m) * COLS + c];
    if (splits == 1)
      store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
    else
      ws[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = s;
  }
  if (splits == 1) return;

  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1u) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < MT * COLS; i += kGemvThreads) {
    const int m = i / COLS;
    const int n = nb + i % COLS;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int p = 0; p < splits; ++p)
      s += __ldcg(ws + (static_cast<size_t>(p) * M + m) * N + n);
    store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next call
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

template <typename TX, typename TO, int MT, int COLS>
cudaError_t launch_gemv(const void* x, const void* wq, const void* scale,
                        void* out, void* ws, void* counters, int M, int K,
                        int N, int splits, int k_chunk, cudaStream_t stream) {
  constexpr size_t smem = gemv_smem(MT, COLS);
  if (smem > 48 * 1024) {   // above the default: allowed on every launch,
                            // so on whichever device is current
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<TX, TO, MT, COLS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + COLS - 1) / COLS, splits);
  gemv_kernel<TX, TO, MT, COLS><<<grid, kGemvThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), M, K, N,
      k_chunk);
  return cudaGetLastError();
}

template <typename TX, typename TO, int MT>
cudaError_t launch_rows(const void* x, const void* wq, const void* scale,
                        void* out, void* ws, void* counters, int M, int K,
                        int N, int cols, int splits, int k_chunk,
                        cudaStream_t stream) {
  if (cols == 256)
    return launch_gemv<TX, TO, MT, 256>(x, wq, scale, out, ws, counters, M,
                                        K, N, splits, k_chunk, stream);
  return launch_gemv<TX, TO, MT, 64>(x, wq, scale, out, ws, counters, M, K,
                                     N, splits, k_chunk, stream);
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, void* ws, void* counters, int M, int K, int N,
                   int cols, int splits, int k_chunk, cudaStream_t stream) {
  if (M <= 1)
    return launch_rows<TX, TO, 1>(x, wq, scale, out, ws, counters, M, K, N,
                                  cols, splits, k_chunk, stream);
  if (M <= 2)
    return launch_rows<TX, TO, 2>(x, wq, scale, out, ws, counters, M, K, N,
                                  cols, splits, k_chunk, stream);
  if (M <= 4)
    return launch_rows<TX, TO, 4>(x, wq, scale, out, ws, counters, M, K, N,
                                  cols, splits, k_chunk, stream);
  if (M <= 8)
    return launch_rows<TX, TO, 8>(x, wq, scale, out, ws, counters, M, K, N,
                                  cols, splits, k_chunk, stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mma_kernel<TX, TO><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* wq,
                         const void* scale, void* out, void* ws,
                         void* counters, int M, int K, int N, int cols,
                         int splits, int k_chunk, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<TX, float>(x, wq, scale, out, ws, counters, M, K, N, cols,
                             splits, k_chunk, stream);
  if (out_dtype == kBF16)
    return launch<TX, __nv_bfloat16>(x, wq, scale, out, ws, counters, M, K,
                                     N, cols, splits, k_chunk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer to
// a contiguous row-major tensor: x (M, K), wq (K, N) int8, scale (N,)
// float32, out (M, N).  dtype codes: 0 float32, 1 bfloat16.  M, K, N >= 1.
// For M <= 8 a block covers `cols` (64 or 256) output columns and the K
// axis is cut into `splits` slices of `k_chunk` rows (the last may be
// shorter: (splits - 1) k_chunk < K <= splits k_chunk); with splits > 1,
// ws holds splits x M x N float32 partials and counters ceil(N / cols)
// unsigned ints that are 0 on entry and are left 0 (calls that may run at
// once, on two streams, need counters of their own).  M > 8 ignores cols,
// splits, k_chunk, ws and counters.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_quant_matmul(const void* x, const void* wq,
                                  const void* scale, void* out, void* ws,
                                  void* counters, int M, int K, int N,
                                  int cols, int splits, int k_chunk,
                                  int x_dtype, int out_dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8 &&
      ((cols != 64 && cols != 256) || splits < 1 || splits > 65535 ||
       k_chunk < 1 || static_cast<long long>(splits - 1) * k_chunk >= K ||
       static_cast<long long>(splits) * k_chunk < K ||
       (splits > 1 && (ws == nullptr || counters == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kF32)
    e = dispatch_out<float>(out_dtype, x, wq, scale, out, ws, counters, M, K,
                            N, cols, splits, k_chunk, s);
  else if (x_dtype == kBF16)
    e = dispatch_out<__nv_bfloat16>(out_dtype, x, wq, scale, out, ws,
                                    counters, M, K, N, cols, splits, k_chunk,
                                    s);
  return static_cast<int>(e);
}
