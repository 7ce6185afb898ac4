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
//  * M > 8 (prefill): `pack_x_kernel`, then `wgmma_kernel`, bound by the
//    operations once M passes ~300 rows (below that, by the weight
//    bytes).  Wide tiles fed through an asynchronous ring reach the
//    tensor cores' rate.  The wrapper's shape-only plan
//    (quant_matmul.py::mma_plan) picks an output tile of 256 x 128,
//    128 x 256, 128 x 128 or (M <= 64) 64 x 256 or 64 x 128, and for
//    M <= 64 a split of K.  The pack launch rounds x to bfloat16 into
//    the tiles' swizzled shared-memory image, zero past M and K.  A
//    block of three warpgroups walks its K slice in steps of 64 rows:
//     - warpgroup 0 produces: warp 0 brings each x stage in one bulk
//       copy (cp.async.bulk) through a ring of 5 stages (4 of a 256-row
//       tile); warps 1-3 bring the int8 weight tile, which travels as
//       int8 (half the bytes of a bfloat16 copy), through a ring of 4,
//       by 16-byte cp.async copies (masked scalar loads where weight
//       rows are not 16-byte vectors); every stage completes on an
//       mbarrier.  One bulk copy per 256-byte weight row was slower than
//       the cp.async copies (PERF.md);
//     - warpgroups 1 and 2 consume: they convert the next stage's int8
//       tile to bfloat16 (the byte permute above, then the float's upper
//       half, exact) into the layout wgmma reads for B (N-contiguous,
//       MN-major under the 128-byte swizzle, which keeps the 16-byte
//       stores free of bank conflicts) while the tensor cores run the
//       current stage: each warpgroup issues wgmma.mma_async m64nNk16
//       (bfloat16 in, float32 accumulators in registers) on its rows
//       (one or two blocks of 64; or half the columns of a 64-row tile),
//       A from the swizzled x stage, B from the converted tile.  The
//       producer gives its registers to the consumers (setmaxnreg).
//    The epilogue multiplies by the scale in float32, casts and stores
//    with the ragged edge masked.  A split K writes float32 partials and
//    the last block of each tile (a counter it resets) sums them in split
//    order, as the GEMV does: two calls give bitwise-equal outputs.
//    Timed with one part removed at a time, the loads and the conversion
//    now hide behind the tensor cores; what is left is the wgmma steps
//    and their barrier (PERF.md).

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
// M > 8: warp-specialised wgmma GEMM over an asynchronous ring
// ---------------------------------------------------------------------------

constexpr int kBK = 64;                       // K rows of a stage
// depth of the x ring: 5 stages, 4 of a 256-row tile's 32 KB
__host__ __device__ constexpr int stages_a(int BM) {
  return BM == 256 ? 4 : 5;
}
constexpr int kStagesW = 4;                   // depth of the weight ring
constexpr int kConverted = 2;                 // converted bf16 weight tiles
constexpr int kWarpgroup = 128;
constexpr int kTileThreads = 3 * kWarpgroup;  // producer + two consumers
constexpr int kConsumers = 2 * kWarpgroup;
constexpr int kRowBytes = kBK * 2;            // a bf16 row of a stage: 128 B
constexpr int kAtom = 8 * kRowBytes;          // 8 swizzled rows: 1024 B
constexpr int kWPad = 64;                     // bytes past a weight row
constexpr int kWeightLoaders = 96;            // producer warps 1-3

// Shared memory of one (BM, BN) block, in bytes: the x ring (BM rows of
// 64 bf16 a stage), the int8 weight ring (64 rows of BN bytes, each
// padded by kWPad, a stage), two converted bf16 weight tiles
// (64 x BN), the rings' full and empty barriers, and 1 KB to align the
// swizzled tiles (the wrapper computes the same number in
// repro_torch/kernels/quant_matmul.py::mma_smem).
constexpr size_t mma_smem(int BM, int BN) {
  return 1024 + static_cast<size_t>(stages_a(BM)) * BM * kRowBytes +
         static_cast<size_t>(kStagesW) * kBK * (BN + kWPad) +
         kConverted * static_cast<size_t>(kBK) * BN * 2 +
         2 * 8 * (stages_a(BM) + kStagesW);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive on `bar`, which then also waits for `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 16 bytes global -> shared, the tail past `bytes` (0 or 16) zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// arrive on `bar` once this thread's cp.async copies have landed (counts
// as one of the arrivals the barrier was initialised with)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups, without the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the three producer warps that load the weight with scalar loads
__device__ __forceinline__ void weight_loaders_sync() {
  asm volatile("bar.sync 2, 96;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// D (64 x N float32, registers) += A (64 x 16, K-major) * B (16 x N,
// MN-major: the transpose bit), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 256)
    wgmma_n256(d, da, db);
  else if constexpr (N == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n64(d, da, db);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 4 signed bytes -> 4 bfloat16 (two pairs, low element first), exactly:
// the byte permute of bytes_to_float, then each float's upper half (the
// lower half of an integer |q| <= 128 is zero)
__device__ __forceinline__ void bytes_to_bf16(uint32_t word, uint32_t& p01,
                                              uint32_t& p23) {
  float f[4];
  bytes_to_float(word, f);
  p01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  p23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// Convert a landed int8 stage (64 rows k of BN bytes, rows BN + kWPad
// bytes apart) into bf16 at `bc`, MN-major under the 128-byte swizzle:
// 64-column block nb at nb * 8 KB, rows of 128 B in atoms of 8 k rows
// (1 KB), 16-byte chunk j of row k at j ^ (k % 8).  A phase of 8 lanes
// reads rows k, k + 1 x 4 chunks (the padding puts them in opposite
// halves of the banks) and writes 8 distinct chunk positions: no bank
// conflicts either way.
template <int BN>
__device__ __forceinline__ void convert_stage(const uint8_t* __restrict__ w,
                                              uint8_t* __restrict__ bc,
                                              int ctid) {
  constexpr int kQuads = BN / 64;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int u = ctid + i * kConsumers;
    const int grp = u >> 3, l8 = u & 7;
    const int k = 2 * (grp / kQuads) + (l8 >> 2);
    const int c = 4 * (grp % kQuads) + (l8 & 3);
    const uint4 v =
        *reinterpret_cast<const uint4*>(w + k * (BN + kWPad) + (c << 4));
    uint32_t o[8];
    bytes_to_bf16(v.x, o[0], o[1]);
    bytes_to_bf16(v.y, o[2], o[3]);
    bytes_to_bf16(v.z, o[4], o[5]);
    bytes_to_bf16(v.w, o[6], o[7]);
    uint8_t* row = bc + (c >> 2) * (8 * kAtom) + (k >> 3) * kAtom +
                   (k & 7) * kRowBytes;
    const int j = (c & 3) * 2;
    *reinterpret_cast<uint4*>(row + ((j ^ (k & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((j + 1) ^ (k & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// x rounded to bfloat16 and packed as the wgmma kernel's A stages: tile
// (row block blockIdx.x, K step blockIdx.y) is BM x 64 bf16 at
// xp + (blockIdx.x * gridDim.y + blockIdx.y) * BM * 128 bytes, row m's
// 16-byte chunk c at chunk c ^ (m % 8) (the 128-byte swizzle), rows and
// columns past M and K zero: one bulk copy a stage, whatever x's type,
// alignment and edges.
template <typename TX, int BM>
__global__ void __launch_bounds__(256)
    pack_x_kernel(const TX* __restrict__ x, uint8_t* __restrict__ xp, int M,
                  int K) {
  uint8_t* tile = xp + (static_cast<size_t>(blockIdx.x) * gridDim.y +
                        blockIdx.y) * BM * kRowBytes;
  for (int i = threadIdx.x; i < BM * 8; i += 256) {
    const int m = i >> 3, c = i & 7;
    const int gm = blockIdx.x * BM + m, gk = blockIdx.y * kBK + 8 * c;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = gm < M && gk + e < K
                 ? x_bf16(x[static_cast<size_t>(gm) * K + gk + e])
                 : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(tile + m * kRowBytes + ((c ^ (m & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// One block: output tile (BM x BN) number blockIdx.x (row blocks fastest,
// so the blocks that run together share weight columns through L2) over
// K slice blockIdx.y [k_begin, k_end), k_begin a multiple of 64.  xp is
// x packed by pack_x_kernel: one bulk copy a stage.  The weight: 16-byte
// cp.async copies by the producer's other three warps when its rows are
// whole 16-byte vectors at 16-byte aligned addresses (`vec`), masked
// scalar loads otherwise.
template <typename TO, int BM, int BN>
__global__ void __launch_bounds__(kTileThreads, 1)
    wgmma_kernel(const uint8_t* __restrict__ xp,
                 const int8_t* __restrict__ wq,
                 const float* __restrict__ scale, TO* __restrict__ out,
                 float* __restrict__ ws, unsigned* __restrict__ counters,
                 int M, int K, int N, int k_chunk) {
  // a consumer warpgroup: RB blocks of 64 rows x WN columns
  constexpr int WN = BM == 64 ? BN / 2 : BN;
  constexpr int RB = BM == 256 ? 2 : 1;
  constexpr int kA = BM * kRowBytes;            // bytes of an x stage
  constexpr int kStagesA = stages_a(BM);
  constexpr int kWS = BN + kWPad;               // weight row stride
  constexpr int kW = kBK * kWS;                 // bytes of a weight stage
  constexpr int kB = kBK * BN * 2;              // bytes of a converted tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ bool last;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* a_ring = base;                          // kStagesA x kA
  uint8_t* b_conv = a_ring + kStagesA * kA;        // kConverted x kB
  uint8_t* w_ring = b_conv + kConverted * kB;      // kStagesW x kW
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_ring + kStagesW * kW);
  const uint32_t full_a = smem_u32(bars);          // kStagesA each
  const uint32_t empty_a = full_a + 8 * kStagesA;
  const uint32_t full_w = empty_a + 8 * kStagesA;  // kStagesW each
  const uint32_t empty_w = full_w + 8 * kStagesW;

  const int tid = threadIdx.x;
  const int m_blocks = (M + BM - 1) / BM;
  const int mb = blockIdx.x % m_blocks;
  const int m0 = mb * BM;
  const int n0 = (blockIdx.x / m_blocks) * BN;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  const bool vec = (reinterpret_cast<uintptr_t>(wq) & 15) == 0 &&
                   N % 16 == 0;

  if (tid == 0) {
    for (int s = 0; s < kStagesA; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 1);
    }
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(full_w + 8 * s, vec ? kWeightLoaders : 1);
      mbar_init(empty_w + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWarpgroup) {
    // ---- producer: warp 0 keeps the x ring full, warps 1-3 the weight's
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid >> 5, lane = tid & 31;
    if (warp == 0) {
      if (lane == 0) {
        const uint8_t* src = xp + (static_cast<size_t>(mb) *
                                   ((K + kBK - 1) / kBK) + k_begin / kBK) * kA;
        for (int t = 0; t < steps; ++t) {
          const int s = t % kStagesA;
          mbar_wait(empty_a + 8 * s, ((t / kStagesA) & 1) ^ 1);
          mbar_expect(full_a + 8 * s, kA);
          bulk_copy(smem_u32(a_ring + s * kA), src + static_cast<size_t>(t) * kA,
                    kA, full_a + 8 * s);
        }
      }
      return;
    }
    for (int t = 0; t < steps; ++t) {
      const int s = t % kStagesW;
      const int k0 = k_begin + t * kBK;
      mbar_wait(empty_w + 8 * s, ((t / kStagesW) & 1) ^ 1);
      // 64 rows x BN / 16 chunks of 16 int8, past K or N zero
      for (int i = tid - 32; i < kBK * (BN / 16); i += kWeightLoaders) {
        const int r = i / (BN / 16), c = i % (BN / 16);
        const int gk = k0 + r, gn = n0 + 16 * c;
        const int8_t* src = wq + static_cast<size_t>(gk) * N + gn;
        uint8_t* dst = w_ring + s * kW + r * kWS + 16 * c;
        if (vec) {
          const bool ok = gk < k_end && gn < N;
          cp_async16(smem_u32(dst), ok ? src : wq, ok ? 16 : 0);
        } else {
          __align__(16) int8_t v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e)
            v[e] = gk < k_end && gn + e < N ? src[e] : 0;
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
      if (vec) {
        cp_async_arrive(full_w + 8 * s);
      } else {
        weight_loaders_sync();
        if (tid == 32) mbar_arrive(full_w + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: convert stage t + 1 while the tensor cores run stage t
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ctid = tid - kWarpgroup;
  const int wg = ctid / kWarpgroup;
  float acc[RB][WN / 2];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[r][i] = 0.f;
  // this warpgroup's A rows and B columns
  const uint32_t a_off = BM == 64 ? 0 : wg * 64 * RB * kRowBytes;
  const uint32_t b_off = BM == 64 ? wg * (WN / 64) * 8 * kAtom : 0;

  mbar_wait(full_w, 0);
  convert_stage<BN>(w_ring, b_conv, ctid);
  fence_async_shared();
  mbar_wait(full_a, 0);
  consumers_sync();
  if (ctid == 0) mbar_arrive(empty_w);
  for (int t = 0; t < steps; ++t) {
    const uint32_t a_addr = smem_u32(a_ring + (t % kStagesA) * kA) + a_off;
    const uint32_t b_addr = smem_u32(b_conv + (t % kConverted) * kB) + b_off;
#pragma unroll
    for (int r = 0; r < RB; ++r) fence_acc(acc[r]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < RB; ++r)
        wgmma_step<WN>(acc[r],
                       wgmma_desc(a_addr + r * 64 * kRowBytes + kk * 32, 16,
                                  kAtom),
                       wgmma_desc(b_addr + kk * 2 * kAtom, 8 * kAtom, kAtom));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const int t1 = t + 1;
    if (t1 < steps) {
      mbar_wait(full_w + 8 * (t1 % kStagesW), (t1 / kStagesW) & 1);
      convert_stage<BN>(w_ring + (t1 % kStagesW) * kW,
                        b_conv + (t1 % kConverted) * kB, ctid);
      fence_async_shared();
      mbar_wait(full_a + 8 * (t1 % kStagesA), (t1 / kStagesA) & 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < RB; ++r) fence_acc(acc[r]);
    // every wgmma of step t is done (its x stage and converted tile are
    // free), weight stage t + 1 is converted and x stage t + 1 landed
    consumers_sync();
    if (ctid == 0) {
      mbar_arrive(empty_a + 8 * (t % kStagesA));
      if (t1 < steps) mbar_arrive(empty_w + 8 * (t1 % kStagesW));
    }
  }

  // ---- epilogue: accumulator j of row block r of this thread is row
  // 64 r + 16 warp + g (+ 8 for j % 4 >= 2), column 8 (j / 4) + 2 t +
  // j % 2 of the warpgroup tile
  const int lt = ctid & (kWarpgroup - 1);
  const int g = (lt & 31) >> 2, tq = lt & 3;
  const int row0 = m0 + (BM == 64 ? 0 : 64 * RB * wg) + 16 * (lt >> 5) + g;
  const int col0 = n0 + (BM == 64 ? wg * WN : 0) + 2 * tq;
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) {
        const int m = row0 + 64 * r + ((j & 2) ? 8 : 0);
        const int n = col0 + 8 * (j >> 2) + (j & 1);
        if (m < M && n < N)
          store(out + static_cast<size_t>(m) * N + n, acc[r][j] * scale[n]);
      }
    return;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) {
      const int m = row0 + 64 * r + ((j & 2) ? 8 : 0);
      const int n = col0 + 8 * (j >> 2) + (j & 1);
      if (m < M && n < N)
        ws[(static_cast<size_t>(split) * M + m) * N + n] = acc[r][j];
    }
  __threadfence();  // this block's partials are visible device-wide
  consumers_sync();
  if (ctid == 0)
    last = atomicAdd(&counters[blockIdx.x], 1u) == splits - 1;
  consumers_sync();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) {
      const int m = row0 + 64 * r + ((j & 2) ? 8 : 0);
      const int n = col0 + 8 * (j >> 2) + (j & 1);
      if (m >= M || n >= N) continue;
      float s = 0.f;
      for (int p = 0; p < splits; ++p)
        s += __ldcg(ws + (static_cast<size_t>(p) * M + m) * N + n);
      store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
    }
  if (ctid == 0) counters[blockIdx.x] = 0;  // ready for the next call
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

// x packed (pack_x_kernel, into xp), then the product: two launches
template <typename TX, typename TO, int BM, int BN>
cudaError_t launch_mma(const void* x, void* xp, const void* wq,
                       const void* scale, void* out, void* ws,
                       void* counters, int M, int K, int N, int splits,
                       int k_chunk, cudaStream_t stream) {
  const dim3 tiles((M + BM - 1) / BM, (K + kBK - 1) / kBK);
  pack_x_kernel<TX, BM><<<tiles, 256, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<uint8_t*>(xp), M, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = mma_smem(BM, BN);
  // above the default: allowed on every launch, so on whichever device is
  // current
  e = cudaFuncSetAttribute(wgmma_kernel<TO, BM, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles.x * ((N + BN - 1) / BN), splits);
  wgmma_kernel<TO, BM, BN><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const uint8_t*>(xp), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), M, K, N,
      k_chunk);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_tile(const void* x, void* xp, const void* wq,
                        const void* scale, void* out, void* ws,
                        void* counters, int M, int K, int N, int rows,
                        int cols, int splits, int k_chunk,
                        cudaStream_t stream) {
  if (rows == 256 && cols == 128)
    return launch_mma<TX, TO, 256, 128>(x, xp, wq, scale, out, ws, counters,
                                        M, K, N, splits, k_chunk, stream);
  if (rows == 128 && cols == 256)
    return launch_mma<TX, TO, 128, 256>(x, xp, wq, scale, out, ws, counters,
                                        M, K, N, splits, k_chunk, stream);
  if (rows == 128 && cols == 128)
    return launch_mma<TX, TO, 128, 128>(x, xp, wq, scale, out, ws, counters,
                                        M, K, N, splits, k_chunk, stream);
  if (rows == 64 && cols == 256)
    return launch_mma<TX, TO, 64, 256>(x, xp, wq, scale, out, ws, counters,
                                       M, K, N, splits, k_chunk, stream);
  if (rows == 64 && cols == 128)
    return launch_mma<TX, TO, 64, 128>(x, xp, wq, scale, out, ws, counters,
                                       M, K, N, splits, k_chunk, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t tile_out(int out_dtype, const void* x, void* xp, const void* wq,
                     const void* scale, void* out, void* ws, void* counters,
                     int M, int K, int N, int rows, int cols, int splits,
                     int k_chunk, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch_tile<TX, float>(x, xp, wq, scale, out, ws, counters, M, K,
                                  N, rows, cols, splits, k_chunk, stream);
  if (out_dtype == kBF16)
    return launch_tile<TX, __nv_bfloat16>(x, xp, wq, scale, out, ws,
                                          counters, M, K, N, rows, cols,
                                          splits, k_chunk, stream);
  return cudaErrorInvalidValue;
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
  return launch_rows<TX, TO, 8>(x, wq, scale, out, ws, counters, M, K, N,
                                cols, splits, k_chunk, stream);
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

bool bad_split(int K, int splits, int k_chunk) {
  return splits < 1 || splits > 65535 || k_chunk < 1 ||
         static_cast<long long>(splits - 1) * k_chunk >= K ||
         static_cast<long long>(splits) * k_chunk < K;
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer to
// a contiguous row-major tensor: x (M, K), wq (K, N) int8, scale (N,)
// float32, out (M, N).  dtype codes: 0 float32, 1 bfloat16.  M, K, N >= 1.
// The K axis is cut into `splits` slices of `k_chunk` rows (the last may
// be shorter: (splits - 1) k_chunk < K <= splits k_chunk); with splits > 1,
// ws holds splits x M x N float32 partials and counters one unsigned int
// per block of output columns (M <= 8) or per output tile (M > 8), 0 on
// entry and left 0 (calls that may run at once, on two streams, need
// counters of their own).
//  * M <= 8: a block covers `cols` (64 or 256) output columns; `rows` and
//    xp are ignored.
//  * M > 8: a block covers a `rows` (64, 128 or 256) x `cols` (128 or 256)
//    output tile, k_chunk is a multiple of 64, and xp is 16-byte aligned
//    scratch of ceil(M / rows) x ceil(K / 64) x rows x 128 bytes (x
//    packed as bf16 tiles).
// Launches on `stream` without synchronising and returns the first
// cudaGetLastError() of its launches that is not cudaSuccess.
extern "C" int repro_quant_matmul(const void* x, void* xp, const void* wq,
                                  const void* scale, void* out, void* ws,
                                  void* counters, int M, int K, int N,
                                  int rows, int cols, int splits,
                                  int k_chunk, int x_dtype, int out_dtype,
                                  void* stream) {
  if (M < 1 || K < 1 || N < 1 || bad_split(K, splits, k_chunk) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 8) {
    if (k_chunk % kBK != 0 || xp == nullptr ||
        (reinterpret_cast<uintptr_t>(xp) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (x_dtype == kF32)
      return static_cast<int>(tile_out<float>(
          out_dtype, x, xp, wq, scale, out, ws, counters, M, K, N, rows,
          cols, splits, k_chunk, s));
    if (x_dtype == kBF16)
      return static_cast<int>(tile_out<__nv_bfloat16>(
          out_dtype, x, xp, wq, scale, out, ws, counters, M, K, N, rows,
          cols, splits, k_chunk, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cols != 64 && cols != 256)
    return static_cast<int>(cudaErrorInvalidValue);
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
