// Mamba2 SSD (state-space duality) chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_kernel`, launched by the pl.pallas_call in `ssd_scan`).  The
// plain PyTorch version is repro_torch/kernels/ref.py::ssd_scan_ref (the
// sequential recurrence); the wrapper that checks arguments and launches
// this file is repro_torch/kernels/ssd_scan.py.
//
// What it computes, as the TPU kernel does, in float32: for each (batch
// row b, head h) the sequence runs in chunks of Q positions, in order,
// with the (P, N) state carried from chunk to chunk.  Per chunk, with
// cums = inclusive cumsum of dt * A over the chunk:
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j   (intra)
//          + exp(cums_i) C_i . state                                  (inter)
//   state <- exp(cums_last) state + sum_j (x_j dt_j exp(cums_last - cums_j)) (x) B_j
// y is written in x's type (float32 or bfloat16), the final state in
// float32.  x (b, l, h, p), dt (b, l, h) float32 (post-softplus), A (h,)
// float32, B and C (b, l, n), one group shared by every head, h0
// (b, h, p, n) float32 or none.  A tail shorter than Q reads as zeros:
// dt = 0 makes those positions no-ops (decay exp(0) = 1, no update),
// exactly like the TPU kernel's zero padding.
//
// Bound.  The larger of two times: the bytes the call must move (x, dt,
// B, C read once, y and the final state written once) over 3.35 TB/s,
// and 2 * b * h * nc * (Q (Q + 1) / 2 * (n + p) + 2 Q p n) operations
// (the intra-chunk products need only the causal pairs j <= i) over
// 67 TFLOP/s: the TPU kernel does its math in float32, and so does this
// one, outside the tensor cores.  At the serving path's largest
// admission prefill (b = 4, l = 1024, h = 32, p = 64, n = 128, Q = 256)
// that is 10.8 GFLOP, 0.161 ms, against 0.012 ms of bytes: the scan is
// bound by operations.  At the bf16 tensor-core rate the same products
// would take 0.011 ms, and the bytes would bound it.
//
// Design.  One block per (b, h): the TPU's sequential chunk axis becomes
// a loop over chunks inside the block, with the state in shared memory
// (P x N float32, 32 KB at full width).  Q = 256 rows of B and C alone
// would be 128 KB each and the Q x Q score tile 256 KB, so a chunk is
// walked in tiles of 64 rows: for each row tile i, the C rows stay in
// shared memory while the B and x tiles j <= i stream through; the
// 64 x 64 score tile C_i B_j^T is masked (j <= i) BEFORE the exponential
// (exp of a positive cums difference above the diagonal could overflow,
// and inf * 0 is NaN) and multiplied into x_j.  The three terms stay
// matrix products (score tile, score x x, C x state, x^T x B), each a
// 4 x 4 (or 4 x 8) register tile per thread of a 16 x 16 thread grid,
// so a later version can move them onto tensor cores.  The cumsum of a
// chunk is one thread's sequential loop (Q adds).  x, dt, B and C are
// read through their batch and row strides, so the strided views into
// the in_proj output that the model passes, and slices of a longer
// sequence, need no copy; columns (and dt's heads) are contiguous.
// Parallelism is b * h blocks: 128 at a full group of 4 rows, 32 for a
// single row, on 132 SMs.  Simple and right first: no tensor cores, no
// cp.async/TMA pipeline, no split of a row's chunks across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;  // a 16 x 16 thread grid over each tile
constexpr int kT = 64;         // rows of a chunk tile
constexpr int kMaxP = 64;      // head_dim: 4 column groups of 16
constexpr int kMaxN = 128;     // state width: 8 column groups of 16
constexpr int kPG = kMaxP / 16;
constexpr int kNG = kMaxN / 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Tile rows [0, kT) of an operand whose row r is src + r * ld (columns
// contiguous) into dst, kT x (width + 1) floats (one float of padding a
// row keeps column walks free of bank conflicts).  Rows at or past
// `valid` read 0; row r is multiplied by rscale[r] when rscale is given.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long ld, int valid, int width,
                                          const float* rscale) {
  const int stride = width + 1;
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    float v = 0.f;
    if (r < valid) {
      v = to_float(src[r * ld + c]);
      if (rscale != nullptr) v *= rscale[r];
    }
    dst[r * stride + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ hout, int H,
                    int L, int P, int N, int Q, long long xsb, long long xsl,
                    long long dsb, long long dsl, long long bsb,
                    long long bsl, long long csb, long long csl) {
  extern __shared__ float smem[];
  const int ns = N + 1, ps = P + 1, gs = kT + 1;
  float* S = smem;             // (P, N + 1)  the carried state
  float* Ct = S + P * ns;      // (kT, N + 1) C rows of the row tile
  float* Bt = Ct + kT * ns;    // (kT, N + 1) B rows of the column tile
  float* Xt = Bt + kT * ns;    // (kT, P + 1) x rows of the column tile
  float* Gt = Xt + kT * ps;    // (kT, kT + 1) masked, decayed scores
  float* cums = Gt + kT * gs;  // (Q,) inclusive cumsum of dt * A
  float* dts = cums + Q;       // (Q,) dt of the chunk
  float* rs = dts + Q;         // (kT,) row scales of the state update

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a = A[h];
  const T* xb = x + b * xsb + static_cast<long long>(h) * P;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  const float* dtb = dt + b * dsb + h;
  const long long yrow = static_cast<long long>(H) * P;
  T* yb = y + static_cast<long long>(b) * L * yrow +
          static_cast<long long>(h) * P;
  const long long sbase = static_cast<long long>(bh) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    S[r * ns + c] = h0 != nullptr ? h0[sbase + e] : 0.f;
  }

  const int nc = (L + Q - 1) / Q;
  const int nt = (Q + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk is done with dts, cums and S
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = t0 + i < L ? dtb[(t0 + i) * dsl] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a;
        cums[i] = run;
      }
    }
    __syncthreads();
    const float last = cums[Q - 1];

    // y of each row tile: the inter term from the carried state, then the
    // intra term over the column tiles at or below the diagonal
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      const int iv = max(0, min(kT, min(Q - i0, L - t0 - i0)));
      if (iv == 0) continue;  // past the sequence's end (uniform)
      load_tile(Ct, Cb + static_cast<long long>(t0 + i0) * csl, csl, iv, N,
                static_cast<const float*>(nullptr));
      __syncthreads();
      float acc[4][kPG];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < kPG; ++v) acc[u][v] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[kPG];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Ct[(ty + 16 * u) * ns + k];
#pragma unroll
        for (int v = 0; v < kPG; ++v) {
          const int p = tx + 16 * v;
          sv[v] = p < P ? S[p * ns + k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < kPG; ++v) acc[u][v] = fmaf(cv[u], sv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty + 16 * u;
        const float e = i < Q ? expf(cums[i]) : 0.f;
#pragma unroll
        for (int v = 0; v < kPG; ++v) acc[u][v] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        const int jv = max(0, min(kT, min(Q - j0, L - t0 - j0)));
        load_tile(Bt, Bb + static_cast<long long>(t0 + j0) * bsl, bsl, jv, N,
                  static_cast<const float*>(nullptr));
        load_tile(Xt, xb + static_cast<long long>(t0 + j0) * xsl, xsl, jv, P,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) g[u][v] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = Ct[(ty + 16 * u) * ns + k];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = Bt[(tx + 16 * v) * ns + k];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) g[u][v] = fmaf(cv[u], bv[v], g[u][v]);
        }
        // mask before the exponential: above the diagonal cums_i - cums_j
        // is positive and its exp may overflow
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty + 16 * u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + tx + 16 * v;
            float val = 0.f;
            if (i < Q && j <= i) val = g[u][v] * expf(cums[i] - cums[j]) * dts[j];
            Gt[(ty + 16 * u) * gs + tx + 16 * v] = val;
          }
        }
        __syncthreads();
        for (int k = 0; k < jv; ++k) {
          float gv[4], xv[kPG];
#pragma unroll
          for (int u = 0; u < 4; ++u) gv[u] = Gt[(ty + 16 * u) * gs + k];
#pragma unroll
          for (int v = 0; v < kPG; ++v) {
            const int p = tx + 16 * v;
            xv[v] = p < P ? Xt[k * ps + p] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < kPG; ++v) acc[u][v] = fmaf(gv[u], xv[v], acc[u][v]);
        }
        __syncthreads();  // Bt, Xt and Gt are refilled next
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty + 16 * u;
        if (i >= i0 + iv) continue;
        T* row = yb + static_cast<long long>(t0 + i) * yrow;
#pragma unroll
        for (int v = 0; v < kPG; ++v) {
          const int p = tx + 16 * v;
          if (p < P) store(row + p, acc[u][v]);
        }
      }
    }

    // state <- exp(cums_last) state + sum_j (x_j dt_j exp(cums_last -
    // cums_j)) (x) B_j, summed over the chunk's column tiles in registers
    float sacc[kPG][kNG];
#pragma unroll
    for (int u = 0; u < kPG; ++u)
#pragma unroll
      for (int v = 0; v < kNG; ++v) sacc[u][v] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      const int jv = max(0, min(kT, min(Q - j0, L - t0 - j0)));
      if (jv == 0) continue;  // uniform
      for (int r = tid; r < kT; r += kThreads)
        rs[r] = r < jv ? dts[j0 + r] * expf(last - cums[j0 + r]) : 0.f;
      __syncthreads();
      load_tile(Bt, Bb + static_cast<long long>(t0 + j0) * bsl, bsl, jv, N,
                static_cast<const float*>(nullptr));
      load_tile(Xt, xb + static_cast<long long>(t0 + j0) * xsl, xsl, jv, P,
                static_cast<const float*>(rs));
      __syncthreads();
      for (int k = 0; k < jv; ++k) {
        float xv[kPG], bv[kNG];
#pragma unroll
        for (int u = 0; u < kPG; ++u) {
          const int p = ty + 16 * u;
          xv[u] = p < P ? Xt[k * ps + p] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < kNG; ++v) {
          const int n = tx + 16 * v;
          bv[v] = n < N ? Bt[k * ns + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPG; ++u)
#pragma unroll
          for (int v = 0; v < kNG; ++v) sacc[u][v] = fmaf(xv[u], bv[v], sacc[u][v]);
      }
      __syncthreads();  // rs, Bt and Xt are refilled next
    }
    const float dec = expf(last);
#pragma unroll
    for (int u = 0; u < kPG; ++u) {
      const int p = ty + 16 * u;
      if (p >= P) continue;
#pragma unroll
      for (int v = 0; v < kNG; ++v) {
        const int n = tx + 16 * v;
        if (n < N) S[p * ns + n] = S[p * ns + n] * dec + sacc[u][v];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int r = e / N, c = e - r * N;
    hout[sbase + e] = S[r * ns + c];
  }
}

// Dynamic shared memory of one block, in bytes (the wrapper computes the
// same number in repro_torch/kernels/ssd_scan.py::shared_bytes).
size_t shared_bytes(int P, int N, int Q) {
  return sizeof(float) *
         (static_cast<size_t>(P) * (N + 1) + 2 * kT * (N + 1) +
          kT * (P + 1) + kT * (kT + 1) + 2 * static_cast<size_t>(Q) + kT);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* h0, void* y,
                   void* hout, int batch, int L, int H, int P, int N, int Q,
                   long long xsb, long long xsl, long long dsb,
                   long long dsl, long long bsb, long long bsl,
                   long long csb, long long csl, cudaStream_t stream) {
  const size_t smem = shared_bytes(P, N, Q);
  auto kernel = ssd_scan_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), H, L, P, N, Q, xsb, xsl,
      dsb, dsl, bsb, bsl, csb, csl);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers: x (batch, L, H, P)
// with row stride xsl and batch stride xsb (elements; heads P apart,
// columns contiguous); dt (batch, L, H) float32 with strides dsb/dsl
// (heads contiguous); B and C (batch, L, N) with strides bsb/bsl and
// csb/csl (columns contiguous); A (H,) and h0 (batch, H, P, N) or null,
// float32 and contiguous; y (batch, L, H, P)
// contiguous in x's type; hout (batch, H, P, N) float32 contiguous.
// dtype code of x, B, C and y: 0 float32, 1 bfloat16.  Q is the chunk
// width, 1 <= Q; P <= 64, N <= 128.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* h0,
                              void* y, void* hout, int batch, int L, int H,
                              int P, int N, int Q, long long xsb,
                              long long xsl, long long dsb, long long dsl,
                              long long bsb, long long bsl, long long csb,
                              long long csl, int dtype, void* stream) {
  if (batch < 1 || L < 1 || H < 1 || Q < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, dt, A, B, C, h0, y, hout, batch,
                                          L, H, P, N, Q, xsb, xsl, dsb, dsl,
                                          bsb, bsl, csb, csl, s));
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, dt, A, B, C, h0, y, hout, batch, L, H, P, N, Q, xsb, xsl, dsb,
        dsl, bsb, bsl, csb, csl, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
