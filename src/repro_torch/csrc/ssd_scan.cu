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
// and the least operations: per (b, chunk) the causal score product
// C B^T once (every head shares B and C), Q (Q + 1) / 2 n multiply-adds;
// per (b, h, chunk) the causal scores x (x dt) product, Q (Q + 1) / 2 p,
// the inter-chunk product and the state update, Q p n each.  At the
// serving path's largest admission prefill (b = 4, l = 1024, h = 32,
// p = 64, n = 128, Q = 256) that is 6.6 GFLOP: 0.098 ms at the float32
// rate (67 TFLOP/s), 0.0067 ms at the bf16 tensor-core rate, where the
// 0.012 ms of bytes bound it instead.
//
// Design.  A walk of each (b, h) through its chunks in order leaves
// most SMs idle (128 blocks at b = 4, 32 for one row), so the chunked
// decomposition runs in four launches, all but the second parallel over
// chunks:
//  1. `state_kernel`, a block per (b, chunk, head, 64 state columns):
//     the chunk's cumsum as a block scan (warp shuffles), written to a
//     workspace, and the chunk's local end state
//     sum_j (x_j dt_j exp(cums_last - cums_j)) (x) B_j, a (P x Q)(Q x N)
//     product over 64-row tiles.
//  2. `pass_kernel`, a thread per (b, h, state element): the states in
//     chunk order from h0, state_c = exp(cums_last_c) state_{c-1} +
//     local_c; the workspace keeps the state entering each chunk, and
//     the last one is the final state.
//  3. `score_kernel`, a block per (b, chunk, pair of 64-row tiles
//     j <= i): the score tile C_i B_j^T in float32, once for every head
//     (B and C are one group), into the workspace.
//  4. `out_kernel`, a block per (b, chunk, 64-row tile, head): the inter
//     term exp(cums_i) C_i state^T, then for each key tile j <= i the
//     score tile, masked (j <= i, before the exponential: above the
//     diagonal cums_i - cums_j is positive and exp could overflow),
//     decayed, scaled by dt and multiplied into x_j.  Blocks of 2 or 4
//     heads that read each score tile once for all of them were slower
//     (registers for their y, fewer blocks; PERF.md).
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulators), fragments read by ldmatrix from padded rows
// (conflict-free).  An operand that is not bfloat16 is split into bf16
// pieces whose sum is the value, and the pieces' products that matter
// are summed: in the bf16 instantiation x, B and C are bf16 already (one
// piece, C B^T exact) and the float32 operands (decayed scores, x dt
// decay, the carried state) take two, hi + lo (relative error about
// 2^-17); in the float32 instantiation every operand takes three (hi +
// mid + lo, a float32's 24 bits) and the six products whose pieces
// count at most two places.  Operands are staged through their strides
// in 16-byte vectors where the addresses allow (scalar loads otherwise).
// The wrapper's shape-only plan (ssd_scan.py::ssd_plan) sizes the
// launches and the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;  // 4 warps, each 16 rows of a 64-row tile
constexpr int kT = 64;         // rows of a tile
constexpr int kMaxP = 64;      // head_dim
constexpr int kMaxN = 128;     // state width
constexpr int kSliceN = 64;    // state columns of a state_kernel block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

// pieces of a bf16 operand and of a float32 one, per instantiation
template <typename T> struct Pieces;
template <> struct Pieces<bf16> {
  static constexpr int kIn = 1;       // x, B, C: bf16 already
  static constexpr int kDerived = 2;  // float32 operands: hi + lo
};
template <> struct Pieces<float> {
  static constexpr int kIn = 3;
  static constexpr int kDerived = 3;
};

// v as NP bf16 pieces whose sum is v to NP x 8 bits
template <int NP>
__device__ __forceinline__ void split(float v, bf16 (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    out[i] = __float2bfloat16(v);
    v -= __bfloat162float(out[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[0..1] (two n8 tiles) += the products of the pieces of A (NA) and B
// (NB, registers 0-1 the first tile, 2-3 the second) whose place is at
// most max(NA, NB) - 1: every piece pair above 2^-(8 max) of the result
template <int NA, int NB>
__device__ __forceinline__ void mma_pieces(float (&d0)[4], float (&d1)[4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][4]) {
  constexpr int kTop = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kTop) {
        mma(d0, a[i], b[j][0], b[j][1]);
        mma(d1, a[i], b[j][2], b[j][3]);
      }
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// Stage rows [0, rows) x columns [0, width16) of a row-major operand into
// NP bf16 pieces in shared memory (piece i at dst + i * pstride, row r at
// r * rstride elements): source row r at src + r * ld elements, `valid`
// rows and `width` columns in range, the rest zero; each value times
// rscale[r] when rscale is given.  16-byte vector loads where the source
// rows allow them, scalar loads otherwise.  Every thread of the block
// takes part.
template <int NP, typename TS>
__device__ __forceinline__ void stage(bf16* dst, int rstride, int pstride,
                                      int rows, int width16,
                                      const TS* __restrict__ src,
                                      long long ld, int valid, int width,
                                      const float* rscale) {
  constexpr int V = 16 / sizeof(TS);
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (ld * static_cast<long long>(sizeof(TS))) % 16 == 0 &&
                   width % V == 0;
  const int per_row = width16 / V;
  const int total = rows * per_row;
  const int dr = kThreads / per_row, dc = kThreads % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int col = c * V;
    float v[V];
    if (r < valid && col < width) {
      const TS* p = src + r * ld + col;
      if (vec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const TS* t = reinterpret_cast<const TS*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = to_float(t[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[i] = col + i < width ? to_float(p[i]) : 0.f;
      }
      if (rscale != nullptr) {
        const float s = rscale[r];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] *= s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
    bf16 pc[V][NP];
#pragma unroll
    for (int i = 0; i < V; ++i) split<NP>(v[i], pc[i]);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      uint32_t w[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i) w[i] = pack(pc[2 * i][k], pc[2 * i + 1][k]);
      bf16* d = dst + k * pstride + r * rstride + col;
      if constexpr (V == 8)
        *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Row strides (bf16 elements) of the staged tiles: 8 elements of padding
// make every row an odd multiple of 16 bytes mod 128, so the 8 rows of an
// ldmatrix land in distinct banks.
__device__ __forceinline__ int row_stride(int width16) { return width16 + 8; }

// ---------------------------------------------------------------------------
// 1. cumsum and local end state of each (b, chunk, head)
// ---------------------------------------------------------------------------

// Shared memory of a state_kernel block (the wrapper computes the same
// in repro_torch/kernels/ssd_scan.py::state_smem).
size_t state_smem(int P, int N, int Q, int nd, int ni) {
  const int p16 = (P + 15) & ~15;
  const int n16 = ((N < kSliceN ? N : kSliceN) + 15) & ~15;
  return 2 * (static_cast<size_t>(nd) * kT * (p16 + 8) +
              static_cast<size_t>(ni) * kT * (n16 + 8)) +
         sizeof(float) * (2 * static_cast<size_t>(Q) + kT + 8);
}

// Block (head h and state columns [64 s, 64 s + 64) in blockIdx.x, chunk
// blockIdx.y, row blockIdx.z).  Warp w owns state rows [16 w, 16 w + 16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ st, float* __restrict__ cums_ws,
                 float* __restrict__ last_ws, int H, int L, int P, int N,
                 int Q, long long xsb, long long xsl, long long dsb,
                 long long dsl, long long bsb, long long bsl) {
  constexpr int ND = Pieces<T>::kDerived, NI = Pieces<T>::kIn;
  extern __shared__ __align__(16) uint8_t smem[];
  const int slices = (N + kSliceN - 1) / kSliceN;
  const int h = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * Q, qv = min(Q, L - t0);
  const int p16 = pad16(P);
  const int n_lo = sl * kSliceN, nw = min(kSliceN, N - n_lo);
  const int n16 = pad16(nw);
  const int xs = row_stride(p16), bs = row_stride(n16);
  bf16* Xs = reinterpret_cast<bf16*>(smem);          // ND x kT x xs
  bf16* Bs = Xs + ND * kT * xs;                      // NI x kT x bs
  float* dts = reinterpret_cast<float*>(Bs + NI * kT * bs);  // Q
  float* cums = dts + Q;                             // Q
  float* wj = cums + Q;                              // kT row weights
  float* wsum = wj + kT;                             // 4 warp sums + carry
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  const float* dtb = dt + b * dsb + h;

  for (int i = tid; i < Q; i += kThreads)
    dts[i] = i < qv ? dtb[(t0 + i) * dsl] : 0.f;
  __syncthreads();
  // inclusive cumsum of dt * a: a warp scan by shuffles, then the warps'
  // sums in order, 128 positions a pass
  float carry = 0.f;
  for (int i0 = 0; i0 < Q; i0 += kThreads) {
    const int i = i0 + tid;
    float v = i < Q ? dts[i] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float add = carry;
    for (int w = 0; w < warp; ++w) add += wsum[w];
    if (i < Q) cums[i] = v + add;
    carry += wsum[0] + wsum[1] + wsum[2] + wsum[3];
    __syncthreads();
  }
  const float last = cums[Q - 1];
  if (sl == 0) {
    float* cw = cums_ws + (static_cast<long long>(b) * nc * Q + t0) * H + h;
    for (int i = tid; i < Q; i += kThreads) cw[static_cast<long long>(i) * H] = cums[i];
    if (tid == 0) last_ws[(static_cast<long long>(b) * nc + c) * H + h] = last;
  }

  // local end state, rows [16 warp, +16) x columns [n_lo, n_lo + 64)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  const T* xb = x + b * xsb + static_cast<long long>(h) * P;
  const T* Bb = Bm + b * bsb + n_lo;
  for (int j0 = 0; j0 < qv; j0 += kT) {
    const int jv = min(kT, qv - j0);
    for (int r = tid; r < kT; r += kThreads)
      wj[r] = r < jv ? dts[j0 + r] * expf(last - cums[j0 + r]) : 0.f;
    __syncthreads();
    stage<ND>(Xs, xs, kT * xs, kT, p16, xb + (t0 + j0) * xsl, xsl, jv, P,
              wj);
    stage<NI>(Bs, bs, kT * bs, kT, n16, Bb + (t0 + j0) * bsl, bsl, jv, nw,
              static_cast<const float*>(nullptr));
    __syncthreads();
    if (16 * warp < p16) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        // A = (x dt decay)^T: rows p, k = j, stored [j][p] -> transposed
        uint32_t af[ND][4];
        const int ar = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int ac = 16 * warp + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          ldsm_x4_t(af[i], smem_u32(Xs + i * kT * xs + ar * xs + ac));
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          if (16 * nn >= n16) break;
          // B = B_j: k = j, columns n, stored [j][n] -> transposed
          uint32_t bf[NI][4];
          const int br = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int bc = 16 * nn + ((lane >> 4) << 3);
#pragma unroll
          for (int i = 0; i < NI; ++i)
            ldsm_x4_t(bf[i], smem_u32(Bs + i * kT * bs + br * bs + bc));
          mma_pieces<ND, NI>(acc[2 * nn], acc[2 * nn + 1], af, bf);
        }
      }
    }
    __syncthreads();  // Xs, Bs and wj are refilled next
  }
  const int g = lane >> 2, tq = lane & 3;
  float* out = st + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 16 * warp + g + (r >= 2 ? 8 : 0);
      const int n = 8 * j + 2 * tq + (r & 1);
      if (p < P && n < nw) out[p * N + n_lo + n] = acc[j][r];
    }
}

// ---------------------------------------------------------------------------
// 2. states in chunk order
// ---------------------------------------------------------------------------

// Thread (b, h, element e of the P x N state): state_c = exp(last_c)
// state_{c-1} + local_c from h0 (or 0).  st[b][c][h] holds local_c on
// entry and the state entering chunk c on exit; hout the final state.
__global__ void __launch_bounds__(256)
    pass_kernel(float* __restrict__ st, const float* __restrict__ last_ws,
                const float* __restrict__ h0, float* __restrict__ hout,
                int H, int PN, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  float s = h0 != nullptr ? h0[bh * PN + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long k = (static_cast<long long>(b) * nc + c) * H + h;
    float* p = st + k * PN + e;
    const float local = *p;
    *p = s;
    s = expf(last_ws[k]) * s + local;
  }
  hout[bh * PN + e] = s;
}

// ---------------------------------------------------------------------------
// 3. the score tiles C_i B_j^T of each (b, chunk), once for every head
// ---------------------------------------------------------------------------

// Shared memory of a score_kernel block (the wrapper computes the same in
// repro_torch/kernels/ssd_scan.py::score_smem): a C and a B tile.
size_t score_smem(int N, int ni) {
  const size_t n16 = (N + 15) & ~15;
  return 2 * 2 * ni * kT * (n16 + 8);
}

// Block (tile pair blockIdx.x = it (it + 1) / 2 + jt with jt <= it, chunk
// blockIdx.y, row blockIdx.z): the 64 x 64 float32 tile C[i0 + r] .
// B[j0 + s] of the chunk's row tile i0 = 64 it and key tile j0 = 64 jt,
// unmasked, stored row-major at scores[((b nc + c) pairs + pair) 4096].
// Warp w computes rows [16 w, +16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    score_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                 float* __restrict__ scores, int L, int N, int Q,
                 long long bsb, long long bsl, long long csb,
                 long long csl) {
  constexpr int NI = Pieces<T>::kIn;
  extern __shared__ __align__(16) uint8_t smem[];
  const int pair = blockIdx.x, pairs = gridDim.x;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * Q, qv = min(Q, L - t0), i0 = it * kT, j0 = jt * kT;
  if (i0 >= qv) return;  // past the sequence's end (uniform)
  const int n16 = pad16(N), ns = row_stride(n16);
  bf16* Cs = reinterpret_cast<bf16*>(smem);          // NI x kT x ns
  bf16* Bs = Cs + NI * kT * ns;                      // NI x kT x ns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage<NI>(Cs, ns, kT * ns, kT, n16, Cm + b * csb + (t0 + i0) * csl, csl,
            min(kT, qv - i0), N, static_cast<const float*>(nullptr));
  stage<NI>(Bs, ns, kT * ns, kT, n16, Bm + b * bsb + (t0 + j0) * bsl, bsl,
            min(kT, qv - j0), N, static_cast<const float*>(nullptr));
  __syncthreads();

  float sc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
  // A: C rows i, k = n, stored [i][n]; B: B rows j (columns), k = n
  const int cr = 16 * warp + (lane & 15), cc = (lane >> 4) << 3;
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    if (16 * ks >= n16) break;
    uint32_t af[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      ldsm_x4(af[i], smem_u32(Cs + i * kT * ns + cr * ns + 16 * ks + cc));
#pragma unroll
    for (int jn = 0; jn < kT / 16; ++jn) {
      uint32_t bf[NI][4];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        ldsm_x4(bf[i], smem_u32(Bs + i * kT * ns + (16 * jn + kr) * ns +
                                16 * ks + kc));
      mma_pieces<NI, NI>(sc[2 * jn], sc[2 * jn + 1], af, bf);
    }
  }
  const int g = lane >> 2, tq = lane & 3;
  float* out = scores + ((static_cast<long long>(b) * nc + c) * pairs + pair) *
                            kT * kT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = 16 * warp + g, col = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(out + row * kT + col) =
        make_float2(sc[j][0], sc[j][1]);
    *reinterpret_cast<float2*>(out + (row + 8) * kT + col) =
        make_float2(sc[j][2], sc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// 4. y: inter term, then the intra term over key tiles j <= i
// ---------------------------------------------------------------------------

// Shared memory of an out_kernel block (the wrapper computes the same in
// repro_torch/kernels/ssd_scan.py::out_smem): the C tile, then either
// the state (inter term) or the x tile, and the rows' cumsums and dt.
size_t out_smem(int P, int N, int nd, int ni) {
  const size_t p16 = (P + 15) & ~15, n16 = (N + 15) & ~15;
  const size_t c_tile = ni * kT * (n16 + 8);
  const size_t state = nd * p16 * (n16 + 8);
  const size_t keys = ni * kT * (p16 + 8);
  return 2 * (c_tile + (state > keys ? state : keys)) +
         sizeof(float) * 3 * kT;
}

// Block (head blockIdx.x, chunk blockIdx.y / tiles and row tile
// blockIdx.y % tiles, row blockIdx.z).  Warp w owns rows [16 w, +16) of
// the tile; its y stays in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ st,
               const float* __restrict__ cums_ws,
               const float* __restrict__ scores, T* __restrict__ y, int H,
               int L, int P, int N, int Q, long long xsb, long long xsl,
               long long dsb, long long dsl, long long csb, long long csl) {
  constexpr int ND = Pieces<T>::kDerived, NI = Pieces<T>::kIn;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles = (Q + kT - 1) / kT, pairs = tiles * (tiles + 1) / 2;
  const int h = blockIdx.x, c = blockIdx.y / tiles, it = blockIdx.y % tiles;
  const int b = blockIdx.z, nc = (L + Q - 1) / Q;
  const int t0 = c * Q, qv = min(Q, L - t0), i0 = it * kT;
  if (i0 >= qv) return;  // past the sequence's end (uniform)
  const int iv = min(kT, qv - i0);
  const int p16 = pad16(P), n16 = pad16(N);
  const int xs = row_stride(p16), ns = row_stride(n16);
  bf16* Cs = reinterpret_cast<bf16*>(smem);          // NI x kT x ns
  bf16* Ks = Cs + NI * kT * ns;                      // keys or state
  bf16* Xs = Ks;                                     // NI x kT x xs
  bf16* Ss = Ks;                                     // ND x p16 x ns
  const size_t state = static_cast<size_t>(ND) * p16 * ns;
  const size_t keys = static_cast<size_t>(NI) * kT * xs;
  float* ci = reinterpret_cast<float*>(Ks + (state > keys ? state : keys));
  float* cj = ci + kT;                               // kT
  float* dj = cj + kT;                               // kT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float* cw = cums_ws + (static_cast<long long>(b) * nc * Q + t0) * H + h;
  const float* sw = scores + (static_cast<long long>(b) * nc + c) * pairs *
                                 kT * kT;

  stage<NI>(Cs, ns, kT * ns, kT, n16, Cm + b * csb + (t0 + i0) * csl, csl,
            iv, N, static_cast<const float*>(nullptr));
  const long long k = (static_cast<long long>(b) * nc + c) * H + h;
  stage<ND>(Ss, ns, p16 * ns, p16, n16, st + k * P * N, N, P, N,
            static_cast<const float*>(nullptr));
  for (int r = tid; r < kT; r += kThreads)
    ci[r] = i0 + r < Q ? cw[static_cast<long long>(i0 + r) * H] : 0.f;
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  // inter term: C_i state^T (A: C rows i, k = n, stored [i][n]; B: the
  // state stored [p][n], two n8 tiles of p x k16), then exp(cums_i)
  const int cr = 16 * warp + (lane & 15), cc = (lane >> 4) << 3;
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    if (16 * ks >= n16) break;
    uint32_t af[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      ldsm_x4(af[i], smem_u32(Cs + i * kT * ns + cr * ns + 16 * ks + cc));
#pragma unroll
    for (int pn = 0; pn < kMaxP / 16; ++pn) {
      if (16 * pn >= p16) break;
      uint32_t bf[ND][4];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        ldsm_x4(bf[i], smem_u32(Ss + i * p16 * ns + (16 * pn + kr) * ns +
                                16 * ks + kc));
      mma_pieces<NI, ND>(acc[2 * pn], acc[2 * pn + 1], af, bf);
    }
  }
  const float c0 = ci[16 * warp + g], c1 = ci[16 * warp + g + 8];
  {
    const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }

  // intra term over the key tiles at or below the diagonal
  const int ia = i0 + 16 * warp + g;  // this thread's rows ia, ia + 8
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT, jv = min(kT, qv - j0);
    __syncthreads();  // Xs, cj, dj (or Ss) are free
    stage<NI>(Xs, xs, kT * xs, kT, p16,
              x + b * xsb + (t0 + j0) * xsl + static_cast<long long>(h) * P,
              xsl, jv, P, static_cast<const float*>(nullptr));
    for (int r = tid; r < kT; r += kThreads) {
      cj[r] = j0 + r < Q ? cw[static_cast<long long>(j0 + r) * H] : 0.f;
      dj[r] = r < jv ? dt[b * dsb + (t0 + j0 + r) * dsl + h] : 0.f;
    }
    // this warp's rows of the score tile (row g: registers 0-1 of each
    // key tile of 8, row g + 8: registers 2-3), from the score launch
    float sc[8][4];
    const float* tile = sw + (it * (it + 1) / 2 + jt) * kT * kT +
                        (16 * warp + g) * kT + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(tile + 8 * j);
      const float2 v = *reinterpret_cast<const float2*>(tile + 8 * kT + 8 * j);
      sc[j][0] = u.x;
      sc[j][1] = u.y;
      sc[j][2] = v.x;
      sc[j][3] = v.y;
    }
    __syncthreads();

    // the masked, decayed, dt-scaled scores (A fragments, from the
    // accumulator layout of two key tiles) times x_j
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      float v[8];  // a0: (ia, j), (ia, j+1); a1: rows +8; a2, a3: j + 8
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int jl = 16 * kk + 8 * (q >> 2) + 2 * tq + (q & 1);
        const int row = (q >> 1) & 1;  // 0: ia, 1: ia + 8
        const float sv = sc[2 * kk + (q >> 2)][(row << 1) | (q & 1)];
        v[q] = j0 + jl <= ia + 8 * row
                   ? sv * expf((row ? c1 : c0) - cj[jl]) * dj[jl]
                   : 0.f;
      }
      uint32_t af[ND][4];
      bf16 pc[8][ND];
#pragma unroll
      for (int q = 0; q < 8; ++q) split<ND>(v[q], pc[q]);
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          af[i][r] = pack(pc[2 * r][i], pc[2 * r + 1][i]);
#pragma unroll
      for (int pn = 0; pn < kMaxP / 16; ++pn) {
        if (16 * pn >= p16) break;
        uint32_t bf[NI][4];
        const int xr = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int xc = 16 * pn + ((lane >> 4) << 3);
#pragma unroll
        for (int i = 0; i < NI; ++i)
          ldsm_x4_t(bf[i], smem_u32(Xs + i * kT * xs + xr * xs + xc));
        mma_pieces<ND, NI>(acc[2 * pn], acc[2 * pn + 1], af, bf);
      }
    }
  }

  // y rows [i0, i0 + iv)
  const long long yrow = static_cast<long long>(H) * P;
  T* yb = y + (static_cast<long long>(b) * L + t0 + i0) * yrow +
          static_cast<long long>(h) * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 16 * warp + g + (r >= 2 ? 8 : 0);
      const int p = 8 * j + 2 * tq + (r & 1);
      if (i < iv && p < P) store(yb + i * yrow + p, acc[j][r]);
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* h0, void* y,
                   void* hout, float* ws, int batch, int L, int H, int P,
                   int N, int Q, long long xsb, long long xsl,
                   long long dsb, long long dsl, long long bsb,
                   long long bsl, long long csb, long long csl,
                   cudaStream_t stream) {
  constexpr int ND = Pieces<T>::kDerived, NI = Pieces<T>::kIn;
  const int nc = (L + Q - 1) / Q;
  const int tiles = (Q + kT - 1) / kT, pairs = tiles * (tiles + 1) / 2;
  // workspace: score tiles (b, nc, pairs, 64, 64), states (b, nc, h, P,
  // N), cumsums (b, nc Q, h), chunk totals (b, nc, h); the float2 and
  // 16-byte accesses come first, at the allocation's alignment
  float* scores = ws;
  float* st = scores + static_cast<size_t>(batch) * nc * pairs * kT * kT;
  float* cums = st + static_cast<size_t>(batch) * nc * H * P * N;
  float* last = cums + static_cast<size_t>(batch) * nc * Q * H;

  const size_t s1 = state_smem(P, N, Q, ND, NI);
  cudaError_t e = cudaFuncSetAttribute(
      state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (e != cudaSuccess) return e;
  const int slices = (N + kSliceN - 1) / kSliceN;
  state_kernel<T><<<dim3(H * slices, nc, batch), kThreads, s1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B), st, cums, last,
      H, L, P, N, Q, xsb, xsl, dsb, dsl, bsb, bsl);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int PN = P * N;
  pass_kernel<<<dim3((PN + 255) / 256, H, batch), 256, 0, stream>>>(
      st, last, static_cast<const float*>(h0), static_cast<float*>(hout), H,
      PN, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = score_smem(N, NI);
  e = cudaFuncSetAttribute(score_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s3));
  if (e != cudaSuccess) return e;
  score_kernel<T><<<dim3(pairs, nc, batch), kThreads, s3, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C), scores, L, N, Q,
      bsb, bsl, csb, csl);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s4 = out_smem(P, N, ND, NI);
  e = cudaFuncSetAttribute(out_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s4));
  if (e != cudaSuccess) return e;
  out_kernel<T><<<dim3(H, nc * tiles, batch), kThreads, s4, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(C), st, cums, scores, static_cast<T*>(y), H, L,
      P, N, Q, xsb, xsl, dsb, dsl, csb, csl);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers: x (batch, L, H, P)
// with row stride xsl and batch stride xsb (elements; heads P apart,
// columns contiguous); dt (batch, L, H) float32 with strides dsb/dsl
// (heads contiguous); B and C (batch, L, N) with strides bsb/bsl and
// csb/csl (columns contiguous); A (H,) and h0 (batch, H, P, N) or null,
// float32 and contiguous; y (batch, L, H, P) contiguous in x's type; hout
// (batch, H, P, N) float32 contiguous; ws 16-byte aligned float32 scratch of
// batch x nc x (H (P N + Q + 1) + T (T + 1) / 2 x 4096) floats, nc =
// ceil(L / Q), T = ceil(Q / 64).  dtype code of x, B, C and y: 0 float32,
// 1 bfloat16.  Q is the chunk width, 1 <= Q; P <= 64, N <= 128.  Four
// launches on `stream` without synchronising; returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* h0,
                              void* y, void* hout, void* ws, int batch,
                              int L, int H, int P, int N, int Q,
                              long long xsb, long long xsl, long long dsb,
                              long long dsl, long long bsb, long long bsl,
                              long long csb, long long csl, int dtype,
                              void* stream) {
  if (batch < 1 || L < 1 || H < 1 || Q < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, dt, A, B, C, h0, y, hout, w,
                                          batch, L, H, P, N, Q, xsb, xsl,
                                          dsb, dsl, bsb, bsl, csb, csl, s));
  if (dtype == kBF16)
    return static_cast<int>(launch<bf16>(x, dt, A, B, C, h0, y, hout, w,
                                         batch, L, H, P, N, Q, xsb, xsl,
                                         dsb, dsl, bsb, bsl, csb, csl, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
