// Blocked causal GQA attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`, launched by the
// pl.pallas_call in `flash_attention`).  The plain PyTorch version is
// repro_torch/kernels/ref.py::flash_attention_ref (the masked full
// softmax); the wrapper that checks arguments and launches this file is
// repro_torch/kernels/flash_attention.py.
//
// What it computes, as the TPU kernel does: q (B, S, H, hd), k and v
// (B, T, K, hd), H = G * K (query head h reads kv head h / G), positions
// counting from 0 on both axes.  For query position i and key position
// j, s = scale * (q_i . k_j), then softcap * tanh(s / softcap) when
// softcap > 0, then the mask j <= i (and j > i - window when window >
// 0); an online softmax over the visible keys in float32 with the
// running (max m, sum l, accumulator acc) of the TPU kernel (-1e30 for
// masked scores, masked probabilities 0), and the output acc / max(l,
// 1e-30) in q's type (float32 or bfloat16).  A query row with no
// visible key (only possible when T < S) is 0, as in the TPU kernel.
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
// (0.0125 ms): the call is bound by the tensor cores.
//
// Both paths: the TPU's sequential kv grid axis becomes a loop over
// 64-row key tiles inside the block, restricted to the band
// [max(0, q_lo - window + 1), q_hi]: tiles outside the causal / window
// band are never visited, so a windowed layer costs O(S W)
// structurally, not by masking.  Ragged S and T tails stage as zero rows
// and are masked by position, so no shape has to divide a tile; head
// dims up to 64, 128 and 256 are separate instantiations (columns past
// hd stage as zeros).  The tiles with the most keys start first.
//
// bfloat16 inputs (`flash_attention_mma_kernel`): one block of 8 warps
// per (128 query rows, query head, batch row), each warp owning 16 query
// rows.  The query tile and a two-stage ring of (K, V) tiles of 64 keys
// sit in shared memory as bfloat16 (rows padded by 16 bytes so the 8
// row addresses of an `ldmatrix` hit 8 bank groups): 198 KB at hd 256.
// `cp.async` fills key tile j + 1 while tile j computes.  q.k runs on
// the tensor cores (`mma.sync.m16n8k16` bf16 -> f32, fragments by
// `ldmatrix`; bf16 x bf16 products are exact in float32): each 16-wide
// k step goes to a fresh accumulator and is added to the scores in
// float32 on the CUDA cores, since a tensor-core accumulator chained
// over all of hd aligns each product to the large running sum and drops
// low bits that the float32 math keeps.  The 16 x 64
// score fragment stays in registers, where scale, softcap and the
// position mask apply and the row max and sum reduce across the quad
// by shuffles; P = 2^((s - m) log2 e).  p.v runs on the tensor cores
// too, 16 keys at a time, with P split in two: P_hi = bf16(P), P_lo =
// bf16(P - P_hi), two products into one float32 accumulator, so P is
// used to about 2^-17 of its value (one bf16 P would miss the same
// tolerance); the row sum l stays the float32 sum of the unrounded P.
// That is 1.5x the tensor-core work the bound counts.  The 16 x hd
// float32 O accumulator of a warp is 128 registers a thread at hd 256;
// Q's fragments are read from shared memory for each key tile rather
// than held, and P is made 16 keys at a time beside the p.v products
// that use it, so the scores, P and O fit the 255 registers (at hd 256
// ptxas still spills 32 bytes; hd 128 and 64 do not spill).  Left for a
// later version: `wgmma` with a TMA producer warp (mma.sync reaches
// about half of the tensor cores' rate) and one kv tile feeding the G
// query heads of a group.
//
// float32 inputs (`flash_attention_f32_kernel`) keep the CUDA-core
// version: tensor cores would need TF32 or a three-way split, which
// changes its numbers.  One block of 256 threads per (64 query rows,
// query head, batch row); the query, key and value tiles are staged in
// shared memory as float32 (rows padded by 4 floats); a 16 x 16 thread
// grid gives each thread 4 query rows (4 x 4 scores, 4 x hd/16
// accumulator columns in registers); the probability tile goes through
// shared memory to the p.v product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;      // a 16 x 16 thread grid over each tile
constexpr int kTile = 64;          // query rows and key rows of a tile
constexpr int kPad = 4;            // floats added to each staged row
constexpr int kPS = kTile + 4;     // row stride of the probability tile

// Stage rows [0, kTile) of a slice whose row r starts at src + r * ld
// (elements) into dst (row stride ds floats): rows at or past `rows` and
// columns at or past hd read as zeros.  hd is a whole number of 16-byte
// vectors and src is 16-byte aligned (the wrapper checks).
template <int HDP>
__device__ __forceinline__ void stage(float* dst, int ds, const float* src,
                                      long long ld, int rows, int hd) {
  constexpr int per_row = HDP / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < hd)
      f = __ldg(reinterpret_cast<const float4*>(src + r * ld + c));
    *reinterpret_cast<float4*>(dst + r * ds + c) = f;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out, int S, int T_len,
                               int H, int K, int hd, float scale,
                               float softcap, int window) {
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
  const float* qb = q + (static_cast<long long>(b) * S + q_lo) * q_ld +
                    static_cast<long long>(h) * hd;
  const float* kb = k + static_cast<long long>(b) * T_len * kv_ld +
                    static_cast<long long>(kh) * hd;
  const float* vb = v + static_cast<long long>(b) * T_len * kv_ld +
                    static_cast<long long>(kh) * hd;

  stage<HDP>(Qs, DS, qb, q_ld, S - q_lo, hd);

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
    stage<HDP>(Ks, DS, kb + k_lo * kv_ld, kv_ld, T_len - k_lo, hd);
    stage<HDP>(Vs, DS, vb + k_lo * kv_ld, kv_ld, T_len - k_lo, hd);
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
    float* orow = out + (static_cast<long long>(b) * S + qpos) * q_ld +
                  static_cast<long long>(h) * hd;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * g + e;
        if (col < hd) orow[col] = acc[i][4 * g + e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBQ = 16 * kMmaWarps;  // query rows of a block
constexpr int kBK = 64;              // keys of a tile
constexpr int kStages = 2;           // (K, V) tiles in the ring
constexpr int kRowPad = 8;           // bf16 added to each staged row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows [0, ROWS) of a slice whose row r starts at src + r * ld
// (elements) into dst (row stride RS) with cp.async: rows at or past
// `rows` and columns at or past hd are written as zeros.
template <int HDP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int rows, int hd) {
  constexpr int RS = HDP + kRowPad;
  constexpr int per_row = HDP / 8;
  for (int e = threadIdx.x; e < ROWS * per_row; e += kMmaThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 8;
    const bool ok = r < rows && c < hd;
    cp_async16(dst + r * RS + c, ok ? src + r * ld + c : src, ok ? 16 : 0);
  }
}

// kCap: softcap > 0 (its tanh is its own instantiation, so the
// registers the main path needs are not set by a branch it never takes)
template <int HDP, bool kCap>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ out, int S, int T_len,
                               int H, int K, int hd, float scale,
                               float softcap, int window) {
  constexpr int RS = HDP + kRowPad;  // row stride of the staged tiles
  constexpr int KS = HDP / 16;       // k steps of q.k, n-tile pairs of p.v
  constexpr int NT = HDP / 8;        // 8-column tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x RS
  bf16* ring = Qs + kBQ * RS;  // stage s: K at s * 2 kBK RS, V kBK RS on

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q_lo = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int h = static_cast<int>(blockIdx.x) % H;
  const int b = static_cast<int>(blockIdx.x) / H;
  const int kh = h / (H / K);
  const long long q_ld = static_cast<long long>(H) * hd;
  const long long kv_ld = static_cast<long long>(K) * hd;
  const bf16* qb = q + (static_cast<long long>(b) * S + q_lo) * q_ld +
                   static_cast<long long>(h) * hd;
  const bf16* kb = k + static_cast<long long>(b) * T_len * kv_ld +
                   static_cast<long long>(kh) * hd;
  const bf16* vb = v + static_cast<long long>(b) * T_len * kv_ld +
                   static_cast<long long>(kh) * hd;

  // the band of keys any row of this tile can see
  const int q_hi = min(q_lo + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_last = min(q_hi, T_len - 1);
  const int t_first = k_first / kBK;
  const int n_tiles = k_last >= k_first ? k_last / kBK - t_first + 1 : 0;

  auto load_kv = [&](int stage, int kt) {
    const int k_lo = kt * kBK;
    bf16* Ks = ring + stage * 2 * kBK * RS;
    load_tile<HDP, kBK>(Ks, kb + k_lo * kv_ld, kv_ld, T_len - k_lo, hd);
    load_tile<HDP, kBK>(Ks + kBK * RS, vb + k_lo * kv_ld, kv_ld,
                        T_len - k_lo, hd);
  };

  load_tile<HDP, kBQ>(Qs, qb, q_ld, S - q_lo, hd);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, t_first);
  cp_async_commit();

  // this thread's rows of the warp's 16: g and g + 8
  const int qpos[2] = {q_lo + warp * 16 + g, q_lo + warp * 16 + g + 8};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row / column of this lane within a 16 x 16 block
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;     // Q, V^T
  const int b_row = (lane & 7) + (lane >> 4) * 8;           // K
  const int b_col = ((lane >> 3) & 1) * 8;
  const bf16* q_frag = Qs + (warp * 16 + a_row) * RS + a_col;

  for (int it = 0; it < n_tiles; ++it) {
    const int k_lo = (t_first + it) * kBK;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, t_first + it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = ring + (it & 1) * 2 * kBK * RS;
    const bf16* Vs = Ks + kBK * RS;

    // s[j]: rows g / g + 8 x keys 8 j + 2 t, + 1 of this tile.  Each
    // 16-wide k step goes to a fresh accumulator and is added to s in
    // float32 on the CUDA cores: a tensor-core accumulator aligns every
    // product to the running sum, so chained over hd it drops low bits
    // of the scores that the float32 math keeps.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (np * 16 + b_row) * RS + kk * 16 + b_col);
        float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(f0, a, bk[0], bk[1]);
        mma_bf16(f1, a, bk[2], bk[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * np][e] += f0[e];
          s[2 * np + 1][e] += f1[e];
        }
      }
    }

    // scale, softcap, mask; the running max of rows g and g + 8
    const bool edge = k_lo + kBK - 1 > q_lo || k_lo + kBK > T_len ||
                      (window > 0 && k_lo <= q_lo + kBQ - 1 - window);
    unsigned visible = 0xffffffffu;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (kCap) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = kpos <= qp && kpos < T_len &&
                          (window <= 0 || kpos > qp - window);
          if (!ok) {
            visible &= ~(1u << (4 * j + e));
            x = kNegInf;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P_hi V + P_lo V, 16 keys (score tiles 2 kk, 2 kk + 1) at a
    // time: P = exp(s - m) split into bf16 hi + lo A fragments
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t p_hi[4], p_lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 2 * kk + h;
          float p[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c;
            p[c] = (visible >> (4 * j + e)) & 1u
                       ? exp2f((s[j][e] - m[r]) * kLog2e)
                       : 0.f;
            rs[r] += p[c];
          }
          const uint32_t hi = pack_bf16(p[0], p[1]);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&hi);
          // A fragment register: row half r, key half h
          p_hi[r + 2 * h] = hi;
          p_lo[r + 2 * h] =
              pack_bf16(p[0] - __low2float(hv), p[1] - __high2float(hv));
        }
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vs + (kk * 16 + a_row) * RS + dp * 16 + a_col);
        mma_bf16(o[2 * dp], p_hi, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], p_hi, bv[2], bv[3]);
        mma_bf16(o[2 * dp], p_lo, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], p_lo, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
      rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // nothing in flight at exit (no tile: Q only)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = out + (static_cast<long long>(b) * S + qpos[r]) * q_ld +
                 static_cast<long long>(h) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block, in bytes, for head dims padded to
// HDP (the wrapper computes the same numbers in
// repro_torch/kernels/flash_attention.py::shared_bytes).
size_t shared_bytes_f32(int HDP) {
  return sizeof(float) * (3 * static_cast<size_t>(kTile) * (HDP + kPad) +
                          static_cast<size_t>(kTile) * kPS);
}

size_t shared_bytes_bf16(int HDP) {
  return sizeof(bf16) * static_cast<size_t>(kBQ + kStages * 2 * kBK) *
         (HDP + kRowPad);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int HDP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int T_len, int H, int K,
                       int hd, float scale, float softcap, int window,
                       cudaStream_t stream) {
  const size_t smem = shared_bytes_f32(HDP);
  auto kernel = flash_attention_f32_kernel<HDP>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_len, H, K,
      hd, scale, softcap, window);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T_len, int H, int K,
                        int hd, float scale, float softcap, int window,
                        cudaStream_t stream) {
  const size_t smem = shared_bytes_bf16(HDP);
  auto kernel = softcap > 0.f ? flash_attention_mma_kernel<HDP, true>
                              : flash_attention_mma_kernel<HDP, false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  // x: (head, row) pairs, fastest, so the heaviest query tile of every
  // pair is handed out before any lighter one
  const dim3 grid(H * B, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T_len, H, K,
      hd, scale, softcap, window);
  return cudaGetLastError();
}

template <bool kBf16, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int K, int hd, float scale,
                   float softcap, int window, cudaStream_t stream) {
  return kBf16 ? launch_bf16<HDP>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                                  softcap, window, stream)
               : launch_f32<HDP>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                                 softcap, window, stream);
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_len, int H, int K, int hd,
                     float scale, float softcap, int window,
                     cudaStream_t stream) {
  if (hd <= 64)
    return launch<kBf16, 64>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                             softcap, window, stream);
  if (hd <= 128)
    return launch<kBf16, 128>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                              softcap, window, stream);
  return launch<kBf16, 256>(q, k, v, out, B, S, T_len, H, K, hd, scale,
                            softcap, window, stream);
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
  if (dtype == kF32 && hd % 4 == 0)
    return static_cast<int>(dispatch<false>(q, k, v, out, B, S, T, H, K, hd,
                                            scale, softcap, window, s));
  if (dtype == kBF16 && hd % 8 == 0)
    return static_cast<int>(dispatch<true>(q, k, v, out, B, S, T, H, K, hd,
                                           scale, softcap, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
