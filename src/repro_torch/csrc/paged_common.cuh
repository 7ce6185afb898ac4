// Device code shared by the two paged-attention kernels of this directory
// (paged_attention.cu: one query token a sequence; paged_extend_attention.cu:
// S query tokens a sequence and their causal suffix).  Both are one kernel,
// `paged_kernel`, instantiated without (decode) and with (extend) the
// suffix; the .cu files hold the header notes, the launch checks and the
// C entry points.
//
// The kernel, for one (row tile, kv head kh, sequence b, split) block of 128
// threads:
//
// * Rows.  The R = G * S query rows of the kv head's group (row r = s * G +
//   g reads q[b, s, kh * G + g]) are cut into tiles of `rows` (at most 64,
//   the host's plan; decode has one tile of G rows).  A block stages its
//   tile's rows once as float in shared memory, with a float accumulator
//   beside them, so its shared memory does not grow with S; each scoring
//   pass loads its rows' slices into registers.
// * Split.  The block owns table entries [split * pages, + pages) of row b,
//   clipped to the entries below the row's limit (its length for decode,
//   pos for extend).  A split with nothing to read writes an empty partial
//   (m = -1e30, l = 0) and goes straight to the arrival count.
// * Staging.  The split's pages are read `chunk` pages at a time, in a ring
//   of one or two stages: the K and V rows of this kv head (and the int8
//   row scales) go to shared memory in the pool's own type by 16-byte
//   `cp.async.cg` copies (4-byte `cp.async.ca` for the scales).  Both
//   stages are issued before the first wait, so one memory latency covers
//   a split of up to two chunks; a longer split reloads a stage as soon as
//   its chunk has been used.  Slots of -1 table entries, positions at or
//   past the limit and padding are zero-filled (the copy reads no byte), so
//   nothing past a row's keys is dereferenced and no stale value reaches a
//   product.  The extend read's last split then streams the causal suffix
//   through the same ring, 16 keys a stage in q's type: only the keys t <=
//   s of the tile's last token s, so no block holds more than a 16-key
//   tile of the suffix.
// * Scores, softmax, P.V in block steps (CUDA cores, or tensor cores
//   where the by-warp path below does not apply).  Scores: on the CUDA
//   cores a team of lanes (a power of two, up to 32, each lane 16 bytes of
//   the row) takes one key and holds its rows' slices of q in registers,
//   four rows a pass, reducing across the team by shuffles; on the tensor
//   cores (bf16 queries over bf16 or int8 pages, hd a multiple of 16)
//   `mma.sync.m16n8k16` takes Q's fragments from shared memory and K's
//   from the staged rows (int8 bytes turn into bf16 exactly), each 16-wide
//   k step into a fresh fragment added in float32, so the scores keep the
//   float32 math's low bits.  The dequantization is folded out of the
//   inner loops: s = scale * ks_t * (q . kq_t); softcap and mask follow.
//   Softmax: one warp a row: the chunk's max, the online rescale factor,
//   p = exp(s - m) and the row sum l (float32); p is stored times the V
//   row scale vs_t, which thus multiplies p before the product with vq_t.
//   P.V: on the CUDA cores each thread owns groups of 4 output columns of
//   a row; on the tensor cores each warp owns 8-column tiles of O, with P
//   split into bf16 hi + lo (two products into one float32 accumulator)
//   so P is used to about 2^-17 of its value.  O stays in shared memory
//   as float32 across chunks; three barriers a chunk.
// * By warp (tensor cores, a tile of <= 16 rows, hd <= 128, a split of
//   several chunks): each warp takes its own 16-key groups of every chunk
//   and keeps an online softmax of its own, m, l and the 16 x hd
//   accumulator in registers; the score fragments of a group are the A
//   fragment of its p.v (P never leaves registers), V's fragments come by
//   `ldmatrix.trans`, and a byte mask written with the copies says which
//   slots hold keys.  No barrier within a chunk; the four warps are merged
//   in warp order once, at the end.
// * Merge.  Unsplit (one split), the block writes acc / max(l, 1e-30).
//   Split, it writes its tile's partials (m, l, acc[hd]) per row to a
//   float32 workspace, then counts its arrival on the (b, kh, row tile)
//   counter; the last block to arrive merges the tile's partials in split
//   order (empty ones weigh nothing) from shared-memory weights, several
//   float4 loads of the partials in flight a thread, writes the output and
//   resets the counter.  The result is bitwise repeatable, and a row with
//   no visible key is 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace paged {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kRowGroup = 4;           // query rows a scoring pass holds
constexpr int kMaxNTiles = kMaxHeadDim / 8 / kWarps;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// arguments and shared-memory layout
// ---------------------------------------------------------------------------

struct Args {
  const void* q;            // (B, S, H, hd) TQ; S = 1 for decode
  const void* k_pages;      // (nB, bs, K, hd) TP
  const void* v_pages;
  const float* k_scale;     // (nB, bs, K) for int8 pages, else null
  const float* v_scale;
  const void* k_new;        // (B, S, K, hd) TQ: the extend suffix
  const void* v_new;
  const int32_t* tables;    // (B, n_blk), -1 = unallocated
  const int32_t* limit;     // (B,): lengths (decode) or pos (extend)
  void* out;                // (B, S, H, hd) TQ
  float* ws;                // partials of a split launch
  unsigned* counters;       // B * K * tiles arrival counters (split launch)
  int S, H, K, hd, bs, n_blk;
  int rows, splits, pages, chunk, stages, mma;  // the host's plan
  float scale, softcap;
};

constexpr int kSfxTile = 16;  // suffix keys a stage holds

// Byte offsets of a block's dynamic shared memory.  The wrappers'
// `smem_bytes` computes the same total, and the launch refuses a plan
// whose size differs.
struct Layout {
  int nkp;      // key slots of a staged chunk (chunk * bs, to 16 for mma)
  int rsb;      // bytes of a staged page row (padded by 16 for mma)
  int xsb;      // bytes of a staged suffix row, q's type (0 for decode)
  int half;     // bytes of a stage's K (or V) half
  int pw;       // floats of a score row
  // byte offsets of q, o, p, the int8 scales, the row statistics, and on
  // the tensor cores the warps' (m, l) of 16 rows and the chunk slots' key
  // mask (the ring starts at 0), and the total
  size_t q, o, p, sc, st, wm, vk, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// R: the rows of a tile (the plan's `rows`)
__host__ __device__ inline Layout layout(int R, int hd, int bs, int chunk,
                                         int stages, int page_elt, int q_elt,
                                         bool suffix, bool mma) {
  Layout L;
  L.nkp = mma ? round16(chunk * bs) : chunk * bs;
  L.rsb = hd * page_elt + (mma ? 16 : 0);
  L.xsb = suffix ? hd * q_elt + (mma ? 16 : 0) : 0;
  const int kb = L.nkp * L.rsb, xb = kSfxTile * L.xsb;
  L.half = kb > xb ? kb : xb;
  const int keys = suffix && kSfxTile > L.nkp ? kSfxTile : L.nkp;
  L.pw = keys + (mma ? 4 : 0);
  L.q = static_cast<size_t>(stages) * 2 * L.half;
  L.o = L.q + static_cast<size_t>(R) * hd * 4;
  L.p = L.o + static_cast<size_t>(R) * hd * 4;
  L.sc = L.p + static_cast<size_t>(R) * L.pw * 4;
  L.st = L.sc + (page_elt == 1 ? static_cast<size_t>(stages) * 2 * L.nkp * 4
                               : 0);
  L.wm = L.st + static_cast<size_t>(3) * R * 4;
  L.vk = L.wm + (mma ? kWarps * 16 * 2 * 4 : 0);
  L.total = L.vk + (mma ? round16(stages * L.nkp) : 0);
  return L;
}

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of a staged row -> 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
// the two bf16 halves of a 32-bit word as floats (a bf16 is the top half
// of a float's bits); no address is taken, so nothing goes to the stack
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load16(const bf16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = bf16_lo(w[i]);
    o[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* o) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
}

// 4 consecutive elements of a staged row -> floats
__device__ __forceinline__ void load4(const float* p, float* o) {
  load16(p, o);
}
__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = bf16_lo(v.x);
  o[1] = bf16_hi(v.x);
  o[2] = bf16_lo(v.y);
  o[3] = bf16_hi(v.y);
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// elements d, d + 1 of a staged row as a bf16 pair (exact for bf16, int8
// and the bf16 values of a float-staged bf16 suffix)
__device__ __forceinline__ uint32_t pair(const bf16* row, int d) {
  return *reinterpret_cast<const uint32_t*>(row + d);
}
__device__ __forceinline__ uint32_t pair(const int8_t* row, int d) {
  return pack_bf16(row[d], row[d + 1]);
}
__device__ __forceinline__ uint32_t pair(const float* row, int d) {
  const float2 v = *reinterpret_cast<const float2*>(row + d);
  return pack_bf16(v.x, v.y);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// cp.async and mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; n = 0 writes zeros, reads none
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// the steps of a chunk
// ---------------------------------------------------------------------------

// The suffix's causal rule for a staged tile: slot t (suffix key key0 + t)
// is visible to tile row r (query row row0 + r, token (row0 + r) / g) when
// key0 + t <= (row0 + r) / g; g = 0 (a context chunk) sees every slot.
struct Causal {
  int g, key0, row0;
  __device__ __forceinline__ bool ok(int t, int r) const {
    return g == 0 || key0 + t <= (row0 + r) / g;
  }
};


// Score of query row r against key slot t of a staged chunk (rows of
// `ld` elements of type TS from `keys`): cap(scale * ks[t] * (q_r . k_t)),
// or kNegInf where the slot holds no key (!key_ok(t)) or the causal rule
// `cz` hides it (the suffix); into p[r * pw + t] for t < nk.
// CUDA cores: teams of lanes over the row, four query rows a pass.
template <typename TS, typename KeyOk>
__device__ __forceinline__ void scores_cuda(const float* q_s, int R, int hd,
                                            const TS* keys, int ld, int nk,
                                            const float* ks, float* p,
                                            int pw, float scale,
                                            float softcap, KeyOk key_ok,
                                            Causal cz) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TS));
  constexpr int VPL = sizeof(TS) == 4 ? 2 : 1;  // vectors a lane, hd <= 256
  const int nv = hd / VEC;
  int tl = 1;
  while (tl < nv && tl < 32) tl <<= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / tl;
  const int team = lane / tl, tlane = lane - team * tl;
  for (int r0 = 0; r0 < R; r0 += kRowGroup) {
    float qr[kRowGroup][VPL][VEC];
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i)
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = tlane + v * tl;
        const bool ok = r0 + i < R && vi < nv;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[i][v][e] = ok ? q_s[(r0 + i) * hd + vi * VEC + e] : 0.f;
      }
    // every lane of a warp runs the same trips, so the shuffles are whole
    for (int base = warp * per_warp; base < nk; base += kWarps * per_warp) {
      const int t = base + team;
      float kf[VPL][VEC];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = tlane + v * tl;
        if (t < nk && vi < nv) {
          load16(keys + static_cast<size_t>(t) * ld + vi * VEC, kf[v]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[v][e] = 0.f;
        }
      }
      const float kscale = scale * (ks != nullptr && t < nk ? ks[t] : 1.f);
      const bool kv = t < nk && key_ok(t);
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(qr[i][v][e], kf[v][e], part);
        for (int o = tl >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(kFull, part, o);
        const int r = r0 + i;
        if (tlane == 0 && t < nk && r < R) {
          float s = part * kscale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          const bool ok = kv && cz.ok(t, r);
          p[r * pw + t] = ok ? s : kNegInf;
        }
      }
    }
  }
}

// The same scores on the tensor cores: rows in 16-row tiles, keys in
// 8-key tiles over the warps, nkp (a multiple of 16) slots of which the
// first nk may hold keys.  hd is a multiple of 16.
template <typename TS, typename KeyOk>
__device__ __forceinline__ void scores_mma(const float* q_s, int R, int hd,
                                           const TS* keys, int ld, int nk,
                                           int nkp, const float* ks,
                                           float* p, int pw, float scale,
                                           float softcap, KeyOk key_ok,
                                           Causal cz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int m0 = 0; m0 < R; m0 += 16) {
    const int r0 = m0 + g, r1 = m0 + g + 8;
    // this lane's Q rows (zero past R), read as bf16 pairs per k step
    const float* q0 = q_s + min(r0, R - 1) * hd + 2 * t4;
    const float* q1 = q_s + min(r1, R - 1) * hd + 2 * t4;
    const bool in0 = r0 < R, in1 = r1 < R;
    for (int nt = warp; nt * 8 < nkp; nt += kWarps) {
      const TS* krow = keys + static_cast<size_t>(nt * 8 + g) * ld;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < hd; d += 16) {
        const float2 x0 = *reinterpret_cast<const float2*>(q0 + d);
        const float2 x1 = *reinterpret_cast<const float2*>(q1 + d);
        const float2 y0 = *reinterpret_cast<const float2*>(q0 + d + 8);
        const float2 y1 = *reinterpret_cast<const float2*>(q1 + d + 8);
        const uint32_t a[4] = {in0 ? pack_bf16(x0.x, x0.y) : 0u,
                               in1 ? pack_bf16(x1.x, x1.y) : 0u,
                               in0 ? pack_bf16(y0.x, y0.y) : 0u,
                               in1 ? pack_bf16(y1.x, y1.y) : 0u};
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(f, a, pair(krow, d + 2 * t4), pair(krow, d + 2 * t4 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += f[e];
      }
      const int t0 = nt * 8 + 2 * t4;
      const bool kv[2] = {t0 < nk && key_ok(t0), t0 + 1 < nk && key_ok(t0 + 1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        const int t = t0 + (e & 1);
        if (r >= R) continue;
        float x = s[e] * scale * (ks != nullptr ? ks[t] : 1.f);
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kv[e & 1] && cz.ok(t, r);
        p[r * pw + t] = ok ? x : kNegInf;
      }
    }
  }
}

// Online-softmax step of every row over the chunk's nk scores (one warp a
// row): the running max m, the rescale factor a of the accumulator, the
// denominator l += sum p; p = exp(s - m) is stored times vs[t] (the V row
// scale, when given) and slots [nk, nkp) are set to 0.
__device__ __forceinline__ void softmax_step(float* p, int pw, int R, int nk,
                                             int nkp, const float* vs,
                                             float* m_s, float* l_s,
                                             float* a_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    float* pr = p + r * pw;
    float mx = kNegInf;
    for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < nkp; t += 32) {
      float e = 0.f;
      if (t < nk && pr[t] > kNegInf) e = expf(pr[t] - m_new);
      sum += e;
      pr[t] = vs != nullptr && t < nk ? e * vs[t] : e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      a_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
    }
  }
}

// o = o * a + p @ v over the chunk's nk slots (rows of `ld` elements of
// type TS from `vals`).  CUDA cores: a thread owns groups of 4 columns.
template <typename TS>
__device__ __forceinline__ void pv_cuda(const float* p, int pw, int R, int hd,
                                        int nk, const TS* vals, int ld,
                                        const float* a_s, float* o_s) {
  const int groups = hd / 4;
  for (int i = threadIdx.x; i < R * groups; i += kThreads) {
    const int r = i / groups;
    const int c = (i - r * groups) * 4;
    const float alpha = a_s[r];
    float* o = o_s + r * hd + c;
    float acc[4] = {o[0] * alpha, o[1] * alpha, o[2] * alpha, o[3] * alpha};
    const float* pr = p + r * pw;
#pragma unroll 4
    for (int t = 0; t < nk; ++t) {
      float v[4];
      load4(vals + static_cast<size_t>(t) * ld + c, v);
      const float pt = pr[t];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(pt, v[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = acc[e];
  }
}

// The same on the tensor cores over nkp slots (a multiple of 16): each
// warp owns 8-column tiles of O; P = p_hi + p_lo in bf16.
template <typename TS>
__device__ __forceinline__ void pv_mma(const float* p, int pw, int R, int hd,
                                       int nkp, const TS* vals, int ld,
                                       const float* a_s, float* o_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_cols = hd / 8;
  for (int m0 = 0; m0 < R; m0 += 16) {
    const int r0 = m0 + g, r1 = m0 + g + 8;
    const float a0 = r0 < R ? a_s[r0] : 0.f, a1 = r1 < R ? a_s[r1] : 0.f;
    float c[kMaxNTiles][4];
#pragma unroll
    for (int i = 0; i < kMaxNTiles; ++i) {
      const int col = (warp + i * kWarps) * 8 + 2 * t4;
      const bool ok = warp + i * kWarps < n_cols;
      c[i][0] = ok && r0 < R ? o_s[r0 * hd + col] * a0 : 0.f;
      c[i][1] = ok && r0 < R ? o_s[r0 * hd + col + 1] * a0 : 0.f;
      c[i][2] = ok && r1 < R ? o_s[r1 * hd + col] * a1 : 0.f;
      c[i][3] = ok && r1 < R ? o_s[r1 * hd + col + 1] * a1 : 0.f;
    }
    for (int k0 = 0; k0 < nkp; k0 += 16) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = (j & 1) ? r1 : r0;
        const int t = k0 + 2 * t4 + (j >= 2 ? 8 : 0);
        const float x0 = r < R ? p[r * pw + t] : 0.f;
        const float x1 = r < R ? p[r * pw + t + 1] : 0.f;
        hi[j] = pack_bf16(x0, x1);
        lo[j] = pack_bf16(x0 - bf16_lo(hi[j]), x1 - bf16_hi(hi[j]));
      }
      const TS* v0 = vals + static_cast<size_t>(k0 + 2 * t4) * ld;
#pragma unroll
      for (int i = 0; i < kMaxNTiles; ++i) {
        const int col = (warp + i * kWarps) * 8 + g;
        if (warp + i * kWarps >= n_cols) continue;
        // b0 = v[k0 + 2 t4 (+1)][col], b1 = v[k0 + 2 t4 + 8 (+1)][col]
        const uint32_t b0 = pack_bf16(to_float(v0[col]), to_float(v0[ld + col]));
        const uint32_t b1 = pack_bf16(to_float(v0[8 * ld + col]),
                                      to_float(v0[9 * ld + col]));
        mma_bf16(c[i], hi, b0, b1);
        mma_bf16(c[i], lo, b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxNTiles; ++i) {
      const int col = (warp + i * kWarps) * 8 + 2 * t4;
      if (warp + i * kWarps >= n_cols) continue;
      if (r0 < R) {
        o_s[r0 * hd + col] = c[i][0];
        o_s[r0 * hd + col + 1] = c[i][1];
      }
      if (r1 < R) {
        o_s[r1 * hd + col] = c[i][2];
        o_s[r1 * hd + col + 1] = c[i][3];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor cores, each warp on its own 16-key groups (R <= 16, hd <= 128)
// ---------------------------------------------------------------------------

constexpr int kWarpTiles = 128 / 8;  // 8-column tiles of O a warp holds

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// One warp's online softmax over the key groups it has taken: the running
// max m and sum l of this lane's rows g and g + 8 of the 16-row tile, and
// the warp's 16 x hd accumulator as mma fragments (o[nt]: columns 8 nt +
// 2 t4, + 1 of rows g, g + 8).
struct WarpAcc {
  float m[2], l[2];
  float o[kWarpTiles][4];
};

// One warp's step over key slots [k0, k0 + 16) of a staged chunk (rows of
// `ld` elements of type TS: keys, vals; the first nk slots may hold keys,
// key_ok and cz as for scores_cuda; ks / vs the int8 row scales or
// null): scores on the tensor cores, each k step into a fresh fragment;
// the online-softmax update in registers; P (times vs) split into bf16 hi
// + lo as the A fragment of the p.v product, so P never leaves registers;
// V's fragments by `ldmatrix.trans` (bf16) or by element.  No barrier.
template <typename TS, typename KeyOk>
__device__ __forceinline__ void warp_group(WarpAcc& w, const float* q_s,
                                           int R, int hd, const TS* keys,
                                           const TS* vals, int ld, int k0,
                                           int nk, const float* ks,
                                           const float* vs, float scale,
                                           float softcap, KeyOk key_ok,
                                           Causal cz) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r[2] = {g, g + 8};
  const float* q0 = q_s + min(r[0], R - 1) * hd + 2 * t4;
  const float* q1 = q_s + min(r[1], R - 1) * hd + 2 * t4;
  const bool in0 = r[0] < R, in1 = r[1] < R;
  const TS* kr0 = keys + static_cast<size_t>(k0 + g) * ld;
  const TS* kr1 = kr0 + 8 * static_cast<size_t>(ld);
  // the last slot each of rows g, g + 8 sees under the causal rule
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = cz.g == 0 ? 0x7fffffff : (cz.row0 + r[h]) / cz.g - cz.key0;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < hd; d += 16) {
    const float2 x0 = *reinterpret_cast<const float2*>(q0 + d);
    const float2 x1 = *reinterpret_cast<const float2*>(q1 + d);
    const float2 y0 = *reinterpret_cast<const float2*>(q0 + d + 8);
    const float2 y1 = *reinterpret_cast<const float2*>(q1 + d + 8);
    const uint32_t a[4] = {in0 ? pack_bf16(x0.x, x0.y) : 0u,
                           in1 ? pack_bf16(x1.x, x1.y) : 0u,
                           in0 ? pack_bf16(y0.x, y0.y) : 0u,
                           in1 ? pack_bf16(y1.x, y1.y) : 0u};
    float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(f0, a, pair(kr0, d + 2 * t4), pair(kr0, d + 2 * t4 + 8));
    mma_bf16(f1, a, pair(kr1, d + 2 * t4), pair(kr1, d + 2 * t4 + 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] += f0[e];
      s[1][e] += f1[e];
    }
  }

  // scale, softcap, mask; the new running max of rows g, g + 8
  float mx[2] = {w.m[0], w.m[1]};
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = k0 + 8 * j + 2 * t4 + c;
      const bool kv = t < nk && key_ok(t);
      const float kscale = scale * (ks != nullptr ? ks[t] : 1.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + c;
        float x = s[j][e] * kscale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool v =
            kv && r[h] < R && t <= lim[h];
        ok |= static_cast<unsigned>(v) << (4 * j + e);
        s[j][e] = x;
        if (v) mx[h] = fmaxf(mx[h], x);
      }
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = expf(w.m[h] - mx[h]);
    w.m[h] = mx[h];
  }

  // p = exp(s - m) (0 where masked), the row sums, P (times vs) in bf16
  // hi + lo: the score fragments of keys 0-7 and 8-15 are the A fragment
  float rs[2] = {0.f, 0.f};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * h + c;
        const float p =
            (ok >> (4 * j + e)) & 1u ? expf(s[j][e] - w.m[h]) : 0.f;
        rs[h] += p;
        pv[c] = vs != nullptr ? p * vs[k0 + 8 * j + 2 * t4 + c] : p;
      }
      hi[2 * j + h] = pack_bf16(pv[0], pv[1]);
      lo[2 * j + h] = pack_bf16(pv[0] - bf16_lo(hi[2 * j + h]),
                                pv[1] - bf16_hi(hi[2 * j + h]));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) w.l[h] = w.l[h] * alpha[h] + quad_sum(rs[h]);

  // o = o * alpha + P V
  const int n_tiles = hd / 8;
#pragma unroll
  for (int nt = 0; nt < kWarpTiles; ++nt) {
    w.o[nt][0] *= alpha[0];
    w.o[nt][1] *= alpha[0];
    w.o[nt][2] *= alpha[1];
    w.o[nt][3] *= alpha[1];
  }
  if constexpr (std::is_same<TS, bf16>::value) {
    const bf16* vrow = vals + static_cast<size_t>(k0 + (lane & 15)) * ld +
                       (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < kWarpTiles / 2; ++dp) {
      if (2 * dp >= n_tiles) break;
      uint32_t bv[4];
      ldsm_x4_trans(bv, vrow + dp * 16);
      mma_bf16(w.o[2 * dp], hi, bv[0], bv[1]);
      mma_bf16(w.o[2 * dp + 1], hi, bv[2], bv[3]);
      mma_bf16(w.o[2 * dp], lo, bv[0], bv[1]);
      mma_bf16(w.o[2 * dp + 1], lo, bv[2], bv[3]);
    }
  } else {
    // b0 = v[k0 + 2 t4 (+1)][col], b1 = v[k0 + 2 t4 + 8 (+1)][col]
    const TS* v0 = vals + static_cast<size_t>(k0 + 2 * t4) * ld + g;
#pragma unroll
    for (int nt = 0; nt < kWarpTiles; ++nt) {
      if (nt >= n_tiles) break;
      const TS* v = v0 + nt * 8;
      const uint32_t b0 = pack_bf16(to_float(v[0]), to_float(v[ld]));
      const uint32_t b1 =
          pack_bf16(to_float(v[8 * ld]), to_float(v[9 * ld]));
      mma_bf16(w.o[nt], hi, b0, b1);
      mma_bf16(w.o[nt], lo, b0, b1);
    }
  }
}

// Merge the warps' accumulators into the block's o_s, m_s, l_s (rows < R)
// in warp order: each row's max M over the warps, each warp's weight
// exp(m - M), L = sum l * weight; o_s = sum weight * o, one warp after the
// other (each warp loads all it adds to before it stores any).  wm holds
// (m, l) of 16 rows a warp.  Ends synchronised.
__device__ __forceinline__ void merge_warps(const WarpAcc& w, int R, int hd,
                                            float* wm, float* o_s,
                                            float* m_s, float* l_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wm[(warp * 16 + g + 8 * h) * 2] = w.m[h];
      wm[(warp * 16 + g + 8 * h) * 2 + 1] = w.l[h];
    }
  }
  __syncthreads();
  float weight[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    float mx = kNegInf;
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, wm[(v * 16 + row) * 2]);
    float l = 0.f;
    for (int v = 0; v < kWarps; ++v)
      l = fmaf(wm[(v * 16 + row) * 2 + 1],
               expf(wm[(v * 16 + row) * 2] - mx), l);
    weight[h] = expf(w.m[h] - mx);
    if (warp == 0 && t4 == 0 && row < R) {
      m_s[row] = mx;
      l_s[row] = l;
    }
  }
  const int n_tiles = hd / 8;
  for (int v = 0; v < kWarps; ++v) {
    if (warp == v) {
      float sum[kWarpTiles][4];
#pragma unroll
      for (int nt = 0; nt < kWarpTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1);
          const int at = row * hd + nt * 8 + 2 * t4 + (e & 1);
          sum[nt][e] = weight[e >> 1] * w.o[nt][e];
          if (v > 0 && nt < n_tiles && row < R) sum[nt][e] += o_s[at];
        }
#pragma unroll
      for (int nt = 0; nt < kWarpTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1);
          if (nt < n_tiles && row < R)
            o_s[row * hd + nt * 8 + 2 * t4 + (e & 1)] = sum[nt][e];
        }
    }
    __syncthreads();
  }
}

// slot t of a staged chunk holds a key: the byte the copies wrote
struct MaskKeys {
  const unsigned char* mask;
  __device__ __forceinline__ bool operator()(int t) const {
    return mask[t] != 0;
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Slot t of a staged chunk (table entries [j0, j1), bs slots each) holds
// a key: its page is allocated and its position below the row's limit.
struct ChunkKeys {
  const int32_t* table;
  int j0, j1, bs, limit;
  __device__ __forceinline__ bool operator()(int t) const {
    const int jj = t / bs;
    const int j = j0 + jj;
    return j < j1 && __ldg(table + j) >= 0 && j * bs + (t - jj * bs) < limit;
  }
};

// every staged suffix row holds a key (the causal rule is separate)
struct AllKeys {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// Issue the copies of one chunk: the K and V rows (kv head kh) of the
// slots of table entries [j0, j1) into ks / vs (rows of ld elements), the
// int8 row scales into sk (K) and sk + nkp (V), whether each slot holds a
// key into mask (when given); slots that hold no key, and the chunk's
// slots past j1, are zero-filled and read nothing.  The
// threads take one 16-byte vector of a row each, kThreads / nvec rows a
// pass, so the loop divides by nothing.
template <typename TP>
__device__ __forceinline__ void issue_chunk(
    const TP* kp, const TP* vp, const float* k_scale, const float* v_scale,
    const int32_t* table, int K, int hd, int bs, int kh, int j0, int j1,
    int limit, int nkp, int ld, TP* ks, TP* vs, float* sk,
    unsigned char* mask) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TP));
  const int nvec = hd / VEC;
  const int per_pass = kThreads / nvec;
  if (static_cast<int>(threadIdx.x) < per_pass * nvec) {
    const int off = (threadIdx.x % nvec) * VEC;
    int t = threadIdx.x / nvec;
    int jj = t / bs, o = t - jj * bs;  // slot t: chunk entry jj, offset o
    for (; t < nkp; t += per_pass) {
      const int j = j0 + jj;
      const int page = j < j1 ? __ldg(table + j) : -1;
      const bool ok = page >= 0 && j * bs + o < limit;
      const size_t row =
          ok ? (static_cast<size_t>(page) * bs + o) * K + kh : 0;
      cp_async16(ks + static_cast<size_t>(t) * ld + off, kp + row * hd + off,
                 ok ? 16 : 0);
      cp_async16(vs + static_cast<size_t>(t) * ld + off, vp + row * hd + off,
                 ok ? 16 : 0);
      if (mask != nullptr && off == 0) mask[t] = ok;
      for (o += per_pass; o >= bs; o -= bs) ++jj;
    }
  }
  if (sizeof(TP) == 1) {
    for (int u = threadIdx.x; u < nkp; u += kThreads) {
      const int ju = u / bs;
      const int j = j0 + ju;
      const int page = j < j1 ? __ldg(table + j) : -1;
      const bool ok = page >= 0 && j * bs + (u - ju * bs) < limit;
      const size_t row =
          ok ? (static_cast<size_t>(page) * bs + (u - ju * bs)) * K + kh : 0;
      cp_async4(sk + u, k_scale + row, ok ? 4 : 0);
      cp_async4(sk + nkp + u, v_scale + row, ok ? 4 : 0);
    }
  }
}

// Issue the copies of one suffix tile: k_new / v_new[b, key0 + t, kh, :]
// (rows of hd elements of q's type TQ) for t < kSfxTile into kx / vx (rows
// of ld elements); keys at or past n (the tile's last visible key + 1) are
// zero-filled and read nothing.
template <typename TQ>
__device__ __forceinline__ void issue_suffix(const TQ* kn, const TQ* vn,
                                             int b, int S, int K, int hd,
                                             int kh, int key0, int n, int ld,
                                             TQ* kx, TQ* vx) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TQ));
  const int nvec = hd / VEC;
  for (int i = threadIdx.x; i < kSfxTile * nvec; i += kThreads) {
    const int t = i / nvec;
    const int off = (i - t * nvec) * VEC;
    const bool ok = key0 + t < n;
    const size_t src =
        ok ? ((static_cast<size_t>(b) * S + key0 + t) * K + kh) * hd + off : 0;
    cp_async16(kx + static_cast<size_t>(t) * ld + off, kn + src, ok ? 16 : 0);
    cp_async16(vx + static_cast<size_t>(t) * ld + off, vn + src, ok ? 16 : 0);
  }
}


// tensor cores take bf16 queries over bf16 or int8 pages
template <typename TQ, typename TP>
constexpr bool kMmaTypes = std::is_same<TQ, bf16>::value && sizeof(TP) <= 2;

// kMma: scores and p.v on the tensor cores; kWarp: by warp_group (one
// 16-row tile of hd <= 128: each warp on its own key groups, no barrier
// within a chunk, the warps merged once at the end), else in block steps.
// Each path is its own instantiation, so no path's registers count
// against another's.  The warp path keeps three blocks an SM (at most 170
// registers: a long row's splits fill the card in one round); the others
// may take up to 255 registers, so none of them spills.
template <typename TQ, typename TP, bool kSuffix, bool kMma, bool kWarp>
__global__ void __launch_bounds__(kThreads, kWarp ? 3 : 1)
    paged_kernel(const Args a) {
  static_assert(!kMma || kMmaTypes<TQ, TP>, "tensor cores take bf16 q");
  static_assert(!kWarp || kMma, "the warp path runs on the tensor cores");
  constexpr bool kI8 = std::is_same<TP, int8_t>::value;
  constexpr bool mma = kMma;
  const int G = a.H / a.K, S = a.S, R_all = G * S, hd = a.hd, bs = a.bs;
  const int tiles = (R_all + a.rows - 1) / a.rows;
  const int kh = blockIdx.x / tiles, rt = blockIdx.x - kh * tiles;
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  // this block's rows: [r0, r0 + R) of the R_all rows of (b, kh)
  const int r0 = rt * a.rows;
  const int R = min(a.rows, R_all - r0);
  const Layout L = layout(a.rows, hd, bs, a.chunk, a.stages,
                          static_cast<int>(sizeof(TP)),
                          static_cast<int>(sizeof(TQ)), kSuffix, mma);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);  // (R, hd) queries
  float* o_s = reinterpret_cast<float*>(smem + L.o);  // (R, hd) accumulator
  float* p_s = reinterpret_cast<float*>(smem + L.p);  // (R, pw) scores / p
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);  // int8 row scales
  float* m_s = reinterpret_cast<float*>(smem + L.st);   // (R,) running max
  float* l_s = m_s + a.rows;                            // (R,) denominator
  float* a_s = l_s + a.rows;                            // (R,) rescale
  __shared__ bool last;
  unsigned char* vk_s = smem + L.vk;  // (stages, nkp) key mask (mma)
  constexpr bool by_warp = kWarp;
  WarpAcc acc;
  acc.m[0] = acc.m[1] = kNegInf;
  acc.l[0] = acc.l[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kWarpTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[nt][e] = 0.f;

  const int limit = a.limit[b];
  const int n_used = limit <= 0 ? 0 : min((limit + bs - 1) / bs, a.n_blk);
  const int j_begin = split * a.pages;
  const int j_end = min(j_begin + a.pages, n_used);
  const int n_chunks =
      j_end > j_begin ? (j_end - j_begin + a.chunk - 1) / a.chunk : 0;
  const bool has_suffix = kSuffix && split == a.splits - 1;
  // the suffix keys the tile sees: t <= s of its last token s
  const int n_sfx = has_suffix ? min(S, (r0 + R - 1) / G + 1) : 0;
  const int n_steps = n_chunks + (n_sfx + kSfxTile - 1) / kSfxTile;
  const bool empty = n_steps == 0;
  const int32_t* table = a.tables + static_cast<size_t>(b) * a.n_blk;
  const int ld = L.rsb / static_cast<int>(sizeof(TP));  // staged row, elts
  const int ldx = L.xsb / static_cast<int>(sizeof(TQ));  // suffix row, elts
  // query / output row r = s * G + g: (b, s, kh * G + g, :)
  const int H = a.H;
  const size_t row0 = static_cast<size_t>(b) * S * H + kh * G;
  auto row_at = [row0, G, H](int r) {
    const int s = r / G;
    return row0 + static_cast<size_t>(s) * H + (r - s * G);
  };

  const TP* kp = static_cast<const TP*>(a.k_pages);
  const TP* vp = static_cast<const TP*>(a.v_pages);
  const TQ* kn = static_cast<const TQ*>(a.k_new);
  const TQ* vn = static_cast<const TQ*>(a.v_new);
  const float* k_scale = a.k_scale;
  const float* v_scale = a.v_scale;
  const int K = a.K, chunk = a.chunk, nkp = L.nkp, half = L.half;
  // step c < n_chunks stages chunk c of the split, a later step the
  // suffix tile c - n_chunks; stage st holds K at 2 st half, V after it
  auto issue = [=](int c, int st) {
    unsigned char* base = smem + static_cast<size_t>(2 * st) * half;
    if (c < n_chunks) {
      const int j0 = j_begin + c * chunk;
      issue_chunk<TP>(kp, vp, k_scale, v_scale, table, K, hd, bs, kh, j0,
                      min(j0 + chunk, j_end), limit, nkp, ld,
                      reinterpret_cast<TP*>(base),
                      reinterpret_cast<TP*>(base + half), sc_s + 2 * st * nkp,
                      mma ? vk_s + st * nkp : nullptr);
    } else if constexpr (kSuffix) {
      issue_suffix<TQ>(kn, vn, b, S, K, hd, kh, (c - n_chunks) * kSfxTile,
                       n_sfx, ldx, reinterpret_cast<TQ*>(base),
                       reinterpret_cast<TQ*>(base + half));
    }
  };

  if (!empty) {
    const TQ* q = static_cast<const TQ*>(a.q);
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd;
      q_s[i] = to_float(q[row_at(r0 + r) * hd + (i - r * hd)]);
      o_s[i] = 0.f;
    }
    for (int r = tid; r < R; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
    for (int c = 0; c < a.stages && c < n_steps; ++c) {
      issue(c, c);
      cp_async_commit();
    }

    for (int c = 0; c < n_steps; ++c) {
      // step c + 1 may still be in flight
      if (a.stages == 2 && c + 1 < n_steps)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // step c staged; the last step's readers done
      const int st = c % a.stages;
      const unsigned char* base = smem + static_cast<size_t>(2 * st) * half;
      if (c < n_chunks) {
        const TP* ks = reinterpret_cast<const TP*>(base);
        const TP* vs = reinterpret_cast<const TP*>(base + half);
        const float* ksc = kI8 ? sc_s + 2 * st * L.nkp : nullptr;
        const float* vsc = kI8 ? ksc + L.nkp : nullptr;
        const int j0 = j_begin + c * a.chunk;
        const int j1 = min(j0 + a.chunk, j_end);
        const int nk = (j1 - j0) * bs;
        const ChunkKeys in_chunk{table, j0, j1, bs, limit};
        const Causal all{0, 0, 0};
        if (by_warp) {
          const MaskKeys in_mask{vk_s + st * L.nkp};
          for (int k0 = 16 * (tid >> 5); k0 < L.nkp; k0 += 16 * kWarps)
            warp_group(acc, q_s, R, hd, ks, vs, ld, k0, nk, ksc, vsc,
                       a.scale, a.softcap, in_mask, all);
        } else {
          if (mma)
            scores_mma(q_s, R, hd, ks, ld, nk, L.nkp, ksc, p_s, L.pw,
                       a.scale, a.softcap, in_chunk, all);
          else
            scores_cuda(q_s, R, hd, ks, ld, nk, ksc, p_s, L.pw, a.scale,
                        a.softcap, in_chunk, all);
          __syncthreads();
          softmax_step(p_s, L.pw, R, nk, mma ? L.nkp : nk, vsc, m_s, l_s,
                       a_s);
          __syncthreads();
          if (mma)
            pv_mma(p_s, L.pw, R, hd, L.nkp, vs, ld, a_s, o_s);
          else
            pv_cuda(p_s, L.pw, R, hd, nk, vs, ld, a_s, o_s);
        }
      } else if constexpr (kSuffix) {
        // suffix keys [key0, key0 + nk) in q's type; tile row r (query row
        // r0 + r, token (r0 + r) / G) sees keys t <= its token
        const TQ* kx = reinterpret_cast<const TQ*>(base);
        const TQ* vx = reinterpret_cast<const TQ*>(base + half);
        const int key0 = (c - n_chunks) * kSfxTile;
        const int nk = min(kSfxTile, n_sfx - key0);
        const Causal cz{G, key0, r0};
        if (by_warp) {
          if ((tid >> 5) == 0)
            warp_group(acc, q_s, R, hd, kx, vx, ldx, 0, nk, nullptr, nullptr,
                       a.scale, a.softcap, AllKeys{}, cz);
        } else {
          if (mma)
            scores_mma(q_s, R, hd, kx, ldx, nk, kSfxTile, nullptr, p_s, L.pw,
                       a.scale, a.softcap, AllKeys{}, cz);
          else
            scores_cuda(q_s, R, hd, kx, ldx, nk, nullptr, p_s, L.pw, a.scale,
                        a.softcap, AllKeys{}, cz);
          __syncthreads();
          softmax_step(p_s, L.pw, R, nk, mma ? kSfxTile : nk, nullptr, m_s,
                       l_s, a_s);
          __syncthreads();
          if (mma)
            pv_mma(p_s, L.pw, R, hd, kSfxTile, vx, ldx, a_s, o_s);
          else
            pv_cuda(p_s, L.pw, R, hd, nk, vx, ldx, a_s, o_s);
        }
      }
      if (c + a.stages < n_steps) {
        __syncthreads();  // stage st is free
        issue(c + a.stages, st);
        cp_async_commit();
      }
    }
    if (by_warp)
      merge_warps(acc, R, hd, reinterpret_cast<float*>(smem + L.wm), o_s,
                  m_s, l_s);
    __syncthreads();  // o, m and l are final
  }

  TQ* out = static_cast<TQ*>(a.out);
  if (a.splits == 1) {
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd;
      store(out + row_at(r0 + r) * hd + (i - r * hd),
            empty ? 0.f : o_s[i] / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }

  // the partial of each row: acc[hd] to [head][split][R_all][hd] of the
  // workspace, (m, l) to [head][split][R_all] after all the accumulators;
  // this tile's rows start at r0; an empty split writes (m, l) only
  const size_t head = static_cast<size_t>(b) * a.K + kh;
  const size_t n_acc =
      static_cast<size_t>(gridDim.y) * a.K * a.splits * R_all * hd;
  const float* acc_ws = a.ws + (head * a.splits * R_all + r0) * hd;
  const float2* st_ws = reinterpret_cast<const float2*>(a.ws + n_acc) +
                        head * a.splits * R_all + r0;
  if (!empty) {
    float* mine = a.ws + ((head * a.splits + split) * R_all + r0) * hd;
    for (int i = tid; i < R * hd; i += kThreads) mine[i] = o_s[i];
  }
  for (int r = tid; r < R; r += kThreads) {
    reinterpret_cast<float2*>(a.ws + n_acc)[(head * a.splits + split) * R_all +
                                            r0 + r] =
        empty ? make_float2(kNegInf, 0.f) : make_float2(m_s[r], l_s[r]);
  }
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  unsigned* counter = a.counters + head * tiles + rt;
  if (tid == 0) last = atomicAdd(counter, 1u) == a.splits - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block merges the tile's partials in split order.  Every
  // split's (m, l) into shared memory (the space of q and the accumulator,
  // which holds 2 * hd floats a row: the plan keeps splits <= hd); a warp
  // per row takes its max M, the weights w = exp(m - M) (0 for a split
  // without keys) and L = sum l * w; then each thread sums 4 columns of
  // w * acc over the splits, several loads in flight
  float* w_s = reinterpret_cast<float*>(smem + L.q);  // (splits, R)
  float* ls_s = w_s + a.splits * R;                  // (splits, R)
  for (int i = tid; i < a.splits * R; i += kThreads) {
    const int s = i / R;
    const float2 v = __ldcg(st_ws + static_cast<size_t>(s) * R_all + (i - s * R));
    w_s[i] = v.y > 0.f ? v.x : kNegInf;
    ls_s[i] = v.y;
  }
  __syncthreads();
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int s = lane; s < a.splits; s += 32) mx = fmaxf(mx, w_s[s * R + r]);
      mx = warp_max(mx);
      float l = 0.f;
      for (int s = lane; s < a.splits; s += 32) {
        const float ls = ls_s[s * R + r];
        const float w = ls > 0.f ? expf(w_s[s * R + r] - mx) : 0.f;
        w_s[s * R + r] = w;
        l = fmaf(ls, w, l);
      }
      l = warp_sum(l);
      if (lane == 0) l_s[r] = l;
    }
  }
  __syncthreads();
  const int groups = hd / 4;
  for (int i = tid; i < R * groups; i += kThreads) {
    const int r = i / groups;
    const int c = (i - r * groups) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    // an empty split's accumulator was never written: it is loaded (the
    // loads all issue before the sums) but its weight 0 selects it out
#pragma unroll 8
    for (int s = 0; s < a.splits; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          acc_ws + (static_cast<size_t>(s) * R_all + r) * hd + c));
      const float w = w_s[s * R + r];
      o[0] = w != 0.f ? fmaf(v.x, w, o[0]) : o[0];
      o[1] = w != 0.f ? fmaf(v.y, w, o[1]) : o[1];
      o[2] = w != 0.f ? fmaf(v.z, w, o[2]) : o[2];
      o[3] = w != 0.f ? fmaf(v.w, w, o[3]) : o[3];
    }
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(out + row_at(r0 + r) * hd + c + e, o[e] / denom);
  }
  if (tid == 0) *counter = 0u;  // ready for the next call
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Check the plan and launch paged_kernel<TQ, TP, kSuffix> on `stream`:
// grid (K * tiles, B, splits), tiles = ceil(G * S / rows), 128 threads,
// `smem` bytes of dynamic shared memory (which must equal the layout's
// total).  cudaErrorInvalidValue for an argument the kernel does not take.
template <typename TQ, typename TP, bool kSuffix>
cudaError_t launch(const Args& a, int B, int smem, cudaStream_t stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TP));
  constexpr int QVEC = 16 / static_cast<int>(sizeof(TQ));
  const bool mma = a.mma != 0;
  if (a.hd <= 0 || a.hd > kMaxHeadDim || a.hd % VEC != 0 || a.hd % 4 != 0 ||
      a.K <= 0 || a.H % a.K != 0 || a.S <= 0 || a.bs <= 0 ||
      a.rows < 1 || a.rows > a.H / a.K * a.S ||
      a.splits < 1 || a.pages < 1 || a.chunk < 1 || a.chunk > a.pages ||
      a.stages < 1 || a.stages > 2 ||
      static_cast<long long>(a.splits) * a.pages < a.n_blk ||
      (mma && (!kMmaTypes<TQ, TP> || a.hd % 16 != 0)) ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(a.k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v_pages) % 16 != 0)
    return cudaErrorInvalidValue;
  // the suffix is staged in 16-byte copies of q's type
  if (kSuffix && (a.hd % QVEC != 0 ||
                  reinterpret_cast<uintptr_t>(a.k_new) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(a.v_new) % 16 != 0))
    return cudaErrorInvalidValue;
  const Layout L = layout(a.rows, a.hd, a.bs, a.chunk, a.stages,
                          static_cast<int>(sizeof(TP)),
                          static_cast<int>(sizeof(TQ)), kSuffix, mma);
  if (L.total != static_cast<size_t>(smem)) return cudaErrorInvalidValue;
  auto kernel = paged_kernel<TQ, TP, kSuffix, false, false>;
  if constexpr (kMmaTypes<TQ, TP>) {
    // a split of several chunks, one 16-row tile of hd <= 128: each warp
    // on its own key groups (it saves two barriers a chunk and pays one
    // merge of the warps a block, which one chunk does not repay)
    if (mma && a.stages == 2 && a.rows <= 16 && a.hd <= 8 * kWarpTiles)
      kernel = paged_kernel<TQ, TP, kSuffix, true, true>;
    else if (mma)
      kernel = paged_kernel<TQ, TP, kSuffix, true, false>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (a.H / a.K * a.S + a.rows - 1) / a.rows;
  const dim3 grid(a.K * tiles, B, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Call f(TQ{}, TP{}) for the query/output type code `q_dtype` (float32 or
// bfloat16) and the page type code `page_dtype` (float32, bfloat16 or
// int8); cudaErrorInvalidValue for any other code.
template <typename TQ, typename F>
cudaError_t dispatch_pages(int page_dtype, F&& f) {
  switch (page_dtype) {
    case kF32:
      return f(TQ{}, float{});
    case kBF16:
      return f(TQ{}, bf16{});
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
      return dispatch_pages<bf16>(page_dtype, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paged
