// Paged multi-token extend attention (GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_extend_attention` in
// src/repro/kernels/flash_attention.py (body `_paged_extend_kernel`,
// launched by the pl.pallas_call in `paged_extend_attention`).  The plain
// PyTorch version is repro_torch/kernels/ref.py::paged_extend_attention_ref;
// the wrapper that checks arguments and launches this file is
// repro_torch/kernels/paged_extend_attention.py.
//
// What it computes, for every sequence b, new token s < S and query head
// h (kv head h / G, G = H / K):
//   out[b, s, h] = sum_t softmax_t(cap(scale * q[b, s, h] . k_t)) * v_t
// over two key sets in one softmax: the context, the row's logical
// positions t < pos[b] on allocated pages (position t lives in physical
// page block_tables[b, t / bs] at offset t % bs; -1 entries are skipped
// and never dereferenced), read from the pool as it was before this
// call's tokens are written (the caller launches this kernel before its
// scatter); and the suffix, the dense k_new / v_new[b, t] for t <= s
// (causal).  cap is the tanh softcap when softcap > 0, applied after the
// scale.  For an int8 pool the page rows are multiplied by their
// per-(page, offset, kv-head) float scales before use; the suffix comes
// in q's dtype, already round-tripped by the caller.  The suffix's
// diagonal is always visible, so every row has a key, and the output
// acc / max(l, 1e-30) is written in q's dtype.
//
// Bound: memory.  One call must read q, the visible context rows of K/V
// (plus their scales on an int8 pool), k_new, v_new, the tables and pos,
// and write the output; it does about 4 * hd flops per (query head,
// key) pair, at R = G * S = 16 query rows per page row on the serving
// path, still far below the ~295 flop/byte ridge of the H100.  Least
// time = those bytes / 3.35 TB/s.
//
// Design.  One thread block per (kv head, sequence) covers the R = G * S
// query rows of its group (row r = s * G + g), so each page row is read
// from device memory once per kv head (the Pallas grid (B, H, n_blk + 1)
// reads it H / K times).  The block walks its own block table up to
// ceil(pos / bs) pages only, stages each page's rows for its kv head in
// shared memory as float (16-byte loads, dequantized there for int8),
// and keeps a float32 online softmax (running max m, denominator l,
// accumulator acc) per query row in shared memory.  Scores: one warp per
// key, each lane holding its slice of the key in registers and
// reducing a dot product per query row; statistics: one warp per query
// row; accumulation: each thread owns fixed (row, d) entries.  After the
// pages the block stages the S suffix keys and runs the same three steps
// with the causal mask.  Shared memory is
// 4 * (2*R*hd + 2*T*hd + R*T + 3*R) bytes with T = max(bs, S): 34 KB for
// phi3 (R = 16, hd = 128, bs = 16); above 48 KB the launch opts in, up to
// the 227 KB a block may use, and the wrapper refuses larger shapes.
// Simple and right first: no wgmma, no TMA, no split of long rows.

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 256;

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads) paged_extend_attention_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ k_pages,
    const TP* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ pos, TQ* __restrict__ out, int S, int H,
    int K, int hd, int bs, int n_blk, float scale, float softcap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int R = G * S;
  const int T = max(bs, S);
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;             // (R, hd)   query rows r = s * G + g
  float* k_s = q_s + R * hd;     // (T, hd)   staged K rows
  float* v_s = k_s + T * hd;     // (T, hd)   staged V rows
  float* acc_s = v_s + T * hd;   // (R, hd)   unnormalised output
  float* p_s = acc_s + R * hd;   // (R, T)    scores, then probabilities
  float* m_s = p_s + R * T;      // (R,)      running max
  float* l_s = m_s + R;          // (R,)      running denominator
  float* a_s = l_s + R;          // (R,)      this step's rescale factor

  // q[b, s, kh * G + g, :] -> q_s[s * G + g, :]
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    const int s = r / G;
    const size_t src =
        (static_cast<size_t>(b * S + s) * H + kh * G + (r - s * G)) * hd +
        (i - r * hd);
    q_s[i] = to_float(q[src]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // context: positions t < pos[b], pages up to ceil(pos / bs)
  const int p0 = pos[b];
  int n_used = p0 <= 0 ? 0 : (p0 + bs - 1) / bs;
  if (n_used > n_blk) n_used = n_blk;
  const int32_t* table = block_tables + static_cast<size_t>(b) * n_blk;
  __syncthreads();

  for (int j = 0; j < n_used; ++j) {
    const int page = table[j];  // the same for every thread of the block
    if (page < 0) continue;     // unallocated: skipped, never read
    const int t_valid = min(bs, p0 - j * bs);  // >= 1 since j < n_used
    stage_page_rows(k_pages, v_pages, k_scale, v_scale, page, t_valid, bs,
                    K, kh, hd, k_s, v_s);
    __syncthreads();
    attend_staged(q_s, k_s, v_s, acc_s, p_s, m_s, l_s, a_s, R, G, T, hd,
                  t_valid, false, scale, softcap);
  }

  // suffix: k_new / v_new[b, t, kh, :] for t < S, causal
  for (int i = tid; i < S * hd; i += blockDim.x) {
    const int t = i / hd;
    const size_t src =
        (static_cast<size_t>(b * S + t) * K + kh) * hd + (i - t * hd);
    k_s[i] = to_float(k_new[src]);
    v_s[i] = to_float(v_new[src]);
  }
  __syncthreads();
  attend_staged(q_s, k_s, v_s, acc_s, p_s, m_s, l_s, a_s, R, G, T, hd, S,
                true, scale, softcap);

  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    const int s = r / G;
    const size_t dst =
        (static_cast<size_t>(b * S + s) * H + kh * G + (r - s * G)) * hd +
        (i - r * hd);
    store(out + dst, acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* k_new, const void* v_new,
                   const void* block_tables, const void* pos, void* out,
                   int B, int S, int H, int K, int hd, int bs, int n_blk,
                   float scale, float softcap, cudaStream_t stream) {
  const size_t R = static_cast<size_t>(H / K) * S;
  const size_t T = static_cast<size_t>(bs > S ? bs : S);
  const size_t smem = sizeof(float) * (2 * R * hd + 2 * T * hd + R * T + 3 * R);
  // rows start at multiples of hd elements: the 16-byte loads need hd to
  // be a whole number of vectors and the pool bases 16-byte aligned
  if (hd > 32 * kMaxChunks || hd % Vec16<TP>::N != 0 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kernel = paged_extend_attention_kernel<TQ, TP>;
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
      static_cast<const float*>(v_scale), static_cast<const TQ*>(k_new),
      static_cast<const TQ*>(v_new),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(pos), static_cast<TQ*>(out), S, H, K, hd,
      bs, n_blk, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer
// (k_scale / v_scale are null for a float pool; k_new / v_new are in q's
// dtype); dtype codes: 0 float32, 1 bfloat16, 2 int8 (pages only).
// Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int repro_paged_extend_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* block_tables, const void* pos, void* out,
    int B, int S, int H, int K, int hd, int bs, int n_blk, float scale,
    float softcap, int q_dtype, int page_dtype, void* stream) {
  return static_cast<int>(paged::dispatch(q_dtype, page_dtype, [&](auto tq,
                                                                  auto tp) {
    return launch<decltype(tq), decltype(tp)>(
        q, k_pages, v_pages, k_scale, v_scale, k_new, v_new, block_tables,
        pos, out, B, S, H, K, hd, bs, n_blk, scale, softcap,
        static_cast<cudaStream_t>(stream));
  }));
}
