// Paged single-query decode attention (GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/flash_attention.py (body `_paged_kernel`, launched by
// the pl.pallas_call in `paged_attention`).  The plain PyTorch version is
// repro_torch/kernels/ref.py::paged_attention_ref; the wrapper that
// checks arguments and launches this file is
// repro_torch/kernels/paged_attention.py.
//
// What it computes, for every sequence b and query head h:
//   out[b, h] = sum_t softmax_t(cap(scale * q[b, h] . k_t)) * v_t
// over the row's logical positions t < lengths[b], where position t lives
// in physical page block_tables[b, t / bs] at offset t % bs, in kv head
// h / G (G = H / K).  Entries of -1 in the table are unallocated pages:
// they are skipped and never dereferenced (the Pallas kernel clips them to
// page 0 and masks them).  cap is the tanh softcap when softcap > 0.  For
// an int8 pool, K/V rows are multiplied by their per-(page, offset,
// kv-head) float scales before use.  A row with no valid position returns
// 0, as the Pallas kernel's acc / max(l, 1e-30) does.
//
// Bound: memory.  One call must read q, the valid K/V rows of every
// sequence (plus their scales on an int8 pool), the tables and lengths,
// and write the output; it does about 4 * hd flops per K/V row of
// 2 * hd * elt bytes, far below the ~295 flop/byte ridge of the H100.
// Least time = those bytes / 3.35 TB/s.
//
// Design.  One thread block per (kv head, sequence) covers all G query
// heads of its group, so each page row is read from device memory once
// per kv head (the Pallas grid (B, H, n_blk) reads it G times).  The block
// walks its row's block table itself and stops at the row's length.  Each
// page's rows for this kv head are staged in shared memory as float
// (16-byte loads, so head_dim * element size must be a multiple of 16 and
// the pools 16-byte aligned; dequantized there for int8), scores come
// from warp-wide dot products (lanes split head_dim), and a float32
// online softmax (running max m, denominator l, accumulator acc, all in
// shared memory) carries across pages.  head_dim up to 256 and any page
// size fit; shared memory is 4 * (2*G*hd + 2*bs*hd + G*bs + 3*G) bytes.
// Simple and right first: no split of long rows across blocks, no
// cp.async/TMA staging and no tensor cores yet.

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ k_pages,
    const TP* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lengths, TQ* __restrict__ out, int H, int K,
    int hd, int bs, int n_blk, float scale, float softcap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;             // (G, hd)   queries of the group
  float* k_s = q_s + G * hd;     // (bs, hd)  this page's K rows
  float* v_s = k_s + bs * hd;    // (bs, hd)  this page's V rows
  float* acc_s = v_s + bs * hd;  // (G, hd)   unnormalised output
  float* p_s = acc_s + G * hd;   // (G, bs)   scores, then probabilities
  float* m_s = p_s + G * bs;     // (G,)      running max
  float* l_s = m_s + G;          // (G,)      running denominator
  float* a_s = l_s + G;          // (G,)      this page's rescale factor

  const int h0 = kh * G;
  const TQ* q_row = q + (static_cast<size_t>(b) * H + h0) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    q_s[i] = to_float(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  int n_used = len <= 0 ? 0 : (len + bs - 1) / bs;
  if (n_used > n_blk) n_used = n_blk;
  const int32_t* table = block_tables + static_cast<size_t>(b) * n_blk;
  __syncthreads();

  for (int j = 0; j < n_used; ++j) {
    const int page = table[j];  // the same for every thread of the block
    if (page < 0) continue;     // unallocated: skipped, never read
    const int t_valid = min(bs, len - j * bs);  // >= 1 since j < n_used

    stage_page_rows(k_pages, v_pages, k_scale, v_scale, page, t_valid, bs,
                    K, kh, hd, k_s, v_s);
    __syncthreads();

    attend_staged(q_s, k_s, v_s, acc_s, p_s, m_s, l_s, a_s, G, 1, bs, hd,
                  t_valid, false, scale, softcap);
  }

  TQ* o_row = out + (static_cast<size_t>(b) * H + h0) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    store(o_row + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* lengths, void* out,
                   int B, int H, int K, int hd, int bs, int n_blk,
                   float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(G) * hd +
                       2 * static_cast<size_t>(bs) * hd +
                       static_cast<size_t>(G) * bs + 3 * static_cast<size_t>(G));
  // rows start at multiples of hd elements: the 16-byte loads need hd to
  // be a whole number of vectors and the pool bases 16-byte aligned
  if (hd > 32 * kMaxChunks || hd % Vec16<TP>::N != 0 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<TQ, TP>;
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
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<TQ*>(out), H, K, hd,
      bs, n_blk, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer
// (k_scale / v_scale are null for a float pool); dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (pages only).  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int B, int H, int K, int hd, int bs,
    int n_blk, float scale, float softcap, int q_dtype, int page_dtype,
    void* stream) {
  return static_cast<int>(paged::dispatch(q_dtype, page_dtype, [&](auto tq,
                                                                  auto tp) {
    return launch<decltype(tq), decltype(tp)>(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out, B,
        H, K, hd, bs, n_blk, scale, softcap,
        static_cast<cudaStream_t>(stream));
  }));
}
