// Paged single-query decode attention (GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/flash_attention.py (:140; body `_paged_kernel`,
// launched by the pl.pallas_call in `paged_attention`).  The plain PyTorch
// version is repro_torch/kernels/ref.py::paged_attention_ref; the wrapper
// that checks arguments, plans the split and launches this file is
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
// kv-head) float scales.  A row with no valid position returns 0, as the
// Pallas kernel's acc / max(l, 1e-30) does.
//
// Bound: memory.  One call must read q, the valid K/V rows of every
// sequence (plus their scales on an int8 pool), the tables and lengths,
// and write the output; it does about 4 * hd flops per (query head, K/V
// row) at 2 * hd * elt bytes a row, G = 4 query heads a row for phi3 and
// gemma3: about 0.5 flop a byte, far below the H100's ~295 ridge.  Least
// time = those bytes / 3.35 TB/s: about a microsecond at the serving
// shape, 0.025 ms for 4 rows of 4096 bf16 tokens at phi3's width.
//
// Design (`paged::paged_kernel` in paged_common.cuh, without a suffix).
// At those sizes the time goes to latency and parallelism, not bandwidth:
// one block per (kv head, sequence) gave phi3 40 blocks and gemma3 4 for
// 132 SMs, each walking its ~20 pages one blocking round trip at a time.
// So each row's table is split across blocks: grid (K, B, splits), where
// the wrapper's `paged_plan` picks `splits` from the shapes alone (never
// from lengths, which would sync the host) for at least two blocks an SM.
// A block stages its split's pages for its kv head with `cp.async` in
// the pool's type, both ring stages issued before the first wait, and
// covers all G query heads of the group, so each page row is read from
// device memory once.  bf16 queries over bf16 or int8 pages (what serving
// runs) score and sum on the tensor cores: G = 4 rows fill a quarter of an
// m16n8k16 tile, but the tensor cores' work is free beside the CUDA
// cores' dot products and shuffles, which measured slower (PERF.md);
// splits of several chunks go through the per-warp path.  float32
// queries, and float32 pages, score on the CUDA cores: a team of lanes
// spans a key row (16 bytes a lane), holds the group's query slices in
// registers and reduces by shuffles.  The int8 row scales multiply the
// dot product and the probability, not each element.  The blocks of a
// row write float32 partials (m, l, acc); the last to arrive merges them
// in split order in the same launch.

#include "paged_common.cuh"

// C entry point, bound with ctypes.  Every pointer is a device pointer
// (k_scale / v_scale are null for a float pool; ws and counters are
// needed only when splits > 1: B * K * splits * H / K * (hd + 2) floats
// and B * K zeroed counters, which the kernel leaves zero); dtype codes:
// 0 float32, 1 bfloat16, 2 int8 (pages only).  splits / pages / chunk /
// stages / mma / smem are the wrapper's plan.  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, void* ws, void* counters, int B, int H,
    int K, int hd, int bs, int n_blk, int splits, int pages, int chunk,
    int stages, int mma, int smem, float scale, float softcap, int q_dtype,
    int page_dtype, void* stream) {
  paged::Args a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int32_t*>(block_tables);
  a.limit = static_cast<const int32_t*>(lengths);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned*>(counters);
  a.S = 1;
  a.rows = H / K;  // one tile: the G rows of a kv head
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.bs = bs;
  a.n_blk = n_blk;
  a.splits = splits;
  a.pages = pages;
  a.chunk = chunk;
  a.stages = stages;
  a.mma = mma;
  a.scale = scale;
  a.softcap = softcap;
  return static_cast<int>(paged::dispatch(q_dtype, page_dtype, [&](auto tq,
                                                                  auto tp) {
    return paged::launch<decltype(tq), decltype(tp), false>(
        a, B, smem, static_cast<cudaStream_t>(stream));
  }));
}
