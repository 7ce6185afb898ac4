// Paged multi-token extend attention (GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_extend_attention` in
// src/repro/kernels/flash_attention.py (:283; body `_paged_extend_kernel`,
// launched by the pl.pallas_call in `paged_extend_attention`).  The plain
// PyTorch version is repro_torch/kernels/ref.py::paged_extend_attention_ref;
// the wrapper that checks arguments, plans the split and launches this
// file is repro_torch/kernels/paged_extend_attention.py.
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
// per-(page, offset, kv-head) float scales; the suffix comes in q's
// dtype, already round-tripped by the caller.  The suffix's diagonal is
// always visible, so every row has a key, and the output acc / max(l,
// 1e-30) is written in q's dtype.
//
// Bound: memory.  One call must read q, the visible context rows of K/V
// (plus their scales on an int8 pool), k_new, v_new, the tables and pos,
// and write the output; it does about 4 * hd flops per (query head, key)
// pair, at R = G * S = 16 query rows per page row on the serving path
// (phi3, S = 4), still far below the H100's ~295 flop/byte ridge.  Least
// time = those bytes / 3.35 TB/s, under a microsecond at the serving
// shape.
//
// Design (`paged::paged_kernel` in paged_common.cuh, with the suffix), as
// for paged_attention.cu: grid (K * tiles, B, splits) from the wrapper's
// shape-only `paged_plan`, a block's pages staged with `cp.async` in the
// pool's type (both ring stages before the first wait), float32 partials
// merged in split order by the last block of each (row, row tile).  The
// R = G * S rows of a kv head's group are cut into tiles of at most 64
// rows, one block each, and the causal suffix is streamed through the
// stage ring 16 keys at a time by the last split, only up to the tile's
// last token: so a block's shared memory is bounded whatever S is (the
// first version held all R rows of q and the accumulator and the whole
// float suffix, and refused S >= 22 at gemma3-1b's hd 256).  The plan
// gives a split at least as many keys as its tile has rows and counts the
// tiles among the blocks it aims at.  For bf16 queries over bf16 or int8
// pages (what int8 serving and the speculative verify run) with hd a
// multiple of 16, q.k and p.v run on the tensor cores: 16 rows are one
// `mma.sync.m16n8k16` tile; K's int8 bytes are exact in bf16, each k step
// accumulates into a fresh float32 fragment, and the row scale multiplies
// the sum; P (times the V row scale) is split into bf16 hi + lo, as in
// flash_attention.cu, so the output stays within a bf16 step of the
// float32 plain version.  Splits of several chunks with tiles of <= 16
// rows go through the per-warp path.  Float32 queries, and bf16 queries
// over float32 pages, keep the CUDA-core scores and p.v.

#include "paged_common.cuh"

// C entry point, bound with ctypes.  Every pointer is a device pointer
// (k_scale / v_scale are null for a float pool; k_new / v_new are in q's
// dtype, 16-byte aligned; ws and counters are needed only when splits >
// 1: B * K * splits * R * (hd + 2) floats, R = S * H / K, and B * K *
// ceil(R / rows) zeroed counters, which the kernel leaves zero); dtype
// codes: 0 float32, 1 bfloat16, 2 int8 (pages only).  rows / splits /
// pages / chunk / stages / mma / smem are the wrapper's plan.  Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int repro_paged_extend_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* block_tables, const void* pos, void* out,
    void* ws, void* counters, int B, int S, int H, int K, int hd, int bs,
    int n_blk, int rows, int splits, int pages, int chunk, int stages, int mma,
    int smem, float scale, float softcap, int q_dtype, int page_dtype,
    void* stream) {
  paged::Args a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.k_new = k_new;
  a.v_new = v_new;
  a.tables = static_cast<const int32_t*>(block_tables);
  a.limit = static_cast<const int32_t*>(pos);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned*>(counters);
  a.S = S;
  a.rows = rows;
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
    return paged::launch<decltype(tq), decltype(tp), true>(
        a, B, smem, static_cast<cudaStream_t>(stream));
  }));
}
