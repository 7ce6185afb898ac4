"""Wrapper of the hand-written Hopper ``paged_extend_attention`` kernel
(``repro_torch/csrc/paged_extend_attention.cu``; replaces the Pallas
``repro.kernels.flash_attention.paged_extend_attention``).

``paged_extend_attention`` checks device, dtypes, shapes and
contiguity, raises on anything the kernel does not take (a shape whose
thread block would need more shared memory than a block may use
included), allocates the output with ``torch.empty`` and launches on
PyTorch's current stream without synchronising.  It takes CUDA tensors
only: ``kernels.ops`` routes CPU tensors to the plain version in
``kernels.ref``.  ``launches`` counts the kernel launches made through
this wrapper (reset it by assignment).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "paged_extend_attention"


def smem_bytes(G: int, S: int, hd: int, bs: int) -> int:
    """Dynamic shared memory of one thread block (see the .cu header):
    R = G * S query rows, staging rows T = max(bs, S)."""
    R, T = G * S, max(bs, S)
    return 4 * (2 * R * hd + 2 * T * hd + R * T + 3 * R)


def _check(q, k_pages, v_pages, k_new, v_new, block_tables, pos, k_scale,
           v_scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "k_new": k_new, "v_new": v_new,
               "block_tables": block_tables, "pos": pos}
    if k_scale is not None or v_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    checks.on_one_cuda_device(NAME, tensors, q.device)
    if q.dim() != 4:
        raise ValueError(f"{NAME}: q must be (B, S, H, hd)")
    B, S, H, hd = q.shape
    checks.query_dtype(NAME, q)
    _, bs, K = checks.page_pool(NAME, k_pages, v_pages, k_scale, v_scale,
                                H, hd)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, S, K, hd) or t.dtype != q.dtype:
            raise ValueError(f"{NAME}: {name} must be {q.dtype} "
                             f"{(B, S, K, hd)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    checks.int32_rows(NAME, "block_tables", block_tables, B, 2)
    checks.int32_rows(NAME, "pos", pos, B, 1)
    checks.shared_memory(NAME, smem_bytes(H // K, S, hd, bs))


def paged_extend_attention(q, k_pages, v_pages, k_new, v_new, block_tables,
                           pos, *, scale: float, softcap: float = 0.0,
                           k_scale=None, v_scale=None):
    """Paged multi-token extend attention on the card.

    q (B, S, H, hd) float32/bfloat16 at absolute positions ``pos + i``;
    k_new/v_new (B, S, K, hd) in q's dtype, the suffix the queries
    attend causally; k_pages/v_pages (num_blocks, bs, K, hd) float32,
    bfloat16 or int8 (then with float32 ``k_scale`` / ``v_scale``
    (num_blocks, bs, K)), read as the pre-write view masked below
    ``pos``; block_tables (B, n_blk) int32, -1 = unallocated; pos (B,)
    int32.  Returns (B, S, H, hd) in ``q.dtype``.
    """
    global launches
    _check(q, k_pages, v_pages, k_new, v_new, block_tables, pos, k_scale,
           v_scale)
    B, S, H, hd = q.shape
    nB, bs, K, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_extend_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *checks.scale_pointers(k_scale, v_scale),
            k_new.data_ptr(), v_new.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, S, H, K, hd, bs, block_tables.shape[1],
            float(scale), float(softcap),
            checks.DTYPE_CODES[q.dtype], checks.DTYPE_CODES[k_pages.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
