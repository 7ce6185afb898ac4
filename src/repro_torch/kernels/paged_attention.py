"""Wrapper of the hand-written Hopper ``paged_attention`` kernel
(``repro_torch/csrc/paged_attention.cu``; replaces the Pallas
``repro.kernels.flash_attention.paged_attention``).

``paged_attention`` checks device, dtypes, shapes and contiguity, raises
on anything the kernel does not take, allocates the output with
``torch.empty`` and launches on PyTorch's current stream without
synchronising.  It takes CUDA tensors only: ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.  ``launches`` counts
the kernel launches made through this wrapper (reset it by assignment).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "paged_attention"


def smem_bytes(G: int, hd: int, bs: int) -> int:
    """Dynamic shared memory of one thread block (see the .cu header)."""
    return 4 * (2 * G * hd + 2 * bs * hd + G * bs + 3 * G)


def _check(q, k_pages, v_pages, block_tables, lengths, k_scale, v_scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lengths": lengths}
    if k_scale is not None or v_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    checks.on_one_cuda_device(NAME, tensors, q.device)
    if q.dim() != 3:
        raise ValueError(f"{NAME}: q must be (B, H, hd)")
    B, H, hd = q.shape
    checks.query_dtype(NAME, q)
    _, bs, K = checks.page_pool(NAME, k_pages, v_pages, k_scale, v_scale,
                                H, hd)
    checks.int32_rows(NAME, "block_tables", block_tables, B, 2)
    checks.int32_rows(NAME, "lengths", lengths, B, 1)
    checks.shared_memory(NAME, smem_bytes(H // K, hd, bs))


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: float, softcap: float = 0.0,
                    k_scale=None, v_scale=None):
    """Paged single-token decode attention on the card.

    q (B, H, hd) float32/bfloat16; k_pages/v_pages (num_blocks, bs, K,
    hd) float32, bfloat16 or int8 (then with float32 ``k_scale`` /
    ``v_scale`` (num_blocks, bs, K)); block_tables (B, n_blk) int32,
    -1 = unallocated; lengths (B,) int32.  Returns (B, H, hd) in
    ``q.dtype``; a row with no valid position is 0.
    """
    global launches
    _check(q, k_pages, v_pages, block_tables, lengths, k_scale, v_scale)
    B, H, hd = q.shape
    nB, bs, K, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *checks.scale_pointers(k_scale, v_scale),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, K, hd, bs, block_tables.shape[1],
            float(scale), float(softcap),
            checks.DTYPE_CODES[q.dtype], checks.DTYPE_CODES[k_pages.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
