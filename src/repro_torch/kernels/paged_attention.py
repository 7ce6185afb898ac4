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

from repro_torch.kernels import build

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
_MAX_HEAD_DIM = 256


def smem_bytes(G: int, hd: int, bs: int) -> int:
    """Dynamic shared memory of one thread block (see the .cu header)."""
    return 4 * (2 * G * hd + 2 * bs * hd + G * bs + 3 * G)


def _check(q, k_pages, v_pages, block_tables, lengths, k_scale, v_scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lengths": lengths}
    if k_scale is not None or v_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"paged_attention: {name} must be a tensor")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}; "
                             f"the kernel takes tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_attention: q must be (B, H, hd) and pages "
                         "(num_blocks, bs, K, hd)")
    B, H, hd = q.shape
    nB, bs, K, hd_p = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_p != hd:
        raise ValueError(f"paged_attention: page shapes {k_pages.shape} / "
                         f"{v_pages.shape} do not match q {q.shape}")
    if K == 0 or H % K:
        raise ValueError(f"paged_attention: {H} query heads do not group "
                         f"over {K} kv heads")
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {hd} > "
                         f"{_MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: q dtype {q.dtype} (takes "
                        "float32 or bfloat16)")
    if k_pages.dtype not in _DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention: page dtypes {k_pages.dtype} / "
                        f"{v_pages.dtype}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: int8 pages need k_scale and "
                         "v_scale, other pages take neither")
    # the kernel stages page rows in 16-byte vector loads
    if (hd * k_pages.element_size()) % 16:
        raise ValueError(f"paged_attention: a page row of head_dim {hd} "
                         f"{k_pages.dtype} is not a whole number of 16-byte "
                         "vectors")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != (nB, bs, K):
                raise ValueError(f"paged_attention: {name} must be float32 "
                                 f"{(nB, bs, K)}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != B):
        raise ValueError(f"paged_attention: block_tables must be int32 "
                         f"(B={B}, n_blk)")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"paged_attention: lengths must be int32 ({B},)")
    smem = smem_bytes(H // K, hd, bs)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: needs {smem} bytes of shared "
                         f"memory per block (> {_SMEM_LIMIT})")


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
    lib = build.load("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, K, hd, bs, block_tables.shape[1],
            float(scale), float(softcap),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
