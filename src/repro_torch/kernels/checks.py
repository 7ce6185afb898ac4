"""Argument checks shared by the wrappers of the hand-written kernels.

Each check raises on what the kernels do not take, with the kernel's
name first in the message.  Nothing here launches or allocates.
"""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SMEM_LIMIT = 232_448           # bytes of shared memory a block may use
MAX_HEAD_DIM = 256


def on_one_cuda_device(kernel: str, tensors: dict, device,
                       contiguous: bool = True) -> None:
    """Every tensor of ``tensors`` ({name: tensor}) is a tensor on the
    CUDA device ``device``, and a contiguous one unless ``contiguous`` is
    False."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} must be a tensor")
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}; "
                             f"the kernel takes tensors on one CUDA device")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def query_dtype(kernel: str, q) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: q dtype {q.dtype} (takes float32 or "
                        "bfloat16)")


def page_pool(kernel: str, k_pages, v_pages, k_scale, v_scale, H: int,
              hd: int) -> tuple:
    """The pool (nB, bs, K, hd) in float32, bfloat16 or int8 with
    float32 scales (nB, bs, K), whose rows are whole 16-byte vectors at
    16-byte aligned bases, for H query heads of head_dim ``hd``.
    Returns (nB, bs, K)."""
    if k_pages.dim() != 4:
        raise ValueError(f"{kernel}: pages must be (num_blocks, bs, K, hd)")
    nB, bs, K, hd_p = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_p != hd:
        raise ValueError(f"{kernel}: page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match head_dim "
                         f"{hd}")
    if K == 0 or H % K:
        raise ValueError(f"{kernel}: {H} query heads do not group over "
                         f"{K} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {hd} > {MAX_HEAD_DIM}")
    if k_pages.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{kernel}: page dtypes {k_pages.dtype} / "
                        f"{v_pages.dtype}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{kernel}: int8 pages need k_scale and v_scale, "
                         "other pages take neither")
    # the kernels stage page rows in 16-byte vector loads
    if (hd * k_pages.element_size()) % 16:
        raise ValueError(f"{kernel}: a page row of head_dim {hd} "
                         f"{k_pages.dtype} is not a whole number of 16-byte "
                         "vectors")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != (nB, bs, K):
                raise ValueError(f"{kernel}: {name} must be float32 "
                                 f"{(nB, bs, K)}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
    return nB, bs, K


def int32_rows(kernel: str, name: str, t, B: int, dim: int) -> None:
    """``t`` is int32 with ``dim`` dimensions and B rows."""
    if t.dtype != torch.int32 or t.dim() != dim or t.shape[0] != B:
        shape = f"({B},)" if dim == 1 else f"(B={B}, n_blk)"
        raise ValueError(f"{kernel}: {name} must be int32 {shape}")


def shared_memory(kernel: str, smem: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel}: needs {smem} bytes of shared memory "
                         f"per block (> {SMEM_LIMIT}); this shape does "
                         "not fit")


def scale_pointers(k_scale, v_scale) -> tuple:
    return (None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr())
