"""Dispatch for the kernels: the tensors' device picks the path.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors go to the plain PyTorch version in ``kernels.ref``.  There is
no fall-back from one to the other: the plain version serves CPU tensors
only, never a CUDA call that failed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_extend_attention as _pea
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def quant_matmul(x, wq, scale, out_dtype=torch.bfloat16):
    """W8A16 product ``x (M, K) @ (wq (K, N) int8 * scale (N,))`` in
    ``out_dtype``.  The kernel rounds x to bfloat16 and accumulates in
    float32 (the TPU kernel's semantics); the plain version, which CPU
    tensors take, keeps x in float32 (the JAX package's branch off the
    TPU, ``ref.quant_matmul_ref``)."""
    if x.device.type == "cuda":
        return _qm.quant_matmul(x, wq, scale, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, wq, scale, out_dtype=out_dtype)
    raise ValueError(f"quant_matmul: no kernel for device {x.device}")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, scale,
                    softcap: float = 0.0, k_scale=None, v_scale=None):
    """Paged single-token decode read; see ``ref.paged_attention_ref``
    for the semantics.  Rows with no valid position differ by
    definition: the kernel returns 0 there, the plain version the mean
    of the clipped page 0 (as their JAX originals do)."""
    kw = dict(scale=scale, softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        return _pa.paged_attention(q, k_pages, v_pages, block_tables,
                                   lengths, **kw)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       lengths, **kw)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")


def paged_extend_attention(q, k_pages, v_pages, k_new, v_new, block_tables,
                           pos, *, scale, softcap: float = 0.0,
                           k_scale=None, v_scale=None):
    """Paged multi-token extend read; see
    ``ref.paged_extend_attention_ref`` for the semantics."""
    args = (q, k_pages, v_pages, k_new, v_new, block_tables, pos)
    kw = dict(scale=scale, softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        return _pea.paged_extend_attention(*args, **kw)
    if q.device.type == "cpu":
        return ref.paged_extend_attention_ref(*args, **kw)
    raise ValueError(f"paged_extend_attention: no kernel for device "
                     f"{q.device}")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, h0=None):
    """Mamba2 SSD scan: (y (b, l, h, p) in x's dtype, final state
    (b, h, p, n) float32); see ``ref.ssd_scan_ref`` for the semantics.
    The kernel walks chunks of ``min(chunk, l)`` positions (``chunk``
    changes the summation order only; the models pass
    ``cfg.ssm_chunk``); the plain version, which CPU tensors take, runs
    the recurrence one position at a time."""
    if x.device.type == "cuda":
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, h0=h0)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
