"""Dispatch for the kernels: the tensors' device picks the path.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors go to the plain PyTorch version in ``kernels.ref``.  There is
no fall-back from one to the other: the plain version serves CPU tensors
only, never a CUDA call that failed.

No op here has a backward.  The reference has no backward kernel for
any of them (no ``custom_vjp``: ``jax.grad`` through a Pallas call
raises), and a kernel fills a fresh tensor through ctypes, which autograd
would silently treat as a constant.  So every op raises
``NotImplementedError`` when gradients are enabled and a floating input
requires grad, on CUDA and CPU tensors alike: the plain version stands
in for the kernel and keeps its contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_extend_attention as _pea
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def _no_backward(name: str, *tensors) -> None:
    """Raise where autograd would need a backward the op does not have."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward: the reference has no backward kernel "
            f"for it (the Pallas kernel has no custom_vjp); call it under "
            f"torch.no_grad() or on inputs that do not require grad")


def flash_attention(q, k, v, *, scale, window: int = 0,
                    softcap: float = 0.0):
    """Causal GQA attention q (B, S, H, hd) over k, v (B, T, K, hd) with
    an optional sliding ``window`` and logit ``softcap``; see
    ``ref.flash_attention_ref`` for the semantics.  A query row with no
    visible key (only when T < S) differs by definition: the kernel
    returns 0 there, the plain version the mean of v (as their JAX
    originals do)."""
    _no_backward("flash_attention", q, k, v)
    kw = dict(scale=scale, window=window, softcap=softcap)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def quant_matmul(x, wq, scale, out_dtype=torch.bfloat16):
    """W8A16 product ``x (M, K) @ (wq (K, N) int8 * scale (N,))`` in
    ``out_dtype``.  The kernel rounds x to bfloat16 and accumulates in
    float32 (the TPU kernel's semantics); the plain version, which CPU
    tensors take, keeps x in float32 (the JAX package's branch off the
    TPU, ``ref.quant_matmul_ref``)."""
    _no_backward("quant_matmul", x, wq, scale)
    if x.device.type == "cuda":
        return _qm.quant_matmul(x, wq, scale, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, wq, scale, out_dtype=out_dtype)
    raise ValueError(f"quant_matmul: no kernel for device {x.device}")


# per-output-channel int8 weights for ``quant_matmul`` (as in JAX's ops)
quantize_weights = _qm.quantize_weights


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *, scale,
                    softcap: float = 0.0, k_scale=None, v_scale=None):
    """Paged single-token decode read; see ``ref.paged_attention_ref``
    for the semantics.  Rows with no valid position differ by
    definition: the kernel returns 0 there, the plain version the mean
    of the clipped page 0 (as their JAX originals do)."""
    _no_backward("paged_attention", q, k_pages, v_pages, k_scale, v_scale)
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
    _no_backward("paged_extend_attention", q, k_pages, v_pages, k_new, v_new,
                 k_scale, v_scale)
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
    _no_backward("ssd_scan", x, dt, A, B, C, h0)
    if x.device.type == "cuda":
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, h0=h0)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
