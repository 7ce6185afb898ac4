"""Wrapper of the hand-written Hopper ``quant_matmul`` kernel
(``repro_torch/csrc/quant_matmul.cu``; replaces the Pallas
``repro.kernels.quant_matmul.quant_matmul``), and the host helper
``quantize_weights``.

``quant_matmul`` checks device, dtypes, shapes and contiguity, raises on
anything the kernel does not take, allocates the output with
``torch.empty`` and launches on PyTorch's current stream without
synchronising.  It takes CUDA tensors only: ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.  ``launches`` counts
the kernel launches made through this wrapper (reset it by assignment).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "quant_matmul"


def _check(x, wq, scale, out_dtype):
    checks.on_one_cuda_device(NAME, {"x": x, "wq": wq, "scale": scale},
                              x.device)
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"{NAME}: x must be (M, K) and wq (K, N), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: x dtype {x.dtype} (takes float32 or "
                        "bfloat16)")
    if wq.dtype != torch.int8:
        raise TypeError(f"{NAME}: wq dtype {wq.dtype} (takes int8)")
    if scale.dtype != torch.float32 or scale.shape != (wq.shape[1],):
        raise ValueError(f"{NAME}: scale must be float32 ({wq.shape[1]},), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: out_dtype {out_dtype} (takes float32 or "
                        "bfloat16)")


def quant_matmul(x, wq, scale, *, out_dtype=torch.bfloat16):
    """W8A16 product on the card: ``x (M, K) @ (wq (K, N) * scale (N,))``.

    x float32/bfloat16 is rounded to bfloat16; wq int8 becomes bfloat16
    exactly; products accumulate in float32 and the per-output-channel
    float32 ``scale`` multiplies the sum.  Returns (M, N) in
    ``out_dtype`` (float32 or bfloat16).  Any M, K, N: ragged edges are
    masked in the kernel.
    """
    global launches
    _check(x, wq, scale, out_dtype)
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_quant_matmul(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, checks.DTYPE_CODES[x.dtype],
            checks.DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def quantize_weights(w, bits: int = 8):
    """Per-output-channel symmetric quantization of (K, N) weights:
    (q int8 (K, N), scale float32 (N,)), ``scale = max|w| / qmax +
    1e-12`` over K and ``q = clamp(round(w / scale), -qmax - 1, qmax)``
    with ``qmax = 2 ** (bits - 1) - 1`` (int4 values ride in the int8
    container)."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.amax(torch.abs(w), dim=0) / qmax + 1e-12
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)
