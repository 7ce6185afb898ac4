"""Wrapper of the hand-written Hopper ``flash_attention`` kernel
(``repro_torch/csrc/flash_attention.cu``; replaces the Pallas
``repro.kernels.flash_attention.flash_attention``).

``flash_attention`` checks device, dtypes, shapes, contiguity and
alignment, raises on anything the kernel does not take, allocates the
output with ``torch.empty`` and launches on PyTorch's current stream
without synchronising.  It takes CUDA tensors only: ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.  Unlike the
TPU kernel's block picker, no length has to divide a tile: ragged S and
T tails are masked inside the kernel.  ``launches`` counts the kernel
launches made through this wrapper (reset it by assignment).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "flash_attention"
TILE = 64                   # key rows of a tile (and query rows, float32)
PAD = 4                     # floats added to each staged float32 row
BF16_QUERY_ROWS = 128       # query rows of a bfloat16 block (8 warps x 16)
BF16_STAGES = 2             # (K, V) tiles in the bfloat16 ring
BF16_PAD = 8                # bfloat16 added to each staged row


def padded_head_dim(hd: int) -> int:
    """The instantiation a head_dim runs in: 64, 128 or 256."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def shared_bytes(hd: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block.  bfloat16: the query tile and
    a two-stage ring of key and value tiles, all bfloat16 (rows padded).
    float32: the query, key and value tiles as float32 (rows padded) and
    the probability tile."""
    hdp = padded_head_dim(hd)
    if dtype == torch.bfloat16:
        rows = BF16_QUERY_ROWS + BF16_STAGES * 2 * TILE
        return 2 * rows * (hdp + BF16_PAD)
    return 4 * (3 * TILE * (hdp + PAD) + TILE * (TILE + 4))


def _check(q, k, v, window, softcap):
    checks.on_one_cuda_device(NAME, {"q": q, "k": k, "v": v}, q.device)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{NAME}: q must be (B, S, H, hd) and k, v "
                         f"(B, T, K, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, T, K, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd:
        raise ValueError(f"{NAME}: k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{NAME}: {H} query heads do not group over {K} "
                         "kv heads")
    checks.query_dtype(NAME, q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: k / v dtypes {k.dtype} / {v.dtype} differ "
                        f"from q's {q.dtype}")
    if hd > checks.MAX_HEAD_DIM:
        raise ValueError(f"{NAME}: head_dim {hd} > {checks.MAX_HEAD_DIM}")
    # the kernel stages rows in 16-byte vector loads
    if (hd * q.element_size()) % 16:
        raise ValueError(f"{NAME}: a row of head_dim {hd} {q.dtype} is not "
                         "a whole number of 16-byte vectors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} is not 16-byte aligned")
    if window < 0 or softcap < 0:
        raise ValueError(f"{NAME}: window {window} and softcap {softcap} "
                         "must be >= 0")
    if H > 65535 or B > 65535:
        raise ValueError(f"{NAME}: grid of {H} heads x {B} rows too large")
    checks.shared_memory(NAME, shared_bytes(hd, q.dtype))


def flash_attention(q, k, v, *, scale: float, window: int = 0,
                    softcap: float = 0.0):
    """Causal GQA attention on the card (see the .cu header).

    q (B, S, H, hd), k and v (B, T, K, hd), float32 or bfloat16, all of
    one type; positions count from 0 on both axes; ``window`` > 0 adds
    a sliding window, ``softcap`` > 0 a logit tanh cap.  Returns
    (B, S, H, hd) in ``q.dtype``; a query row with no visible key (only
    when T < S) is 0.
    """
    global launches
    window, softcap = int(window), float(softcap)
    _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, float(scale), softcap, window,
            checks.DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
