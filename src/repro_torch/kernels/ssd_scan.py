"""Wrapper of the hand-written Hopper ``ssd_scan`` kernel
(``repro_torch/csrc/ssd_scan.cu``; replaces the Pallas
``repro.kernels.ssd_scan.ssd_scan``).

``ssd_scan`` checks device, dtypes, shapes and strides, raises on
anything the kernel does not take, allocates the outputs with
``torch.empty`` and launches on PyTorch's current stream without
synchronising.  It takes CUDA tensors only: ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.  ``x``, ``dt``, ``B``
and ``C`` are read through their batch and row strides (their last
dimension, and x's head dimension, must be packed), so the model's
strided views into the in_proj output, and slices of a longer sequence,
go in without a copy.  ``launches`` counts the kernel
launches made through this wrapper (reset it by assignment).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "ssd_scan"
MAX_HEAD_DIM = 64           # p: 4 column groups of the 16 x 16 threads
MAX_STATE = 128             # n: 8 column groups
TILE = 64                   # rows of a chunk tile


def shared_bytes(p: int, n: int, Q: int) -> int:
    """Dynamic shared memory of one block: the (p, n) state, the C and B
    row tiles, the x tile and the score tile (rows padded by one float),
    the chunk's dt and cumsum, and the tile's row scales."""
    return 4 * (p * (n + 1) + 2 * TILE * (n + 1) + TILE * (p + 1)
                + TILE * (TILE + 1) + 2 * Q + TILE)


def _check(x, dt, A, B, C, h0, chunk):
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    checks.on_one_cuda_device(NAME, tensors, x.device, contiguous=False)
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be (b, l, h, p), got "
                         f"{tuple(x.shape)}")
    b, l, h, p = x.shape
    if dt.shape != (b, l, h) or A.shape != (h,):
        raise ValueError(f"{NAME}: dt must be {(b, l, h)} and A {(h,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if B.dim() != 3 or B.shape[:2] != (b, l) or C.shape != B.shape:
        raise ValueError(f"{NAME}: B and C must be (b, l, n) with b, l = "
                         f"{b}, {l}, got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    n = B.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: x dtype {x.dtype} (takes float32 or "
                        "bfloat16)")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{NAME}: B / C dtypes {B.dtype} / {C.dtype} differ "
                        f"from x's {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{NAME}: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if dt.stride(2) != 1 or not A.is_contiguous():
        raise ValueError(f"{NAME}: dt's heads and A must be contiguous")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError(f"{NAME}: x's (h, p) dimensions must be packed, "
                         f"strides {x.stride()}")
    if B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError(f"{NAME}: B and C columns must be contiguous")
    if h0 is not None:
        checks.on_one_cuda_device(NAME, {"h0": h0}, x.device)
        if h0.dtype != torch.float32 or h0.shape != (b, h, p, n):
            raise ValueError(f"{NAME}: h0 must be float32 {(b, h, p, n)}, "
                             f"got {h0.dtype} {tuple(h0.shape)}")
    if not 1 <= p <= MAX_HEAD_DIM or not 1 <= n <= MAX_STATE:
        raise ValueError(f"{NAME}: head_dim {p} (1..{MAX_HEAD_DIM}) or "
                         f"state {n} (1..{MAX_STATE}) out of range")
    if chunk < 1:
        raise ValueError(f"{NAME}: chunk must be >= 1, got {chunk}")
    checks.shared_memory(NAME, shared_bytes(p, n, min(chunk, max(l, 1))))


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, h0=None):
    """Mamba2 SSD chunked scan on the card.

    x (b, l, h, p) float32/bfloat16; dt (b, l, h) float32 post-softplus;
    A (h,) float32 negative; B, C (b, l, n) in x's dtype, one group shared
    by every head; h0 (b, h, p, n) float32 or None.  Chunks of
    ``Q = min(chunk, l)`` positions run in order with the float32 state
    carried; a ragged tail is a no-op pad.  Returns (y (b, l, h, p) in
    x's dtype, final state (b, h, p, n) float32).
    """
    global launches
    _check(x, dt, A, B, C, h0, chunk)
    b, l, h, p = x.shape
    n = B.shape[2]
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    if b == 0 or h == 0 or l == 0:
        hout = (h0.clone() if h0 is not None else
                torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device))
        return y, hout
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hout.data_ptr(), b, l, h, p, n, min(chunk, l),
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            checks.DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return y, hout
