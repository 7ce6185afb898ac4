"""Wrapper of the hand-written Hopper ``ssd_scan`` kernel
(``repro_torch/csrc/ssd_scan.cu``; replaces the Pallas
``repro.kernels.ssd_scan.ssd_scan``).

``ssd_scan`` checks device, dtypes, shapes and strides, raises on
anything the kernel does not take, allocates the outputs and a float32
workspace with ``torch.empty`` and launches on PyTorch's current stream
without synchronising.  It takes CUDA tensors only: ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.  ``x``,
``dt``, ``B`` and ``C`` are read through their batch and row strides
(their last dimension, and x's head dimension, must be packed), so the
model's strided views into the in_proj output, and slices of a longer
sequence, go in without a copy.  ``launches`` counts the calls that
launched the kernel, one per call (a call is four CUDA launches: local
states, the pass over chunks, the score tiles, y); reset it by
assignment.

``ssd_plan`` sizes the launches' shared memory and workspace from the
shapes alone.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, checks

launches = 0

NAME = "ssd_scan"
MAX_HEAD_DIM = 64           # p: 4 warps x 16 rows
MAX_STATE = 128             # n: 8 k steps of 16
TILE = 64                   # rows of a chunk tile
STATE_SLICE = 64            # state columns of a local-state block


def _pieces(dtype) -> tuple:
    """(bf16 pieces of a float32 operand, of an input x / B / C): the
    bf16 instantiation takes hi + lo and the inputs as they are; the
    float32 one three pieces of everything."""
    return (2, 1) if dtype == torch.bfloat16 else (3, 3)


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def state_smem(p: int, n: int, Q: int, dtype=torch.bfloat16) -> int:
    """Shared memory of a local-state block: the scaled x tile and the B
    tile (64 rows, bf16 pieces, rows padded by 8), the chunk's dt and
    cumsum, a tile's row weights and the scan's warp sums
    (``csrc/ssd_scan.cu::state_smem``)."""
    nd, ni = _pieces(dtype)
    n16 = _pad16(min(n, STATE_SLICE))
    return (2 * (nd * TILE * (_pad16(p) + 8) + ni * TILE * (n16 + 8))
            + 4 * (2 * Q + TILE + 8))


def score_smem(n: int, dtype=torch.bfloat16) -> int:
    """Shared memory of a score block: a C and a B tile
    (``csrc/ssd_scan.cu::score_smem``)."""
    return 2 * 2 * _pieces(dtype)[1] * TILE * (_pad16(n) + 8)


def out_smem(p: int, n: int, dtype=torch.bfloat16) -> int:
    """Shared memory of an output block: the C tile, then the larger of
    the carried state (inter term) and the x tile, and the rows' cumsums
    and dt (``csrc/ssd_scan.cu::out_smem``)."""
    nd, ni = _pieces(dtype)
    p16, n16 = _pad16(p), _pad16(n)
    c_tile = ni * TILE * (n16 + 8)
    keys = ni * TILE * (p16 + 8)
    return 2 * (c_tile + max(nd * p16 * (n16 + 8), keys)) + 4 * 3 * TILE


def shared_bytes(p: int, n: int, Q: int, dtype=torch.bfloat16) -> int:
    """The most shared memory any block of a call takes: the chunk's dt
    and cumsum grow with Q."""
    return max(state_smem(p, n, Q, dtype), score_smem(n, dtype),
               out_smem(p, n, dtype))


class SsdPlan(NamedTuple):
    chunks: int             # nc = ceil(l / Q)
    row_tiles: int          # T = ceil(Q / 64) tiles of a chunk
    state_smem: int
    score_smem: int
    out_smem: int
    workspace: int          # float32: b x nc x (h (p n + Q + 1) + pairs 4096)


@functools.lru_cache(maxsize=None)
def ssd_plan(b: int, l: int, h: int, p: int, n: int, Q: int,
             dtype=torch.bfloat16) -> SsdPlan:
    """The shared memory of the four launches over a scan of chunk ``Q``
    and their float32 workspace: shapes only.

    The launches' grids (``csrc/ssd_scan.cu::launch``): local states, a
    block per (b, chunk, head, 64 state columns); the pass, a thread per
    (b, h, state element); scores, a block per (b, chunk, pair of 64-row
    tiles j <= i), C B^T once for every head; output, a block per (b,
    chunk, 64-row tile, head): at mamba2-370m's width that is 512 blocks
    for one row of 1024 positions, about four an SM."""
    nc = math.ceil(l / Q)
    tiles = math.ceil(Q / TILE)
    pairs = tiles * (tiles + 1) // 2
    return SsdPlan(nc, tiles, state_smem(p, n, Q, dtype),
                   score_smem(n, dtype), out_smem(p, n, dtype),
                   b * nc * (h * (p * n + Q + 1) + pairs * TILE * TILE))


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
    return b, l, h, p, n


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, h0=None):
    """Mamba2 SSD chunked scan on the card.

    x (b, l, h, p) float32/bfloat16; dt (b, l, h) float32 post-softplus;
    A (h,) float32 negative; B, C (b, l, n) in x's dtype, one group shared
    by every head; h0 (b, h, p, n) float32 or None.  Chunks of
    ``Q = min(chunk, l)`` positions: their local states in parallel, the
    float32 state passed from chunk to chunk, then y in parallel; a
    ragged tail is a no-op pad.  Returns (y (b, l, h, p) in x's dtype,
    final state (b, h, p, n) float32).
    """
    global launches
    b, l, h, p, n = _check(x, dt, A, B, C, h0, chunk)
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    if b == 0 or h == 0 or l == 0:
        hout = (h0.clone() if h0 is not None else
                torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device))
        return y, hout
    Q = min(chunk, l)
    plan = ssd_plan(b, l, h, p, n, Q, x.dtype)
    for smem in (plan.state_smem, plan.score_smem, plan.out_smem):
        checks.shared_memory(NAME, smem)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hout.data_ptr(), ws.data_ptr(), b, l, h, p, n, Q,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            checks.DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return y, hout
