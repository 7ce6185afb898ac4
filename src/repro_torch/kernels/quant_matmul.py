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

For M <= 8 the kernel splits K across blocks as ``gemv_plan`` says; a
split call takes a float32 workspace of partial sums (``torch.empty``)
and the arrival counters of its (device, stream) (``splits``), so its
partials are summed in a fixed order.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, checks, splits as _splits

launches = 0

NAME = "quant_matmul"
GEMV_MAX_M = 8              # rows the one-pass kernel takes
GEMV_THREADS = 256          # threads of a block: column lanes x k lanes
GEMV_WIDE_N = 4096          # outputs this wide take 256-column blocks
GEMV_ROW_COST = 128         # a block's fixed cost, in k rows of work


class GemvPlan(NamedTuple):
    cols: int               # output columns of a block: 64 or 256
    splits: int             # slices of K, one block each per column block
    k_chunk: int            # rows of a slice (the last may be shorter)
    blocks: int             # column blocks x splits
    workspace: int          # float32 partials: splits x M x N, 0 unsplit


@functools.lru_cache(maxsize=None)
def gemv_plan(M: int, K: int, N: int, sms: int) -> GemvPlan:
    """How the M <= 8 kernel covers (K, N) on a card of ``sms`` SMs.

    Outputs at least ``GEMV_WIDE_N`` wide take blocks of 256 columns (16
    column lanes x 16 k lanes: each warp reads 256 contiguous bytes of
    two rows); narrower ones blocks of 64 (4 x 64), so that K is not cut
    into slices too thin to pay for their partial sums.  Blocks of 256
    threads hold two to an SM (one for M > 4, whose 8-row accumulator
    needs the registers), so one round of resident blocks is that many
    times ``sms``.  Slices are whole multiples of the k lanes.  Among the
    cuts that launch at least two blocks an SM (or cut K as finely as it
    goes), the one with the least estimated time wins: rounds of
    resident blocks x (rows a block reads + its fixed cost of
    ``GEMV_ROW_COST`` rows); fewer splits on a tie."""
    cols = 256 if N >= GEMV_WIDE_N else 64
    lanes = GEMV_THREADS // (cols // 16)
    n_cols = math.ceil(N / cols)
    slots = (2 if M <= 4 else 1) * sms
    finest = math.ceil(K / lanes)
    best = None
    for want in range(1, finest + 1):
        chunk = lanes * math.ceil(K / (lanes * want))
        splits = math.ceil(K / chunk)
        if splits != want:
            continue          # the same cut as a smaller count
        blocks = n_cols * splits
        if blocks < 2 * sms and splits < finest:
            continue
        cost = math.ceil(blocks / slots) * (chunk + GEMV_ROW_COST)
        if best is None or cost < best[0]:
            best = (cost, GemvPlan(cols, splits, chunk, blocks,
                                   splits * M * N if splits > 1 else 0))
    return best[1]


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = counters = None              # held until the launch is queued
    cols, splits, k_chunk = 64, 1, K
    if M <= GEMV_MAX_M:
        plan = gemv_plan(M, K, N, _splits.sm_count(x.device))
        cols, splits, k_chunk = plan.cols, plan.splits, plan.k_chunk
        if splits > 1:
            ws = torch.empty(plan.workspace, dtype=torch.float32,
                             device=x.device)
            counters = _splits.counters_for(x.device, stream,
                                               math.ceil(N / cols))
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        err = lib.repro_quant_matmul(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            M, K, N, cols, splits, k_chunk,
            checks.DTYPE_CODES[x.dtype], checks.DTYPE_CODES[out_dtype],
            stream)
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
