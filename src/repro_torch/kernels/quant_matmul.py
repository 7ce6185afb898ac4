"""Wrapper of the hand-written Hopper ``quant_matmul`` kernel
(``repro_torch/csrc/quant_matmul.cu``; replaces the Pallas
``repro.kernels.quant_matmul.quant_matmul``), and the host helper
``quantize_weights``.

``quant_matmul`` checks device, dtypes, shapes and contiguity, raises on
anything the kernel does not take, allocates the output with
``torch.empty`` and launches on PyTorch's current stream without
synchronising.  It takes CUDA tensors only: ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.  ``launches`` counts
the calls that launched the kernel, one per call (an M > 8 call is two
CUDA launches: the pack, then the product); reset it by assignment.

For M <= 8 the one-pass kernel splits K across blocks as ``gemv_plan``
says; for M > 8 the tensor-core kernel takes an output tile and a split
of K from ``mma_plan``, and x is first packed (rounded to bfloat16, in
the kernel's tile order) into scratch of ``mma_pack_bytes``.  A split
call takes a float32 workspace of partial sums (``torch.empty``) and the
arrival counters of its (device, stream) (``splits``), so its partials
are summed in a fixed order.
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
# the M > 8 kernel: K steps of MMA_BK rows through an x ring and a weight
# ring (mma_stages_x and MMA_STAGES_W stages), output tiles of MMA_TILES
MMA_BK = 64
MMA_STAGES_W = 4
MMA_W_PAD = 64              # bytes past each staged weight row
MMA_TILES = ((256, 128), (128, 256), (128, 128), (64, 256), (64, 128))


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


class MmaPlan(NamedTuple):
    rows: int               # output rows of a block: 64, 128 or 256
    cols: int               # output columns of a block: 128 or 256
    splits: int             # slices of K, one block each per tile
    k_chunk: int            # rows of a slice, a multiple of MMA_BK
    tiles: int              # row blocks x column blocks
    blocks: int             # tiles x splits
    workspace: int          # float32 partials: splits x M x N, 0 unsplit
    smem: int               # dynamic shared memory of a block, bytes


def mma_stages_x(rows: int) -> int:
    """Stages of the M > 8 kernel's x ring: 4 of a 256-row tile's 32
    KB, 5 otherwise."""
    return 4 if rows == 256 else 5


def mma_smem(rows: int, cols: int) -> int:
    """Dynamic shared memory of one M > 8 block: the x ring (rows x 64
    bf16 a stage), the int8 weight ring (64 rows of cols + MMA_W_PAD
    bytes a stage), two converted bf16 weight tiles, the rings' full
    and empty barriers and 1 KB to align the swizzled tiles
    (``csrc/quant_matmul.cu::mma_smem``)."""
    stages_x = mma_stages_x(rows)
    return (1024 + stages_x * rows * 2 * MMA_BK
            + MMA_STAGES_W * MMA_BK * (cols + MMA_W_PAD)
            + 2 * MMA_BK * cols * 2 + 2 * 8 * (stages_x + MMA_STAGES_W))


def mma_pack_bytes(M: int, K: int, rows: int) -> int:
    """Bytes of x packed for the M > 8 kernel: ceil(M / rows) x
    ceil(K / 64) tiles of rows x 64 bf16."""
    return math.ceil(M / rows) * math.ceil(K / MMA_BK) * rows * 2 * MMA_BK


@functools.lru_cache(maxsize=None)
def mma_plan(M: int, K: int, N: int, sms: int) -> MmaPlan:
    """How the M > 8 kernel covers (M, N) and K on a card of ``sms`` SMs.

    Up to 64 rows take 64-row tiles (a 16-row prefill does not compute
    128 rows) 256 columns wide from N = GEMV_WIDE_N (128 below), and K
    is cut into slices of whole 64-row steps until the blocks fill the
    card: these calls are bound by the weight bytes.  More rows take
    256 x 128 tiles, or 128-row ones where fewer rows are padded or 256
    rows would leave half the SMs idle; a 128-row tile is 256 columns
    wide when that still gives every SM a tile.  Above 64 rows K is not
    cut: on an H100 every split timed slower than none at M = 512 and
    2048 (its partials' round trip costs more than idle SMs)."""
    steps_k = math.ceil(K / MMA_BK)
    if M <= 64:
        rows, cols = 64, (256 if N >= GEMV_WIDE_N else 128)
    else:
        rows, cols = 256, 128
        if (math.ceil(M / 128) * 128 < math.ceil(M / 256) * 256
                or math.ceil(M / 256) * math.ceil(N / 128) < sms / 2):
            rows = 128
            cols = 256 if math.ceil(M / 128) * math.ceil(N / 256) >= sms \
                else 128
    tiles = math.ceil(M / rows) * math.ceil(N / cols)
    want = min(steps_k, math.ceil(sms / tiles)) if rows == 64 else 1
    chunk = MMA_BK * math.ceil(steps_k / want)
    splits = math.ceil(K / chunk)
    return MmaPlan(rows, cols, splits, chunk, tiles, tiles * splits,
                   splits * M * N if splits > 1 else 0, mma_smem(rows, cols))


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
    ws = counters = xp = None         # held until the launch is queued
    sms = _splits.sm_count(x.device)
    if M <= GEMV_MAX_M:
        plan = gemv_plan(M, K, N, sms)
        rows, n_counters = 0, math.ceil(N / plan.cols)
    else:
        plan = mma_plan(M, K, N, sms)
        rows, n_counters = plan.rows, plan.tiles
        xp = torch.empty(mma_pack_bytes(M, K, rows), dtype=torch.uint8,
                         device=x.device)
    cols, splits, k_chunk = plan.cols, plan.splits, plan.k_chunk
    if splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=x.device)
        counters = _splits.counters_for(x.device, stream, n_counters)
    lib = build.load(NAME)
    with torch.cuda.device(x.device):
        err = lib.repro_quant_matmul(
            x.data_ptr(), None if xp is None else xp.data_ptr(),
            wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            M, K, N, rows, cols, splits, k_chunk,
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
