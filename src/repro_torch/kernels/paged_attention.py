"""Wrapper of the hand-written Hopper ``paged_attention`` kernel
(``repro_torch/csrc/paged_attention.cu``; replaces the Pallas
``repro.kernels.flash_attention.paged_attention``), and the plan both
paged reads share.

``paged_attention`` checks device, dtypes, shapes and contiguity, raises
on anything the kernel does not take, plans the launch (``paged_plan``),
allocates the output (and, split, a float32 workspace of partials) with
``torch.empty`` and launches on PyTorch's current stream without
synchronising.  It takes CUDA tensors only: ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.  ``launches`` counts
the kernel launches made through this wrapper (reset it by assignment).

``split_merge`` is the plain model of the kernel's split arithmetic: the
partials (m, l, acc) of each split and their merge in split order;
``split_reference`` runs it on a decode read's inputs as a plan cuts
them.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, checks, splits as _splits

launches = 0

NAME = "paged_attention"
BLOCKS_PER_SM = 2           # blocks a split launch aims at, at least
STAGE_BYTES = 32 * 1024     # K + V bytes of a staged chunk, at most
MAX_STAGES = 2              # chunks a block has in flight, at most
MAX_SPLITS = 64             # partials one block merges, at most
ROW_TILE = 64               # query rows a block holds, at most
SFX_TILE = 16               # suffix keys a ring stage holds


class PagedPlan(NamedTuple):
    splits: int             # blocks along a row's table
    pages: int              # table entries of a split (the last: fewer)
    chunk: int              # pages staged at once
    stages: int             # chunks in the ring: 1 to MAX_STAGES
    mma: bool               # tensor-core scores and p.v (bf16 q)
    smem: int               # dynamic shared memory of a block, bytes
    blocks: int             # K x B x tiles x splits
    workspace: int          # float32 partials, 0 unsplit
    rows: int               # query rows of a tile (tiles = ceil(G S / rows))


def smem_bytes(rows: int, hd: int, bs: int, chunk: int, stages: int,
               page_elt: int, q_elt: int, *, suffix: bool, mma: bool) -> int:
    """Dynamic shared memory of a block of ``rows`` query rows
    (``paged::layout``): the ring of stages, each a K/V chunk in the page
    type or, for the extend read, a ``SFX_TILE``-key tile of the suffix
    in q's type (whichever is larger), q and the accumulator as float32
    (rows x hd each), the score rows, the int8 row scales, three float32
    statistics a row and, on the tensor cores, the four warps' (m, l) of
    16 rows and a byte a chunk slot saying whether it holds a key."""
    nkp = -(-chunk * bs // 16) * 16 if mma else chunk * bs
    rsb = hd * page_elt + (16 if mma else 0)
    xsb = hd * q_elt + (16 if mma else 0) if suffix else 0
    half = max(nkp * rsb, SFX_TILE * xsb)
    pw = (max(nkp, SFX_TILE) if suffix else nkp) + (4 if mma else 0)
    scales = stages * 2 * nkp * 4 if page_elt == 1 else 0
    warps = 4 * 16 * 2 * 4 + -(-stages * nkp // 16) * 16 if mma else 0
    return (stages * 2 * half + 8 * rows * hd + 4 * rows * pw + scales
            + 12 * rows + warps)


@functools.lru_cache(maxsize=None)
def paged_plan(B: int, K: int, G: int, S: int, n_blk: int, bs: int,
               hd: int, page_dtype, q_dtype, sms: int,
               suffix: bool = False) -> PagedPlan:
    """How a paged read of B rows x K kv heads (G query heads each, S
    tokens a row, ``suffix`` for the extend read) over tables of
    ``n_blk`` pages of ``bs`` positions covers a card of ``sms`` SMs,
    from the shapes alone (never from lengths or pos, which live on the
    card).

    The R = G x S query rows of a kv head are cut into tiles of ``rows``
    = min(R, ``ROW_TILE``), one block each, so a block's shared memory
    does not grow with S.  Each row's table is cut into ``splits`` ranges
    of ``pages`` entries, one block each per kv head and tile: the
    longest ranges that still launch at least ``BLOCKS_PER_SM`` blocks an
    SM (the tiles counted), but at least as many keys as a tile has rows
    (or the whole table), at most ``MAX_SPLITS`` and hd splits (the
    merging block holds two floats a split and row where q and the
    accumulator were).  A block stages its range ``chunk`` pages at a
    time, at most ``STAGE_BYTES`` of K and V, in one stage (the whole
    range) or a ring of up to ``MAX_STAGES``; the extend read's suffix
    follows through the same ring ``SFX_TILE`` keys a stage.  bf16
    queries over bf16 or int8 pages with hd a multiple of 16 run on the
    tensor cores.  Fewer stages, smaller chunks, then the CUDA cores are
    tried until the block fits ``checks.SMEM_LIMIT``; the last of them
    (one page, one stage, CUDA cores) fits every hd up to 256."""
    R = G * S
    rows = max(1, min(R, ROW_TILE))
    tiles = math.ceil(R / rows)
    want = max(1, min(n_blk, hd, MAX_SPLITS,
                      math.ceil(BLOCKS_PER_SM * sms / max(B * K * tiles, 1))))
    pages = max(1, n_blk // want, min(n_blk, math.ceil(rows / bs)))
    splits = max(1, math.ceil(n_blk / pages))
    elt = torch.empty((), dtype=page_dtype).element_size()
    q_elt = torch.empty((), dtype=q_dtype).element_size()
    mma_ok = (q_dtype == torch.bfloat16 and hd % 16 == 0
              and page_dtype in (torch.bfloat16, torch.int8))
    fit = max(1, STAGE_BYTES // (2 * bs * hd * elt))
    n_chunks = math.ceil(pages / fit)
    first = math.ceil(pages / n_chunks)
    tries = [(mma, c, st)
             for mma in ([True, False] if mma_ok else [False])
             for c in range(first, 0, -1)
             for st in range(min(MAX_STAGES, math.ceil(pages / c)),
                             0 if c >= pages else 1, -1)]
    tries.append((False, 1, 1))
    for mma, chunk, stages in tries:
        smem = smem_bytes(rows, hd, bs, chunk, stages, elt, q_elt,
                          suffix=suffix, mma=mma)
        if smem <= checks.SMEM_LIMIT:
            break
    workspace = B * K * splits * R * (hd + 2) if splits > 1 else 0
    return PagedPlan(splits, pages, chunk, stages, mma, smem,
                     K * B * tiles * splits, workspace, rows)


def split_merge(s, v, split_of_key, splits: int, drop=None):
    """The kernel's split arithmetic in plain PyTorch: masked scores
    ``s`` (..., T) (-1e30 where not visible) and values ``v`` (..., T,
    hd) in float32; key t belongs to split ``split_of_key[t]``.  Each
    split's partial is (m, l, acc) of an online softmax over its keys
    (an empty split: m = -1e30, l = 0, acc = 0); the partials merge in
    split order to acc / max(l, 1e-30), so a row with no visible key is
    0.  ``drop`` leaves that split's partial out (a broken merge)."""
    neg = -1e30
    mx = torch.full(s.shape[:-1], neg, dtype=torch.float32, device=s.device)
    parts = []
    for i in range(splits):
        sm = torch.where(split_of_key == i, s, torch.full_like(s, neg))
        m = sm.amax(dim=-1)
        p = torch.where(sm > neg, torch.exp(sm - m[..., None]),
                        torch.zeros_like(sm))
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("...t,...td->...d", p, v)))
        if i != drop:
            mx = torch.maximum(mx, torch.where(parts[-1][1] > 0, m, mx))
    l = torch.zeros_like(mx)
    o = torch.zeros(s.shape[:-1] + v.shape[-1:], dtype=torch.float32,
                    device=s.device)
    for i, (m, ls, acc) in enumerate(parts):
        if i == drop:
            continue
        w = torch.where(ls > 0, torch.exp(m - mx), torch.zeros_like(m))
        l = l + ls * w
        o = o + acc * w[..., None]
    return o / torch.clamp(l, min=1e-30)[..., None]


def gathered_scores(q, k_pages, v_pages, block_tables, limit, *, scale,
                    softcap=0.0, k_scale=None, v_scale=None):
    """Float32 masked scores (B, K, S * G, n_blk * bs) of the query rows r
    = s * G + g of q (B, S, H, hd) against each row's gathered context
    (positions below ``limit`` on allocated pages; -1e30 elsewhere), and
    the gathered values (B, K, 1, n_blk * bs, hd), as
    ``ref.paged_attention_ref`` forms them."""
    B, S, H, hd = q.shape
    nB, bs, K, _ = k_pages.shape
    bt = torch.clamp(block_tables.long(), 0, nB - 1)
    kg = k_pages[bt].reshape(B, -1, K, hd).float()
    vg = v_pages[bt].reshape(B, -1, K, hd).float()
    if k_scale is not None:
        kg = kg * k_scale[bt].reshape(B, -1, K)[..., None].float()
        vg = vg * v_scale[bt].reshape(B, -1, K)[..., None].float()
    qg = q.reshape(B, S, K, H // K, hd).float()
    s = torch.einsum("bskgd,btkd->bksgt", qg, kg) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(kg.shape[1], device=q.device)
    valid = (t[None, :] < limit[:, None]) \
        & torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    return s.reshape(B, K, S * (H // K), -1), vg.transpose(1, 2)[:, :, None]


def split_reference(q, k_pages, v_pages, block_tables, lengths, plan, *,
                    scale, softcap=0.0, k_scale=None, v_scale=None,
                    drop=None):
    """``paged_attention`` as the kernel computes it, in plain float32
    PyTorch: each row's keys cut into ``plan``'s splits (table entry j
    in split j // plan.pages) and merged by ``split_merge`` (a row with
    no visible key is 0; ``drop`` leaves a split out).  Returns (B, H,
    hd) float32."""
    B, H, hd = q.shape
    s, v = gathered_scores(q[:, None], k_pages, v_pages, block_tables,
                           lengths, scale=scale, softcap=softcap,
                           k_scale=k_scale, v_scale=v_scale)
    bs = k_pages.shape[1]
    split_of_key = torch.arange(s.shape[-1], device=q.device) // bs \
        // plan.pages
    o = split_merge(s, v, split_of_key, plan.splits, drop)
    return o.reshape(B, H, hd)


def _check(q, k_pages, v_pages, block_tables, lengths, k_scale, v_scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lengths": lengths}
    if k_scale is not None or v_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    checks.on_one_cuda_device(NAME, tensors, q.device)
    if q.dim() != 3:
        raise ValueError(f"{NAME}: q must be (B, H, hd)")
    B, H, hd = q.shape
    checks.query_dtype(NAME, q)
    checks.page_pool(NAME, k_pages, v_pages, k_scale, v_scale, H, hd)
    checks.int32_rows(NAME, "block_tables", block_tables, B, 2)
    checks.int32_rows(NAME, "lengths", lengths, B, 1)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: float, softcap: float = 0.0,
                    k_scale=None, v_scale=None, plan=None):
    """Paged single-token decode attention on the card.

    q (B, H, hd) float32/bfloat16; k_pages/v_pages (num_blocks, bs, K,
    hd) float32, bfloat16 or int8 (then with float32 ``k_scale`` /
    ``v_scale`` (num_blocks, bs, K)); block_tables (B, n_blk) int32,
    -1 = unallocated; lengths (B,) int32.  Returns (B, H, hd) in
    ``q.dtype``; a row with no valid position is 0.  ``plan`` replaces
    ``paged_plan``'s for these shapes (a measurement times the CUDA-core
    instantiation beside the tensor-core one so).
    """
    global launches
    _check(q, k_pages, v_pages, block_tables, lengths, k_scale, v_scale)
    B, H, hd = q.shape
    nB, bs, K, _ = k_pages.shape
    n_blk = block_tables.shape[1]
    if plan is None:
        plan = paged_plan(B, K, H // K, 1, n_blk, bs, hd, k_pages.dtype,
                          q.dtype, _splits.sm_count(q.device))
    checks.shared_memory(NAME, plan.smem)
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None              # held until the launch is queued
    if plan.splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=q.device)
        counters = _splits.counters_for(q.device, stream, B * K)
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *checks.scale_pointers(k_scale, v_scale),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            B, H, K, hd, bs, n_blk, plan.splits, plan.pages, plan.chunk,
            plan.stages, int(plan.mma), plan.smem, float(scale),
            float(softcap),
            checks.DTYPE_CODES[q.dtype], checks.DTYPE_CODES[k_pages.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
