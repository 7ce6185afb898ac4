"""Wrapper of the hand-written Hopper ``paged_extend_attention`` kernel
(``repro_torch/csrc/paged_extend_attention.cu``; replaces the Pallas
``repro.kernels.flash_attention.paged_extend_attention``).

``paged_extend_attention`` checks device, dtypes, shapes and
contiguity, raises on anything the kernel does not take, plans the launch (``paged_attention.paged_plan`` with the
suffix), allocates the output (and, split, a float32 workspace of
partials) with ``torch.empty`` and launches on PyTorch's current stream
without synchronising.  It takes CUDA tensors only: ``kernels.ops``
routes CPU tensors to the plain version in ``kernels.ref``.
``launches`` counts the kernel launches made through this wrapper (reset
it by assignment).  ``split_reference`` is the plain model of the
kernel's split arithmetic over row tiles.  Every S the engine sends
plans a block within ``checks.SMEM_LIMIT``: a block holds one tile of at
most ``paged_attention.ROW_TILE`` query rows and streams the suffix.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, checks, splits as _splits
from repro_torch.kernels.paged_attention import (gathered_scores,
                                                 paged_plan, split_merge)

launches = 0

NAME = "paged_extend_attention"


def split_reference(q, k_pages, v_pages, k_new, v_new, block_tables, pos,
                    plan, *, scale, softcap=0.0, k_scale=None,
                    v_scale=None, drop=None):
    """``paged_extend_attention`` as the kernel computes it, in plain
    float32 PyTorch: the context keys cut into ``plan``'s splits (table
    entry j in split j // plan.pages), the S causal suffix keys in the
    last split, merged by ``split_merge`` (``drop`` leaves a split out).
    Returns (B, S, H, hd) float32."""
    B, S, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    s, v = gathered_scores(q, k_pages, v_pages, block_tables, pos,
                           scale=scale, softcap=softcap, k_scale=k_scale,
                           v_scale=v_scale)
    qg = q.reshape(B, S, K, G, hd).float()
    sx = torch.einsum("bskgd,btkd->bksgt", qg, k_new.float()) * scale
    if softcap > 0:
        sx = softcap * torch.tanh(sx / softcap)
    i = torch.arange(S, device=q.device)
    sx = torch.where((i[None, :] <= i[:, None])[:, None, :], sx, -1e30)
    # the keys a row's tile streams: t below its last token + 1
    r = torch.arange(S * G, device=q.device)
    tile_end = torch.clamp((r // plan.rows + 1) * plan.rows, max=S * G)
    seen = i[None, :] < ((tile_end - 1) // G + 1)[:, None]       # (R, S)
    sx = torch.where(seen, sx.reshape(B, K, S * G, S), -1e30)
    s = torch.cat([s, sx], dim=-1)
    v = torch.cat([v, v_new.float().transpose(1, 2)[:, :, None]], dim=-2)
    n_ctx = block_tables.shape[1] * k_pages.shape[1]
    split_of_key = torch.cat([
        torch.arange(n_ctx, device=q.device) // k_pages.shape[1]
        // plan.pages,
        torch.full((S,), plan.splits - 1, device=q.device)])
    o = split_merge(s, v, split_of_key, plan.splits, drop)
    return o.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, hd)


def _check(q, k_pages, v_pages, k_new, v_new, block_tables, pos, k_scale,
           v_scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "k_new": k_new, "v_new": v_new,
               "block_tables": block_tables, "pos": pos}
    if k_scale is not None or v_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    checks.on_one_cuda_device(NAME, tensors, q.device)
    if q.dim() != 4:
        raise ValueError(f"{NAME}: q must be (B, S, H, hd)")
    B, S, H, hd = q.shape
    checks.query_dtype(NAME, q)
    _, bs, K = checks.page_pool(NAME, k_pages, v_pages, k_scale, v_scale,
                                H, hd)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, S, K, hd) or t.dtype != q.dtype:
            raise ValueError(f"{NAME}: {name} must be {q.dtype} "
                             f"{(B, S, K, hd)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        # the suffix is staged in 16-byte copies
        if (hd * t.element_size()) % 16 or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} rows of head_dim {hd} "
                             f"{t.dtype} are not whole 16-byte vectors at "
                             "a 16-byte aligned base")
    checks.int32_rows(NAME, "block_tables", block_tables, B, 2)
    checks.int32_rows(NAME, "pos", pos, B, 1)


def paged_extend_attention(q, k_pages, v_pages, k_new, v_new, block_tables,
                           pos, *, scale: float, softcap: float = 0.0,
                           k_scale=None, v_scale=None):
    """Paged multi-token extend attention on the card.

    q (B, S, H, hd) float32/bfloat16 at absolute positions ``pos + i``;
    k_new/v_new (B, S, K, hd) in q's dtype, the suffix the queries
    attend causally; k_pages/v_pages (num_blocks, bs, K, hd) float32,
    bfloat16 or int8 (then with float32 ``k_scale`` / ``v_scale``
    (num_blocks, bs, K)), read as the pre-write view masked below
    ``pos``; block_tables (B, n_blk) int32, -1 = unallocated; pos (B,)
    int32.  Returns (B, S, H, hd) in ``q.dtype``.
    """
    global launches
    _check(q, k_pages, v_pages, k_new, v_new, block_tables, pos, k_scale,
           v_scale)
    B, S, H, hd = q.shape
    nB, bs, K, _ = k_pages.shape
    n_blk = block_tables.shape[1]
    plan = paged_plan(B, K, H // K, max(S, 1), n_blk, bs, hd,
                      k_pages.dtype, q.dtype, _splits.sm_count(q.device),
                      suffix=True)
    checks.shared_memory(NAME, plan.smem)
    out = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None              # held until the launch is queued
    if plan.splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=q.device)
        counters = _splits.counters_for(
            q.device, stream, B * K * -(-S * (H // K) // plan.rows))
    lib = build.load(NAME)
    with torch.cuda.device(q.device):
        err = lib.repro_paged_extend_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *checks.scale_pointers(k_scale, v_scale),
            k_new.data_ptr(), v_new.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            B, S, H, K, hd, bs, n_blk, plan.rows, plan.splits, plan.pages,
            plan.chunk,
            plan.stages, int(plan.mma), plan.smem,
            float(scale), float(softcap),
            checks.DTYPE_CODES[q.dtype], checks.DTYPE_CODES[k_pages.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
