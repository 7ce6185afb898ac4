"""Plain PyTorch versions of the hand-written kernels (the allclose
ground truth).

Each function mirrors its counterpart in ``repro.kernels.ref`` line for
line: written in the most obvious way (gather, masked full softmax), so
a kernel is held against independent math, not a refactor of itself.
``kernels.ops`` sends CPU tensors here; a CUDA tensor always goes to
the kernel.
"""
from __future__ import annotations

import torch


def quant_matmul_ref(x, wq, scale, out_dtype=torch.bfloat16):
    """x (M, K) @ dequant(wq (K, N) int8, scale (N,)): the weight
    dequantized to float32, a float32 product, then the cast.  x is not
    rounded to bfloat16 here (the kernel rounds it, as the TPU kernel
    does)."""
    w = wq.float() * scale[None, :].float()
    out = torch.matmul(x.float(), w)
    return out.to(out_dtype)


def flash_attention_ref(q, k, v, *, scale, window: int = 0,
                        softcap: float = 0.0):
    """Masked full-softmax causal GQA attention (the obvious way).

    q (B,S,H,hd); k, v (B,T,K,hd); positions count from 0 on both axes.
    Float32 math (float64 when q is float64, the reference the card
    checks hold the kernel to): scores, the softcap before the mask,
    -1e30 for masked scores, softmax, the product with v; output in
    ``q.dtype``.  A query row with no visible key (only when T < S with
    a window) takes the softmax of an all-masked row, the mean of v,
    exactly like the JAX oracle (the hand kernel returns 0 there, as the
    TPU kernel does).
    """
    B, S, H, hd = q.shape
    _, T, Kh, _ = k.shape
    G = H // Kh
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, S, Kh, G, hd).to(ct)
    kf = k.to(ct)
    vf = v.to(ct)
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, vf)
    return out.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale, softcap: float = 0.0,
                        k_scale=None, v_scale=None):
    """Gather-based paged-attention decode read (the obvious way).

    q (B,H,hd) one query token per sequence; k_pages/v_pages
    (num_blocks, bs, K, hd) shared page pool; block_tables (B, n_blk)
    int32 physical ids (-1 = unallocated); lengths (B,) valid context
    token counts — row b attends logical positions [0, lengths[b]).
    ``k_scale``/``v_scale`` (num_blocks, bs, K): per-(page, offset,
    kv-head) dequant scales for an int8 pool — the gathered pages are
    dequantized densely before the softmax.  Returns (B, H, hd).

    A row with no valid position (all -1 or ``lengths`` 0) takes a
    softmax over an all-masked row: the mean of the clipped page 0,
    exactly like the JAX oracle (the hand kernel returns 0 there).
    """
    Bq, H, hd = q.shape
    nB, bs, Kh, _ = k_pages.shape
    G = H // Kh
    bt = torch.clamp(block_tables.long(), 0, nB - 1)
    kg = k_pages[bt].reshape(Bq, -1, Kh, hd).float()
    vg = v_pages[bt].reshape(Bq, -1, Kh, hd).float()
    if k_scale is not None:
        kg = kg * k_scale[bt].reshape(Bq, -1, Kh)[..., None].float()
        vg = vg * v_scale[bt].reshape(Bq, -1, Kh)[..., None].float()
    qg = q.reshape(Bq, Kh, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, kg) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(kg.shape[1], device=q.device)
    valid = (t[None, :] < lengths[:, None]) \
        & torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vg)
    return out.reshape(Bq, H, hd).to(q.dtype)


def paged_extend_attention_ref(q, k_pages, v_pages, k_new, v_new,
                               block_tables, pos, *, scale,
                               softcap: float = 0.0,
                               k_scale=None, v_scale=None):
    """Gather-based multi-token extend read (the obvious way).

    q (B,S,H,hd): S new tokens per row at absolute positions
    ``pos + i``; k_new/v_new (B,S,K,hd): the suffix K/V those tokens
    attend causally (already round-tripped by the caller on a quantized
    pool); k_pages/v_pages (num_blocks, bs, K, hd) with optional
    per-(page, offset, kv-head) ``k_scale``/``v_scale``; block_tables
    (B, n_blk) int32 (-1 = unallocated); pos (B,) int32 — context
    positions ``< pos`` on allocated pages are visible, everything at or
    beyond ``pos`` is masked (the pre-write view).  Returns (B, S, H, hd)
    in ``q.dtype``.  The suffix's diagonal is always visible, so no row
    is empty.
    """
    B, S, H, hd = q.shape
    nB, bs, Kh, _ = k_pages.shape
    G = H // Kh
    bt = torch.clamp(block_tables.long(), 0, nB - 1)
    kg = k_pages[bt].reshape(B, -1, Kh, hd).float()
    vg = v_pages[bt].reshape(B, -1, Kh, hd).float()
    if k_scale is not None:
        kg = kg * k_scale[bt].reshape(B, -1, Kh)[..., None].float()
        vg = vg * v_scale[bt].reshape(B, -1, Kh)[..., None].float()
    L = kg.shape[1]
    k_all = torch.cat([kg, k_new.float()], dim=1)
    v_all = torch.cat([vg, v_new.float()], dim=1)
    qg = q.reshape(B, S, Kh, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k_all) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(L, device=q.device)
    ctx_ok = (t[None, :] < pos[:, None]) \
        & torch.repeat_interleave(block_tables >= 0, bs, dim=1)   # (B, L)
    i = torch.arange(S, device=q.device)
    causal = i[None, :] <= i[:, None]                             # (S, S)
    mask = torch.cat(
        [torch.broadcast_to(ctx_ok[:, None, :], (B, S, L)),
         torch.broadcast_to(causal, (B, S, S))], dim=-1)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v_all)
    return out.reshape(B, S, H, hd).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C, h0=None):
    """Sequential SSD recurrence (the definition, O(l) steps).

    x (b,l,h,p); dt (b,l,h) post-softplus; A (h,) negative; B, C (b,l,n)
    (one group, shared by every head); h0 (b,h,p,n) or None.  Per step
    the float32 state decays by ``exp(dt * A)`` and takes
    ``dt * x ⊗ B``; ``y = state · C``.  Returns (y (b,l,h,p) in
    ``x.dtype``, final state (b,h,p,n) float32).  No chunking: the
    chunk width of the kernel changes the summation order only.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    hs = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), B.float(), C.float(), \
        A.float()
    ys = []
    for t in range(l):
        a = torch.exp(dtf[:, t] * Af)                        # (b,h)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        hs = hs * a[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), hs
