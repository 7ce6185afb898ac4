#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. env      — torch / CUDA versions, the card, ``nvidia-smi`` name and
              power limit; TF32 switched off for matmuls and cuDNN.
2. build    — ``nvcc`` builds every kernel library from the sources in
              the checkout (one process per source, all at once).
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serving path's shapes (B=4, H=40, K=10, hd=128,
              bs=16, n_blk=32): bf16 / f32 pages and int8 pages with
              scales, softcap 0 and 50 (at scale 1, where it binds),
              ragged lengths, -1 table entries, an empty row.  Times the kernel, the plain
              version and a PyTorch library call, next to the bound.
4. serve    — the main path: phi3-medium-14b at full width and depth
              (bf16 weights from a seeded generator, ~29 GB) behind
              ``EdgeServingEngine`` with ``use_pallas_paged=True``; 8
              greedy requests of 16-300 prompt tokens x 32 new tokens
              through the CLI's drain loop.  Kernel launch counts are
              zeroed just before and read just after: every layer of
              every decode wave must have gone through the kernel.
5. model    — from one cache state, ``decode_step_paged`` through the
              kernel and through the gather: logits must agree within
              the stated bf16 tolerance; times one decode wave of each.
6. reference — the phi3 smoke config at float32: the engine on the card
              (hand kernel) and on the CPU (plain version) must emit
              the same greedy tokens.

Before the last line it prints the kernels JSON object and the
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "phi3-medium-14b"
SERVE = dict(max_slots=4, max_len=512, policy="priority")
N_REQ, MAX_NEW, MIN_PROMPT, MAX_PROMPT = 8, 32, 16, 300
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# kernel vs its plain version computed in float32 on the same inputs,
# per page dtype: float32 / int8 (float32 q) are the same float32 math
# summed in another order; a bfloat16 output is that float32 result
# rounded once to bfloat16, so it lies within one bfloat16 step (2**-8)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "int8": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-5)}
# softcap 50 is checked at scale 1, where scores reach tens and the cap
# binds: it must move the output by more than this, far past every TOL
CAP_MOVES = 0.1
# kernel vs gather read of the whole 40-layer model, as a share of
# max |logit|: at float32 activations only the summation order differs;
# at bf16 the gather path also rounds its probabilities to bf16, and
# every layer's rounding difference travels through the residual stream
F32_REL_TOL = 1e-3
BF16_REL_TOL = 0.1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(torch) -> None:
    """Bring a fault of the kernels launched so far to light here."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _clock_ms() -> float:
    from repro_torch.serving.telemetry import default_clock
    return default_clock() * 1e3


def cuda_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: paged_attention against its plain version
# ---------------------------------------------------------------------------

def _paged_inputs(torch, dtype, *, layers=1, B=4, H=40, K=10, hd=128,
                  bs=16, n_blk=32, lengths=None, seed=0, dev="cuda"):
    """q, a ``layers``-deep pool (nB = B * n_blk pages per layer), block
    tables with each row's pages scattered over the pool and one -1
    hole inside row 0, and ragged lengths; int8 pools come with their
    scales (symmetric per head_dim vector, as ``layers.quantize_kv``).
    Queries at 3 x randn against K at 0.5 x randn make each softmax
    peaked, so a skipped page or a wrong head moves the output far past
    the tolerances."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nB = B * n_blk
    if lengths is None:
        lengths = torch.randint(1, n_blk * bs + 1, (B,), generator=g)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    perm = torch.randperm(nB, generator=g).to(torch.int32)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        bt[b, :n] = perm[b * n_blk:b * n_blk + n]
    if int(lengths[0]) > bs:
        bt[0, 0] = -1
    q = (torch.randn((B, H, hd), generator=g) * 3.0).to(dev)
    kp = torch.randn((layers, nB, bs, K, hd), generator=g).mul_(0.5).to(dev)
    vp = torch.randn((layers, nB, bs, K, hd), generator=g).mul_(0.5).to(dev)
    scales = {}
    if dtype == torch.int8:
        def quant(x):
            s = x.abs().amax(dim=-1) / 127.0 + 1e-8
            return (torch.clamp(torch.round(x / s[..., None]), -127, 127)
                    .to(torch.int8), s.contiguous())
        kp, ks = quant(kp)
        vp, vs = quant(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    return q, kp, vp, bt.to(dev), lengths.to(dev), scales


def _bound(torch, q, kp, bt, lengths, scales):
    """Least time (ms) of one call on these inputs: every input byte the
    function needs read once (q, tables, lengths, and the K/V rows — plus
    scales — of each row's valid positions on allocated pages), the
    output written once; against the operations it does over the peak
    rate of the page type.  Returns (ms, "bytes" | "operations")."""
    B, H, hd = q.shape
    nB, bs, K, _ = kp.shape[-4:]
    n_blk = bt.shape[1]
    pos = torch.arange(n_blk * bs, device=bt.device)
    valid = (pos[None, :] < lengths[:, None].long()) \
        & torch.repeat_interleave(bt >= 0, bs, dim=1)
    tokens = int(valid.sum())
    row_bytes = 2 * K * hd * kp.element_size()
    if scales:
        row_bytes += 2 * K * 4
    nbytes = (2 * q.numel() * q.element_size() + bt.numel() * 4
              + lengths.numel() * 4 + tokens * row_bytes)
    ops = 4 * H * hd * tokens
    t_bytes = nbytes / HBM_BYTES_PER_S
    dname = str(kp.dtype).replace("torch.", "")
    t_ops = ops / PEAK_OPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_paged_attention(torch, pa, ref, timer, dev="cuda"):
    """Hold the kernel against its plain version on every case; time
    both (and a library call) at the serving path's shapes."""
    import torch.nn.functional as F
    errs, moves = {}, {}
    worst = 0.0

    def held(name, case, q, kp, vp, bt, ln, **kw):
        nonlocal worst
        out = pa.paged_attention(q, kp, vp, bt, ln, **kw)
        _sync(torch)
        exp = ref.paged_attention_ref(q.float(), kp, vp, bt, ln, **kw)
        err = float((out.float() - exp).abs().max())
        if not torch.allclose(out.float(), exp, **TOL[name]):
            raise AssertionError(f"paged_attention {case}: max abs err "
                                 f"{err} beyond tolerance {TOL[name]}")
        errs[case] = err
        worst = max(worst, err)
        return out.float()

    for seed, dtype in enumerate((torch.bfloat16, torch.float32,
                                  torch.int8)):
        name = str(dtype).replace("torch.", "")
        q, kp, vp, bt, ln, sc = _paged_inputs(torch, dtype, seed=seed,
                                              dev=dev)
        if dtype == torch.int8:
            sc = {k: v[0] for k, v in sc.items()}
        args = (q, kp[0], vp[0], bt, ln)
        held(name, f"{name}/softcap0", *args, scale=128 ** -0.5, **sc)
        capped = held(name, f"{name}/softcap50/scale1", *args, scale=1.0,
                      softcap=50.0, **sc)
        free = held(name, f"{name}/softcap0/scale1", *args, scale=1.0, **sc)
        moves[name] = float((capped - free).abs().max())
        if moves[name] <= CAP_MOVES:
            raise AssertionError(f"paged_attention {name}: softcap 50 moved "
                                 f"the output by only {moves[name]}")
    # an inactive slot (all -1, length 0) reads as 0 in the kernel
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, seed=99,
                                         dev=dev)
    bt[3] = -1
    ln[3] = 0
    out = pa.paged_attention(q, kp[0], vp[0], bt, ln, scale=128 ** -0.5)
    _sync(torch)
    if not bool((out[3] == 0).all()):
        raise AssertionError("paged_attention: an empty row is not 0")

    # timing at the serving path's shapes: bf16 pages, 4 slots with the
    # serve phase's prompt+generation lengths, one pool per layer (40
    # pools, 420 MB) cycled per call so L2 holds no layer's pages
    g = torch.Generator(device="cpu").manual_seed(7)
    lengths = torch.randint(MIN_PROMPT + 1, MAX_PROMPT + MAX_NEW + 1, (4,),
                            generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=40,
                                         lengths=lengths, seed=11,
                                         dev=dev)
    scale = 128 ** -0.5
    L = kp.shape[0]
    ms = timer(torch, lambda i: pa.paged_attention(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale))
    plain_ms = timer(torch, lambda i: ref.paged_attention_ref(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale), iters=20, warmup=3)
    # library yardstick (never called by the port): SDPA over K/V that
    # were gathered beforehand (the gather is left out of its time)
    B, H, hd = q.shape
    K = kp.shape[-2]
    btc = bt.clamp(min=0).long()
    kg = [kp[l][btc].reshape(B, -1, K, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    vg = [vp[l][btc].reshape(B, -1, K, hd).transpose(1, 2).contiguous()
          for l in range(L)]
    t = torch.arange(kg[0].shape[2], device=q.device)
    mask = ((t[None, :] < ln[:, None])
            & torch.repeat_interleave(bt >= 0, kp.shape[2], dim=1))
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kg[0], vg[0], attn_mask=mask,
                                         scale=scale, enable_gqa=True)
    lib_err = float((lib[:, :, 0].float() - ref.paged_attention_ref(
        q, kp[0], vp[0], bt, ln, scale=scale).float()).abs().max())
    library_ms = timer(torch, lambda i: F.scaled_dot_product_attention(
        q4, kg[i % L], vg[i % L], attn_mask=mask, scale=scale,
        enable_gqa=True))
    bound_ms, bound_by = _bound(torch, q, kp[0], bt, ln, {})
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }, {"errors": errs, "tolerance": TOL, "softcap50_moves": moves,
        "timed_lengths": [int(x) for x in ln.tolist()],
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
        "over pre-gathered K/V, gather excluded",
        "library_max_abs_err": lib_err}


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def serve_phase(torch, pa, serve, scale="full", dev="cuda"):
    """Drive the main path; returns (engine, cfg, phase fields)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(ARCH, scale, SERVE, dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    init_s = clock() - t0
    reqs = serve.make_requests(cfg, N_REQ, MIN_PROMPT, MAX_PROMPT, MAX_NEW,
                               SERVE["policy"])
    pa.launches = 0
    raw = serve.run_drain(eng, reqs)
    launches = pa.launches
    done = eng.completed
    if len(done) != N_REQ or any(len(r.generated) != MAX_NEW for r in done):
        raise AssertionError(f"serve: {len(done)} requests done, lengths "
                             f"{[len(r.generated) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("serve: token id outside the vocabulary")
    if eng.decode_waves == 0 or launches != cfg.num_layers * eng.decode_waves:
        raise AssertionError(
            f"serve: {launches} kernel launches for {eng.decode_waves} "
            f"decode waves x {cfg.num_layers} layers")
    eng.pool.assert_consistent()
    ttft = raw["ttft_ms"]
    fields = {
        "arch": ARCH, "depth": cfg.num_layers, "depth_cut": False,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "param_dtype": cfg.param_dtype, "init_s": init_s,
        "requests": raw["requests"], "tokens": raw["tokens"],
        "steps": raw["decode_steps"], "decode_waves": eng.decode_waves,
        "extend_waves": eng.extend_waves, "elapsed_s": raw["elapsed_s"],
        "tok_per_s": raw["tok_per_s"],
        "ms_per_step": raw["elapsed_s"] * 1e3 / raw["decode_steps"],
        "ttft_p50_ms": ttft[len(ttft) // 2],
        "ttft_p99_ms": ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "paged_attention_launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev == "cuda" else None),
    }
    return eng, cfg, fields


def _device_profile(torch, fn) -> dict:
    """One profiled call of ``fn``: wall ms, device-busy ms (sum of the
    kernels' own times), idle share, and the top ops by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _clock_ms()
        fn()
        torch.cuda.synchronize()
        wall = _clock_ms() - t0

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
    evs = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs) / 1e3
    if busy <= 0:
        return {"wall_ms": wall, "device_ms": "not measured"}
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "top_ops_device_ms": {e.key: dev_us(e) / 1e3 for e in evs[:10]}}


def model_phase(torch, M, eng, cfg, dev="cuda"):
    """Kernel read vs gather read of ``decode_step_paged`` from one cache
    state (the served pool's pages), one decode wave's time each, and
    where a decode wave's time goes.

    Held at float32 activations first (both reads then differ only in
    summation order: within F32_REL_TOL of max |logit|), then at the
    serving bf16 activations, where the gather path also rounds its
    softmax probabilities to bf16 (within BF16_REL_TOL); both bf16
    reads are reported against the float32 logits."""
    B, bs = 4, eng.block_size
    lengths = [300, 211, 97, 33]
    bt = torch.full((B, eng.n_blk), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        k = -(-(n + 1) // bs)
        bt[b, :k] = torch.arange(b * eng.n_blk, b * eng.n_blk + k)
    bt = bt.to(dev)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    cfg32 = cfg.replace(dtype="float32")

    def logits(c, use_kernel):
        out, _ = M.decode_step_paged(c, eng.params, eng.cache, tok, pos, bt,
                                     use_kernel)
        out = out[:, 0].float()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("model: non-finite logits")
        return out

    ref32, ker32 = logits(cfg32, False), logits(cfg32, True)
    ker16, gat16 = logits(cfg, True), logits(cfg, False)
    scale = float(ref32.abs().max())

    def dmax(a, b):
        return float((a - b).abs().max())
    d32, d16 = dmax(ker32, ref32), dmax(ker16, gat16)
    if d32 > F32_REL_TOL * scale:
        raise AssertionError(f"model: float32 kernel vs gather logits "
                             f"differ by {d32} (max |logit| {scale})")
    if d16 > BF16_REL_TOL * scale:
        raise AssertionError(f"model: bf16 kernel vs gather logits differ "
                             f"by {d16} (max |logit| {scale})")

    def agree(a, b):
        return f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{B}"
    wave = {k: cuda_ms(torch, lambda i, k=k: M.decode_step_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, k), iters=10, warmup=2)
        for k in (True, False)}
    prof = _device_profile(torch, lambda: M.decode_step_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, True))
    return {"lengths": lengths, "max_abs_logit_f32": scale,
            "f32_kernel_vs_gather": d32, "f32_tolerance":
            f"{F32_REL_TOL} x max |logit|",
            "bf16_kernel_vs_gather": d16, "bf16_tolerance":
            f"{BF16_REL_TOL} x max |logit|",
            "bf16_kernel_vs_f32": dmax(ker16, ref32),
            "bf16_gather_vs_f32": dmax(gat16, ref32),
            "argmax_agree_bf16_kernel_gather": agree(ker16, gat16),
            "argmax_agree_bf16_kernel_f32": agree(ker16, ref32),
            "decode_wave_ms_kernel": wave[True],
            "decode_wave_ms_gather": wave[False],
            "decode_wave_profile": prof}


def reference_phase(torch, M, serve_mod, get_smoke_config):
    """Small input: the engine on the card (hand kernel) and on the CPU
    (plain version) emit the same greedy tokens at float32."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = ServeConfig(max_slots=3, max_len=192, prefix_cache=False,
                       use_pallas_paged=True, policy="priority")
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = EdgeServingEngine(cfg, _to(params, dev), scfg, device=dev)
        reqs = serve_mod.make_requests(cfg, 6, 4, 150, 8, "priority")
        serve_mod.run_drain(eng, reqs)
        tokens[dev] = {r.uid: list(r.generated) for r in eng.completed}
    if tokens["cpu"] != tokens["cuda"] or len(tokens["cuda"]) != 6:
        raise AssertionError(f"reference: card tokens {tokens['cuda']} != "
                             f"CPU tokens {tokens['cpu']}")
    return {"arch": f"{ARCH} smoke, float32", "requests": 6,
            "tokens_equal": True}


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    clock = serve.default_clock
    t_start = clock()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=kind, nvidia_smi=smi, python=sys.version.split()[0])

    t0 = clock()
    libs = build.build_all()
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "Used" in ln or "spill" in ln]
             for n, p in libs.items() if p.with_suffix(".log").exists()}
    emit("build", seconds=clock() - t0,
         libraries={n: str(p.relative_to(ROOT)) for n, p in libs.items()},
         ptxas=ptxas)

    t0 = clock()
    pa_row, pa_detail = check_paged_attention(torch, pa, ref, cuda_ms)
    emit("kernels", seconds=clock() - t0, paged_attention=dict(pa_row,
                                                                **pa_detail))

    t0 = clock()
    eng, cfg, fields = serve_phase(torch, pa, serve)
    pa_row["launches"] = fields["paged_attention_launches"]
    emit("serve", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_phase(torch, M, eng, cfg)
    emit("model", seconds=clock() - t0, **fields)
    del eng
    torch.cuda.empty_cache()

    t0 = clock()
    fields = reference_phase(torch, M, serve, get_smoke_config)
    emit("reference", seconds=clock() - t0, **fields)

    emit("done", seconds=clock() - t_start)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: pa_row[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
