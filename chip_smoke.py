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
              bs=16, n_blk=32; S=4 new tokens for the extend read):
              bf16 / f32 pages and int8 pages with scales under f32
              and under bf16 queries (the pair int8 serving runs),
              softcap 0 and 50 (at scale 1, where it binds), ragged
              lengths, -1 table entries, an empty row (decode) and a
              row at pos 0 (extend); lengths and pos on the split plan's
              boundaries, one page short of them and with a -1 hole
              that empties a split, two calls bitwise equal, and a
              plain merge without the last split's partial shown to
              fall outside the tolerance; gemma3-1b's global-layer shape
              (H=4, K=1, hd=256) and the shapes gemma's serving gives
              them (128-page tables; 16-token int8 catch-up waves); the
              extend read on int8 pages at every width class a catch-up
              wave may have (gemma3-1b S = 16, 21, 22, 64, 512; phi3
              S = 41, 64: the first version refused S >= 22 and 41
              there) and at G x S one and four rows past a 64-row tile,
              each with its plan's merge without the last split shown
              to fail; the
              decode read timed at the serving shape, at 4 rows x 4096
              tokens (8 pools, 670 MB), at the gemma shape and at its
              served shape, beside SDPA with the gather timed and
              without; the extend read timed at the serving shape and at
              gemma's served chunk of 16 and at 64 and 512; both reads'
              bf16 ptxas lines.
              ``quant_matmul`` at the draft's decode shapes (M=4
              against every projection of a phi3-medium-14b layer), a
              ragged one and one whose K is too short to split; its
              M > 8 kernel at M = 9, 16, 64, 300 and 2048 against every
              projection, a ragged K, weight rows that are not 16-byte
              vectors and x rows that are not; x in bf16 and f32, with
              three broken versions shown to fall far outside the
              tolerance; two calls of each kernel bitwise equal at split
              and unsplit plans; every decode shape and M = 512 and 2048
              of every projection timed on cold weights beside its bound
              and the bf16 cuBLAS yardstick (the plans printed), the sum
              over one draft layer's seven decode launches and over a
              draft prefill's 56; the ptxas lines of the M > 8 kernel;
              ``ssd_scan`` against the plain chunked path in float32 at
              mamba2-370m's width (h=32, p=64, n=128, chunk 256) for b 1
              and 4, l 16 / 256 / 300 / 1024 / 2048, at zamba2-7b's
              (112 heads, p 64, n 64) and at 30 heads, x in bf16 and
              f32, a split sequence continued through ``h0``, and three
              broken versions (state dropped between chunks, decay left
              out, the state passed without its decay); timed at 4 x
              1024, 1 x 1024 and 4 x 2048, and at zamba2-7b's width at
              4 x 1024, beside its bound at the bf16 tensor-core and the
              float32 rates; its bf16 ptxas lines.
              ``flash_attention`` at the evaluation path's shape (B=2,
              S=T=4096, H=4, K=1, hd=256) with window 0 and 512, phi3's
              GQA (H=40, K=10, hd=128, S=512), a ragged S=300, T < S and
              T > S, zamba2-7b's prefill (B=4, S=T=1024, 32 heads over
              32 of hd 112, in the 128-wide instantiation; also timed
              beside its bound and SDPA), bf16 and f32, a softcap of 50
              that binds, two broken
              versions (window ignored, causal mask one key late), and
              the window-512 launch under half the global one's time;
              the ptxas lines of its bf16 tensor-core kernel.
              Times the kernel, the plain version and a PyTorch library
              call (none for the scan), next to the bound.
4. serve    — the first main path: phi3-medium-14b at full width and
              depth (bf16 weights from a seeded generator, ~29 GB)
              behind ``EdgeServingEngine`` with ``use_pallas_paged=True``
              on a bf16 pool; 8 greedy requests of 16-300 prompt tokens
              x 32 new tokens through the CLI's drain loop.  Kernel
              launch counts are zeroed just before and read just after:
              every layer of every decode wave must have gone through
              ``paged_attention``, and nothing through the extend kernel
              (a float pool keeps the gather, as in JAX).
5. model    — from one cache state, ``decode_step_paged`` through the
              kernel and through the gather: logits must agree within
              the stated tolerances; times one decode wave of each.
6. serve_int8 — the second main path: the same model and traffic with
              ``quant_kv="int8"`` (the first engine's weights): every
              decode wave's layers through ``paged_attention`` on int8
              pages, every catch-up extend wave's layers through
              ``paged_extend_attention``.
7. model_int8 — on the int8 pool at float32 activations, kernel reads
              against gather reads for decode and for extend: each
              layer's block on identical inputs within the float32
              kernel tolerance, greedy tokens of the two full-model runs
              equal (their logits and the written bytes that differ are
              reported); times one extend and one decode wave of each
              read at bf16.
8. serve_spec — the third main path: the same model and traffic served
              speculatively on an int8 pool (``spec_decode``,
              ``spec_gamma=4``, ``quant_draft``) with an explicit draft:
              the verify model's first 8 layers (copied) under an
              early-exit norm, quantized to int8 by the engine.  Every
              wave is a verify extend wave through
              ``paged_extend_attention`` (40 launches each), no wave
              decodes through ``paged_attention``, and every draft
              forward call (decode steps and admission prefills, counted
              here around ``SpecDecoder``) runs its 7 x 8 projections
              through ``quant_matmul``.  Times one draft step with int8
              and with bf16 weights, and one int8 draft admission
              prefill of 4 rows x bucket 512 (56 launches at M = 2048).
9. serve_ssm — the fourth main path: mamba2-370m at full width and
              depth (bf16, ~0.74 GB) behind the engine's pool-free path
              (no page pool: ``eng.paged`` False) with
              ``use_pallas_paged=True``, prefill buckets up to 1024, 8
              greedy requests of 16-1000 prompt tokens x 32 new tokens:
              every layer of every admission prefill (calls counted
              around ``_admit_group``) scans through ``ssd_scan``, and no
              paged or quant kernel launches.  Profiles one decode wave.
10. model_ssm — one 4-row bucket-1024 ``ssm.prefill`` with ragged
              ``true_len`` through the kernel and through the plain
              chunked path at float32: logits and final states within
              the stated share of their max, greedy tokens equal; one
              bf16 prefill of each timed.
11. train    — the fifth main path: gemma3-1b at full width and depth
              (26 layers, float32 weights from a seeded generator, ~1.0e9
              parameters) trained 3 steps through ``launch.train``'s
              flags, state and step: 4 x 4096 bigram tokens a step in 2
              micro-batches, remat ``nothing_saveable``, float32 AdamW
              moments; ms and tokens/s per step, peak memory, one step's
              device idle share; losses finite; no kernel launches (the
              plain attention runs under autograd).
12. model_train — on the trained weights, ``loss_fn(use_flash=True)``
              against ``loss_fn(use_flash=False)`` on 2 x 4096 tokens:
              at float32 the CE within 1e-5 relative and the logits
              within 1e-4 x max |logit|; at bf16 every layer's
              ``attention_fwd`` through the kernel and the plain path on
              identical inputs within 2**-6 x max |o|; ``flash_attention``
              launches == 26 x forwards through it; one bf16 loss
              forward each way timed.
13. serve_gemma — the sixth main path: gemma3-1b at full width and
              depth (26 layers: 4 super-blocks of 5 local + 1 global and
              2 remainder local layers, bf16 weights from a seeded
              generator, ~2 GB) through ``launch.serve.build_engine`` on
              a bf16 pool: local layers on dense rings of 512 per slot,
              global layers on the pages; buckets to 512, catch-up chunk
              16, 8 greedy requests of 16-1000 prompt tokens x 32 new
              tokens, at least one past the largest bucket and the window
              (its catch-up extend waves wrap the rings).  Every global
              layer of every decode wave reads through
              ``paged_attention`` (4 x decode waves), nothing through the
              extend kernel.  Times and profiles one decode wave.
14. serve_gemma_int8 — the same model and traffic on an int8 pool (the
              rings stay bf16): ``paged_attention`` == 4 x decode waves,
              ``paged_extend_attention`` == 4 x extend waves.
15. serve_gemma_wide — the gemma3-1b weights on an int8 pool with
              catch-up chunk 64, 4 greedy requests of 600-1000 prompt
              tokens x 8 new: every extend call at S = 64 through
              ``paged_extend_attention`` (4 x extend waves), held against
              the same engine reading through the gather by the int8
              gate.
16. serve_hybrid — the seventh main path: zamba2-7b at full width and
              depth (81 layers: 13 super-blocks of 5 mamba blocks and
              the shared attention block, 3 remainder mamba blocks;
              bf16, ~11.2 GB) through ``launch.serve.build_engine``
              behind the pool-free engine (rings of min(max_len,
              4096) = 2048 per slot and application), buckets to 1024,
              8 greedy requests of 16-1000 prompt tokens x 32 new: each
              admission prefill scans 68 mamba blocks through
              ``ssd_scan`` and runs the 13 shared-block applications
              through ``flash_attention``; no paged or quant kernel
              launches.  Profiles one decode wave.
17. model_hybrid — one 4-row bucket-1024 hybrid prefill with ragged
              ``true_len`` through the kernels and through the plain
              path at float32: logits, mamba states and ring K/V within
              the stated share of their max, greedy tokens equal; one
              bf16 prefill of each timed.
18. reference_gemma — the gemma3-1b smoke config at float32 (window
              16), prompts of 20-150 tokens: the engine on the card and on
              the CPU emit the same greedy tokens on a float pool and
              meet the int8 gate on an int8 pool, both kernels launched.
19. reference — the phi3 smoke config at float32: the engine on the card
              (hand kernels) and on the CPU (plain versions) must emit
              the same greedy tokens on a float pool, and on an int8
              pool meet the JAX package's int8 gate (every first token
              equal, longest common prefix >= 60% of the tokens); the
              speculative engine with an int8 draft on the card (the
              verify model's first layer of 2) must emit the CPU vanilla
              engine's tokens exactly on the float pool and meet the
              int8 gate on the int8 pool; the mamba2 smoke config behind
              the pool-free engine, with prompts past the largest
              bucket, must emit the CPU's tokens on the card, and so
              must the zamba2 smoke config (window 16: rings wrap),
              with ``ssd_scan`` and ``flash_attention`` launched; the
              gemma3-1b smoke config (8 layers) at float32: the card's
              ``loss_fn(use_flash=True)`` within 1e-5 of the CPU's, two
              train steps' losses and gradient norms within 1e-4.

Before the last line it prints the kernels JSON object and the
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "phi3-medium-14b"
SERVE = dict(max_slots=4, max_len=512, policy="priority")
N_REQ, MAX_NEW, MIN_PROMPT, MAX_PROMPT = 8, 32, 16, 300
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
# cuda_ms holds the stream with a spin of this many cycles a second
# (the H100's top SM clock is 1.98 GHz: a spin lasts at least as long)
SLEEP_CYCLES_PER_S = 2.0e9
SLEEP_MAX_MS = 3000.0
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# kernel vs its plain version computed in float32 on the same inputs,
# per case (CASES): float32 / int8 (float32 q) are the same float32 math
# summed in another order; a bfloat16 output is that float32 result
# rounded once to bfloat16, so it lies within one bfloat16 step (2**-8);
# flash_attention's plain version runs in float64 (an exact result
# rounded to bfloat16 can miss a float32 one by more, in near-tie rows)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "int8": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-5)}
# the cases each kernel is held on: (name, page dtype, query dtype,
# tolerance); bfloat16 queries over int8 pages give a bfloat16 output,
# the pair that int8 serving runs on the card
CASES = (("bfloat16", "bfloat16", "bfloat16", "bfloat16"),
         ("float32", "float32", "float32", "float32"),
         ("int8", "int8", "float32", "int8"),
         ("int8/bf16q", "int8", "bfloat16", "bfloat16"))
# softcap 50 is checked at scale 1, where scores reach tens and the cap
# binds: it must move the output by more than this, far past every TOL
CAP_MOVES = 0.1
# quant_matmul against its plain version, both fed x already rounded to
# bfloat16 (the kernel rounds x, the plain version does not), so only the
# summation order differs: float32 outputs of order 1 over K <= 17920
# within 1e-4; a bfloat16 output within one bfloat16 step (2**-8) of the
# float32 result
QM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=2 ** -8, atol=1e-4)}
# a broken kernel must land this far from the plain version, far past
# QM_TOL: the scale applied along K instead of N, K cut short by one
# 32-row tile, or (M > 8) by one 64-row K step
QM_BROKEN_MOVES = 0.1
# phi3-medium-14b's projections (K, N), d=5120, K/V 10 x 128, d_ff 17920
QM_DECODE = {"wq / wo": (5120, 5120), "wk / wv": (5120, 1280),
             "w_gate / w_up": (5120, 17920), "w_down": (17920, 5120)}
QM_UNSPLIT = (4, 64, 1280)                    # K too short to split
# the M > 8 kernel: a draft admission prefill runs up to 4 prompts padded
# to a power-of-two bucket, M = rows x bucket; checked at these M against
# every projection, timed at QM_TIMED_M
QM_PREFILL_M = (9, 16, 64, 300, 2048)
QM_TIMED_M = (512, 2048)
# and at edges the projections do not reach: K not a multiple of the
# 64-row step, weight rows not 16-byte vectors (N % 16 != 0: masked
# scalar loads), x rows not 16-byte vectors (K % 8 != 0)
QM_EDGES = {"ragged K": (300, 5000, 1280), "N % 16 != 0": (40, 200, 72),
            "K % 8 != 0": (130, 100, 1280)}
DRAFT_BUCKET = 512                            # the timed draft prefill
# one draft layer's decode launches: wq, wk, wv, wo, w_gate, w_up, w_down
QM_LAYER_LAUNCHES = {"wq / wo": 2, "wk / wv": 2, "w_gate / w_up": 2,
                     "w_down": 1}
QM_COLD_BYTES = 128e6                         # > 2.5x the 50 MB L2
DRAFT_LAYERS = 8
# the fourth main path: mamba2-370m behind the pool-free engine; prompts
# of 513-1000 tokens walk 4 chunks of the scan in one admission prefill
SSM_ARCH = "mamba2-370m"
SSM_SERVE = dict(max_slots=4, max_len=2048, policy="priority",
                 prefill_buckets=(16, 32, 64, 128, 256, 512, 1024))
SSM_TRAFFIC = (8, 16, 1000, 32)               # requests, prompts, new
# ssd_scan at mamba2-370m's width and the model's chunk (cfg.ssm_chunk),
# and at the hybrid slice's zamba2-7b (112 heads of 64, state 64)
SSD_H, SSD_P, SSD_N, SSD_CHUNK = 32, 64, 128, 256
SSD_ZAMBA = (112, 64, 64)
# (b, l) checked at mamba2-370m's width, and the timed ones (the served
# 4 x 1024 prefill first: the kernels line's row)
SSD_CASES = ((1, 16), (1, 256), (1, 300), (1, 1024), (1, 2048), (4, 16),
             (4, 256), (4, 300), (4, 1024), (4, 2048))
SSD_TIMED = ((4, 1024), (1, 1024), (4, 2048))
# and timed at zamba2-7b's width on its served prefill (b, l)
SSD_ZAMBA_TIMED = (4, 1024)
# the kernel against the plain chunked path, both float32 on the same
# inputs: the same sums in another order (and exp of cumsum differences
# taken from another cumsum order), of order 1e-6 x max |y|; allowed
# 1e-4 x max |y|.  A bfloat16 y is that result rounded once: one
# bfloat16 step (2**-8 of the value) on top
SSD_F32_REL = 1e-4
SSD_BF16_STEP = 2 ** -8
SSD_BROKEN_MOVES = 0.1
# flash_attention at the evaluation path's shape (gemma3-1b: 4 query
# heads over 1 kv head, hd 256, window 512 on local layers) and beside it
FLASH_PATH = (2, 4096, 4096, 4, 1, 256)       # B, S, T, H, K, hd
FLASH_WINDOW = 512
FLASH_CASES = (                               # name, B, S, T, H, K, hd, window
    ("path global", *FLASH_PATH, 0), ("path local", *FLASH_PATH, FLASH_WINDOW),
    ("phi3 gqa", 2, 512, 512, 40, 10, 128, 0),
    ("ragged S=300", 2, 300, 300, 4, 1, 256, 64),
    ("T=200 < S=300", 2, 300, 200, 8, 2, 128, 0),
    ("T=190 > S=130", 1, 130, 190, 4, 4, 64, 16),
    ("zamba2 mha hd112", 4, 1024, 1024, 32, 32, 112, 0))
# zamba2-7b's admission prefill (a full bucket of 4 rows x 1024, 32 heads
# over 32 kv heads of 112, causal): a case above and a timed row
FLASH_HYBRID = (4, 1024, 1024, 32, 32, 112)   # B, S, T, H, K, hd
# the window-512 launch must take less than this share of the global
# one's time: its band holds 0.23 of the global launch's pairs
FLASH_BAND_SHARE = 0.5
# the fifth path: gemma3-1b trained through ``launch.train``'s step, then
# its loss scored through the kernel; 4 x 4096 tokens a step in two
# micro-batches of 2 x 4096 (the micro-batch's float32 log-softmax over
# 262144 classes is 8.6 GB, its gradient as much again, beside 16 GB of
# float32 weights, gradients and AdamW moments)
TRAIN_ARCH = "gemma3-1b"
TRAIN_ARGV = ("--arch", TRAIN_ARCH, "--scale", "full", "--batch", "4",
              "--seq", "4096", "--microbatches", "2", "--moments",
              "float32", "--steps", "3")
EVAL_ROWS, EVAL_SEQ = 2, 4096               # the scoring batch
# loss_fn through the kernel against the plain path at float32
# activations (TF32 off): the same float32 math summed in another order
CE_F32_REL = 1e-5
LOGIT_F32_REL = 1e-4
# each layer's attention output at bf16 on identical inputs, as a share
# of its max |o|: the plain path rounds every softmax probability to
# bf16 before the p.v product (2**-9 relative each) and both round the
# (B, S, H, hd) attention output to bf16 before the bf16 wo product
# (2**-9 each, and that product rounds again); four bf16 steps (2**-6)
# cover the three roundings with room, while a wrong mask or window
# moves an output by a large share of its size
LAYER_BF16_REL = 2 ** -6
SPEC = dict(spec_decode=True, spec_gamma=4, quant_draft=True)
# the sixth path: gemma3-1b served, its 20 local layers on dense rings of
# W = 512 per slot beside 4 global layers on the page pool; prompts past
# the largest bucket (512 = W) catch up in 16-token extend waves, so the
# rings wrap
GEMMA_ARCH = "gemma3-1b"
GEMMA_SERVE = dict(max_slots=4, max_len=2048, policy="priority",
                   prefill_buckets=(16, 32, 64, 128, 256, 512),
                   catch_chunk=16)
GEMMA_TRAFFIC = (8, 16, 1000, 32)             # requests, prompts, new
# kernel vs gather read of the whole 40-layer model, as a share of
# max |logit|: at float32 activations only the summation order differs;
# at bf16 the gather path also rounds its probabilities to bf16, and
# every layer's rounding difference travels through the residual stream
F32_REL_TOL = 1e-3
BF16_REL_TOL = 0.1
# int8 serving is not bit-exact across reads that sum in another order
# (one int8 level can move), so card-vs-CPU tokens are held to the JAX
# package's int8 gate (tests/test_engine_matrix.py): every first token
# equal and a longest common prefix of at least this share of tokens
INT8_LCP_SHARE = 0.6
# the int8 extend read at the widths a catch-up wave may have: gemma3-1b's
# global layers (4 slots, 128-page tables; the first version refused
# S >= 22) and phi3's (32-page tables; S >= 41); and a row count one past
# a 64-row tile (G = 1) and four past one (G = 4); the gemma widths timed
EXTEND_WIDTHS = (("gemma3", dict(H=4, K=1, hd=256, n_blk=128),
                  (16, 21, 22, 64, 512)),
                 ("phi3", dict(n_blk=32), (41, 64)),
                 ("tile+1", dict(H=4, K=4, hd=128, n_blk=16), (65,)),
                 ("tile+4", dict(H=8, K=2, hd=64, n_blk=16), (17,)))
EXTEND_TIMED_GEMMA = (64, 512)
# a short gemma3-1b int8 drive whose catch-up waves send 64 tokens a slot
# through the extend read, held to the gather read by the int8 gate
GEMMA_WIDE_SERVE = dict(GEMMA_SERVE, catch_chunk=64)
GEMMA_WIDE_TRAFFIC = (4, 600, 1000, 8)        # requests, prompts, new
# the seventh path: zamba2-7b (81 layers: 13 super-blocks of 5 mamba
# blocks and the shared attention block, then 3 mamba blocks) behind the
# pool-free engine; each admission prefill scans 68 mamba blocks through
# ssd_scan and runs 13 applications of the shared block through
# flash_attention
HYBRID_ARCH = "zamba2-7b"
HYBRID_SERVE = dict(SSM_SERVE)
HYBRID_TRAFFIC = (8, 16, 1000, 32)            # requests, prompts, new


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: Path, contains: str) -> dict:
    """{kernel: [ptxas 'Used ...' / spill lines]} from an ``nvcc
    -Xptxas=-v`` log, for the entry functions whose (mangled) name holds
    ``contains``."""
    report, name = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
            name = name if contains in name else None
        elif name and ("Used" in ln or "spill" in ln):
            report.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return report


def _sync(torch) -> None:
    """Bring a fault of the kernels launched so far to light here."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _release(torch) -> None:
    """Free what the last phase held before the next one measures its
    peak memory: the call counters of ``_count_calls`` close reference
    cycles through the engine they wrap, which only the cycle collector
    frees."""
    gc.collect()
    torch.cuda.empty_cache()


def _zero(kernels) -> None:
    """Set every kernel wrapper's launch count to 0."""
    for mod in kernels.values():
        mod.launches = 0


def _counts(kernels) -> dict:
    return {name: mod.launches for name, mod in kernels.items()}


def _clock_ms() -> float:
    from repro_torch.serving.telemetry import default_clock
    return default_clock() * 1e3


def cuda_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls, back
    to back on the device: the stream is held busy (``torch.cuda._sleep``)
    for longer than the host takes to queue the calls, so the host time
    between two launches, which the events would otherwise time as idle
    device time, does not count.  The host's own cost of a call is not a
    kernel's time; the serve phases time it end to end."""
    fn(0)
    torch.cuda.synchronize()
    t0 = _clock_ms()
    for i in range(1, warmup):
        fn(i)
    enqueue_ms = (_clock_ms() - t0) / max(warmup - 1, 1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_ms = min(1.5 * iters * enqueue_ms + 1.0, SLEEP_MAX_MS)
    torch.cuda._sleep(int(hold_ms * 1e-3 * SLEEP_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: paged_attention against its plain version
# ---------------------------------------------------------------------------

def _paged_inputs(torch, dtype, *, q_dtype=None, layers=1, B=4, H=40,
                  K=10, hd=128, bs=16, n_blk=32, lengths=None, seed=0,
                  dev="cuda"):
    """q, a ``layers``-deep pool (nB = B * n_blk pages per layer), block
    tables with each row's pages scattered over the pool and one -1
    hole inside row 0, and ragged lengths; int8 pools come with their
    scales (symmetric per head_dim vector, as ``layers.quantize_kv``).
    q is in the page dtype, float32 over int8 pages, unless ``q_dtype``
    says otherwise (bfloat16 over int8 is what int8 serving runs).
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
        kp, vp = kp.to(dtype), vp.to(dtype)
    if q_dtype is None:
        q_dtype = torch.float32 if dtype == torch.int8 else dtype
    return q.to(q_dtype), kp, vp, bt.to(dev), lengths.to(dev), scales


def _roofline(nbytes: int, ops: int, page_dtype) -> tuple:
    """Least time (ms) of moving ``nbytes`` through device memory and
    doing ``ops`` operations at the peak rate of the page type: the
    larger of the two, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(page_dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _visible_context(torch, bt, lengths, bs):
    """(B,) count of each row's positions t < lengths[b] on allocated
    pages: the context rows a paged read must load."""
    pos = torch.arange(bt.shape[1] * bs, device=bt.device)
    valid = (pos[None, :] < lengths[:, None].long()) \
        & torch.repeat_interleave(bt >= 0, bs, dim=1)
    return valid.sum(dim=1)


def _page_row_bytes(kp, scales) -> int:
    """Bytes of one position's K and V rows over all kv heads (and their
    scales on an int8 pool)."""
    K, hd = kp.shape[-2:]
    return 2 * K * hd * kp.element_size() + (2 * K * 4 if scales else 0)


def _bound(torch, q, kp, bt, lengths, scales):
    """Least time (ms) of one decode read on these inputs: every input
    byte the function needs read once (q, tables, lengths, and the K/V
    rows — plus scales — of each row's valid positions on allocated
    pages), the output written once; against the operations it does
    over the peak rate of the page type.  Returns (ms, "bytes" |
    "operations")."""
    B, H, hd = q.shape
    tokens = int(_visible_context(torch, bt, lengths, kp.shape[-3]).sum())
    nbytes = (2 * q.numel() * q.element_size() + bt.numel() * 4
              + lengths.numel() * 4 + tokens * _page_row_bytes(kp, scales))
    return _roofline(nbytes, 4 * H * hd * tokens, kp.dtype)


def _sms(torch, dev) -> int:
    """SMs of the card (an H100's 132 for a CPU rehearsal)."""
    if dev == "cpu":
        return 132
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ptxas(name: str, contains: str) -> dict:
    """ptxas lines of kernel library ``name``'s entry functions whose
    mangled name holds ``contains``."""
    from repro_torch.kernels import build
    log = build.library_path(name).with_suffix(".log")
    return ptxas_report(log, contains) if log.exists() else {}


def _ptxas_bf16(name: str) -> dict:
    """ptxas lines of a kernel's instantiations with a bf16 type."""
    return _ptxas(name, "13__nv_bfloat16")


def _boundary_lengths(plan, bs, n_blk, S=0):
    """Row lengths (or pos, with ``S`` suffix tokens behind them) on the
    split boundaries of ``plan``: exactly two splits, one page short of
    them, the whole table (its last split full) and, for the row that
    gets a hole, a whole table but three positions."""
    edge = 2 * plan.pages * bs
    return [edge, edge - bs, n_blk * bs - S, n_blk * bs - S - 3]


def _split_holes(bt, plan):
    """-1 over every table entry of split 1 of the last row: that split
    reads no page."""
    bt[-1, plan.pages:2 * plan.pages] = -1


def _decode_plans(torch, pa, q, kp, bt, dev):
    """The wrapper's plan for these shapes, and the same plan with scores
    and p.v moved from the tensor cores to the CUDA cores (None if it has
    no tensor cores to move from)."""
    B, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[-3]
    plan = pa.paged_plan(B, K, H // K, 1, bt.shape[1], bs, hd, kp.dtype,
                         q.dtype, _sms(torch, dev))
    if not plan.mma:
        return plan, None
    return plan, plan._replace(mma=False, smem=pa.smem_bytes(
        H // K, hd, bs, plan.chunk, plan.stages, kp.element_size(),
        q.element_size(), suffix=False, mma=False))


def _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln, scale,
                  dev="cuda"):
    """Device ms of the kernel (and of its CUDA-core instantiation where
    it runs on the tensor cores, held to the same tolerance), its plain
    version and SDPA (over K/V gathered inside the timed call, and over
    K/V gathered beforehand) on a layer-deep pool cycled per call, and
    the bound."""
    import torch.nn.functional as F
    L = kp.shape[0]
    B, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[2]
    ms = timer(torch, lambda i: pa.paged_attention(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale))
    plan, cores = _decode_plans(torch, pa, q, kp[0], bt, dev)
    cuda_cores_ms = None
    if cores is not None:
        got = pa.paged_attention(q, kp[0], vp[0], bt, ln, scale=scale,
                                 plan=cores).float()
        exp = ref.paged_attention_ref(q.float(), kp[0], vp[0], bt, ln,
                                      scale=scale)
        if not torch.allclose(got, exp, **TOL["bfloat16"]):
            raise AssertionError("paged_attention on the CUDA cores: max "
                                 f"abs err {float((got - exp).abs().max())}")
        cuda_cores_ms = timer(torch, lambda i: pa.paged_attention(
            q, kp[i % L], vp[i % L], bt, ln, scale=scale, plan=cores))
    plain_ms = timer(torch, lambda i: ref.paged_attention_ref(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale), iters=20, warmup=3)
    btc = bt.clamp(min=0).long()
    t = torch.arange(bt.shape[1] * bs, device=q.device)
    mask = ((t[None, :] < ln[:, None])
            & torch.repeat_interleave(bt >= 0, bs, dim=1))[:, None, None, :]
    q4 = q[:, :, None, :]

    def gathered(x):
        return x[btc].reshape(B, -1, K, hd).transpose(1, 2)

    def library(l):
        return F.scaled_dot_product_attention(
            q4, gathered(kp[l]), gathered(vp[l]), attn_mask=mask,
            scale=scale, enable_gqa=True)
    lib_err = float((library(0)[:, :, 0].float() - ref.paged_attention_ref(
        q, kp[0], vp[0], bt, ln, scale=scale).float()).abs().max())
    library_ms = timer(torch, lambda i: library(i % L))
    kg = [gathered(kp[l]).contiguous() for l in range(L)]
    vg = [gathered(vp[l]).contiguous() for l in range(L)]
    pregathered_ms = timer(torch, lambda i: F.scaled_dot_product_attention(
        q4, kg[i % L], vg[i % L], attn_mask=mask, scale=scale,
        enable_gqa=True))
    del kg, vg
    bound_ms, bound_by = _bound(torch, q, kp[0], bt, ln, {})
    return {"ms": ms, "cuda_cores_ms": cuda_cores_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_ms_gather_excluded": pregathered_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_max_abs_err": lib_err,
            "lengths": [int(x) for x in ln.tolist()], "pools": L,
            "plan": plan._asdict(),
            "shape": f"B={B} H={H} K={K} hd={hd} bs={bs} "
            f"n_blk={bt.shape[1]} {str(kp.dtype).replace('torch.', '')}"}


def check_paged_attention(torch, pa, ref, timer, dev="cuda"):
    """Hold the kernel against its plain version on every case, on the
    split plan's boundaries and at gemma3-1b's global-layer shape; two
    calls bitwise equal; a merge that drops the last split's partial
    outside the tolerance; time the kernel (and its plain version and a
    library call) at the serving, long-context and gemma shapes."""
    errs, moves = {}, {}
    worst = 0.0

    def held(tol, case, q, kp, vp, bt, ln, **kw):
        nonlocal worst
        out = pa.paged_attention(q, kp, vp, bt, ln, **kw)
        _sync(torch)
        exp = ref.paged_attention_ref(q.float(), kp, vp, bt, ln, **kw)
        err = float((out.float() - exp).abs().max())
        if not torch.allclose(out.float(), exp, **TOL[tol]):
            raise AssertionError(f"paged_attention {case}: max abs err "
                                 f"{err} beyond tolerance {TOL[tol]}")
        errs[case] = err
        worst = max(worst, err)
        return out

    for seed, (name, pages, q_dtype, tol) in enumerate(CASES):
        q, kp, vp, bt, ln, sc = _paged_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            seed=seed, dev=dev)
        sc = {k: v[0] for k, v in sc.items()}
        args = (q, kp[0], vp[0], bt, ln)
        held(tol, f"{name}/softcap0", *args, scale=128 ** -0.5, **sc)
        capped = held(tol, f"{name}/softcap50/scale1", *args, scale=1.0,
                      softcap=50.0, **sc).float()
        free = held(tol, f"{name}/softcap0/scale1", *args, scale=1.0,
                    **sc).float()
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

    # lengths on the plan's split boundaries, a hole that empties a
    # split; two calls bitwise equal; the last split's partial dropped
    plan = pa.paged_plan(4, 10, 4, 1, 32, 16, 128, torch.bfloat16,
                         torch.bfloat16, _sms(torch, dev))
    boundary = {}
    for name, pages, q_dtype, tol in CASES:
        q, kp, vp, bt, ln, sc = _paged_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            lengths=_boundary_lengths(plan, 16, 32), seed=21, dev=dev)
        _split_holes(bt, plan)
        sc = {k: v[0] for k, v in sc.items()}
        kw = dict(scale=1.0, softcap=50.0, **sc)
        out = held(tol, f"{name}/split boundaries", q, kp[0], vp[0], bt, ln,
                   **kw)
        again = pa.paged_attention(q, kp[0], vp[0], bt, ln, **kw)
        _sync(torch)
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention {name}: two calls differ")
        exp = ref.paged_attention_ref(q.float(), kp[0], vp[0], bt, ln, **kw)
        broken = pa.split_reference(q, kp[0], vp[0], bt, ln, plan,
                                    drop=plan.splits - 1, **kw)
        boundary[name] = float((broken - exp).abs().max())
        if torch.allclose(broken, exp, **TOL[tol]):
            raise AssertionError(f"paged_attention {name}: a merge without "
                                 f"the last split passes the tolerance")

    # gemma3-1b's global layers: 4 query heads over one kv head of 256
    gemma = dict(B=4, H=4, K=1, hd=256, n_blk=256)
    g = torch.Generator(device="cpu").manual_seed(5)
    gemma_len = torch.randint(1, 256 * 16 + 1, (4,), generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=8,
                                         lengths=gemma_len, seed=31,
                                         dev=dev, **gemma)
    held("bfloat16", "gemma3 global", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5)
    timed_gemma = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                                256 ** -0.5, dev)
    del q, kp, vp

    # gemma3-1b's served decode waves: 128-page tables (max_len 2048) at
    # its traffic's lengths (prompts 16-1000 plus 32 new tokens), bf16
    # pages timed (16 pools cycled), int8 pages under bf16 queries held
    served = dict(B=4, H=4, K=1, hd=256, n_blk=128)
    g = torch.Generator(device="cpu").manual_seed(6)
    served_len = torch.randint(17, 1000 + 32 + 1, (4,), generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=16,
                                         lengths=served_len, seed=33,
                                         dev=dev, **served)
    held("bfloat16", "gemma3 served", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5)
    timed_served = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                                 256 ** -0.5, dev)
    del q, kp, vp
    q, kp, vp, bt, ln, sc = _paged_inputs(torch, torch.int8,
                                          q_dtype=torch.bfloat16,
                                          lengths=served_len, seed=34,
                                          dev=dev, **served)
    held("bfloat16", "gemma3 served int8", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5, **{k: v[0] for k, v in sc.items()})
    del q, kp, vp

    # 4 rows of 4096 tokens (phi3-medium-4k's window), 8 pools (670 MB)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=8,
                                         n_blk=256, lengths=[4096] * 4,
                                         seed=41, dev=dev)
    held("bfloat16", "long 4 x 4096", q, kp[0], vp[0], bt, ln,
         scale=128 ** -0.5)
    timed_long = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                               128 ** -0.5, dev)
    del q, kp, vp

    # the serving path's shapes: bf16 pages, 4 slots with the serve
    # phase's prompt+generation lengths, one pool per layer (40 pools,
    # 420 MB) cycled per call so L2 holds no layer's pages
    g = torch.Generator(device="cpu").manual_seed(7)
    lengths = torch.randint(MIN_PROMPT + 1, MAX_PROMPT + MAX_NEW + 1, (4,),
                            generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=40,
                                         lengths=lengths, seed=11,
                                         dev=dev)
    held("bfloat16", "serve timed", q, kp[0], vp[0], bt, ln,
         scale=128 ** -0.5)
    row = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                        128 ** -0.5, dev)
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL, "softcap50_moves": moves,
        "plan_serve": plan._asdict(),
        "broken_merge_without_last_split_err": boundary,
        "timed": {"serve": row, "long": timed_long, "gemma3": timed_gemma,
                  "gemma3_served": timed_served},
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
        "over K/V gathered inside the timed call (library_ms); "
        "library_ms_gather_excluded gathers beforehand",
        "ptxas_bf16": _ptxas_bf16("paged_attention")}


# ---------------------------------------------------------------------------
# phase 3: paged_extend_attention against its plain version
# ---------------------------------------------------------------------------

def _extend_inputs(torch, dtype, *, q_dtype=None, layers=1, B=4, S=4, H=40,
                   K=10, hd=128, bs=16, n_blk=32, pos=None, seed=0,
                   dev="cuda"):
    """q (B, S, H, hd) at 3 x randn, the suffix k_new / v_new at 0.5 x
    randn in q's dtype, and a ``layers``-deep pool from
    ``_paged_inputs`` whose tables cover each row's pos + S positions.
    By default row 0 has a -1 hole below its pos and the last row sits
    at pos 0 (it reads no page); stale bytes fill every page past each
    row's pos.  q is float32 over int8 pages unless ``q_dtype`` says
    otherwise."""
    g = torch.Generator(device="cpu").manual_seed(seed + 1000)
    if pos is None:
        pos = torch.randint(bs + 1, n_blk * bs - S + 1, (B,), generator=g)
        pos[-1] = 0
    pos = torch.as_tensor(pos, dtype=torch.int32)
    _, kp, vp, bt, _, scales = _paged_inputs(
        torch, dtype, layers=layers, B=B, H=H, K=K, hd=hd, bs=bs,
        n_blk=n_blk, lengths=pos + S, seed=seed, dev=dev)
    q_dtype = q_dtype or (torch.float32 if dtype == torch.int8 else dtype)
    q = (torch.randn((B, S, H, hd), generator=g) * 3.0).to(q_dtype).to(dev)
    kn = (torch.randn((B, S, K, hd), generator=g) * 0.5).to(q_dtype).to(dev)
    vn = (torch.randn((B, S, K, hd), generator=g) * 0.5).to(q_dtype).to(dev)
    return q, kp, vp, kn, vn, bt, pos.to(dev), scales


def _extend_bound(torch, q, kp, kn, bt, pos, scales):
    """Least time (ms) of one extend read on these inputs: q, k_new,
    v_new, tables and pos read once, the K/V rows (plus scales) of each
    row's context below pos on allocated pages read once, the output
    written once; against 4 * hd operations per (query head, visible
    key) pair over the peak rate of the page type."""
    B, S, H, hd = q.shape
    ctx = _visible_context(torch, bt, pos, kp.shape[-3])
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * kn.numel() * kn.element_size()
              + bt.numel() * 4 + pos.numel() * 4
              + int(ctx.sum()) * _page_row_bytes(kp, scales))
    pairs = H * (S * int(ctx.sum()) + B * S * (S + 1) // 2)
    return _roofline(nbytes, 4 * hd * pairs, kp.dtype)


def _extend_times(torch, pea, ref, timer, q, kp, vp, kn, vn, bt, pos, sc,
                  scale):
    """Device ms of the extend kernel (bf16 q over int8 pages), its plain
    version and the library yardstick (never called by the port: gather
    and dequantize the context, then SDPA over context + suffix with a
    boolean mask) on a layer-deep pool cycled per call, the kernel held
    to the bf16 tolerance, and the bound."""
    import torch.nn.functional as F
    ks, vs = sc["k_scale"], sc["v_scale"]
    L = kp.shape[0]
    B, S, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[2]

    def kernel(i):
        return pea.paged_extend_attention(q, kp[i % L], vp[i % L], kn, vn,
                                          bt, pos, scale=scale,
                                          k_scale=ks[i % L],
                                          v_scale=vs[i % L])
    ms = timer(torch, kernel)
    plain_ms = timer(torch, lambda i: ref.paged_extend_attention_ref(
        q, kp[i % L], vp[i % L], kn, vn, bt, pos, scale=scale,
        k_scale=ks[i % L], v_scale=vs[i % L]), iters=20, warmup=3)

    btc = bt.clamp(min=0).long()
    n_ctx = bt.shape[1] * bs
    t = torch.arange(n_ctx, device=q.device)
    ctx_ok = (t[None, :] < pos[:, None]) \
        & torch.repeat_interleave(bt >= 0, bs, dim=1)
    i = torch.arange(S, device=q.device)
    mask = torch.cat([ctx_ok[:, None, :].expand(B, S, n_ctx),
                      (i[None, :] <= i[:, None])[None].expand(B, S, S)],
                     dim=-1)[:, None]                       # (B,1,S,T)
    qt = q.transpose(1, 2)

    def library(j):
        l = j % L
        kg = (kp[l][btc].float() * ks[l][btc][..., None]).to(q.dtype)
        vg = (vp[l][btc].float() * vs[l][btc][..., None]).to(q.dtype)
        k_all = torch.cat([kg.reshape(B, n_ctx, K, hd), kn], dim=1)
        v_all = torch.cat([vg.reshape(B, n_ctx, K, hd), vn], dim=1)
        return F.scaled_dot_product_attention(
            qt, k_all.transpose(1, 2), v_all.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True).transpose(1, 2)
    exp = ref.paged_extend_attention_ref(
        q.float(), kp[0], vp[0], kn.float(), vn.float(), bt, pos,
        scale=scale, k_scale=ks[0], v_scale=vs[0])
    lib_err = float((library(0).float() - exp).abs().max())
    out = kernel(0).float()
    kernel_err = float((out - exp).abs().max())
    if not torch.allclose(out, exp, **TOL["bfloat16"]):
        raise AssertionError(f"paged_extend_attention timed case (bf16 q, "
                             f"int8 pages, {B} x {S} x {H} heads, hd {hd}): "
                             f"max abs err {kernel_err} beyond tolerance "
                             f"{TOL['bfloat16']}")
    library_ms = timer(torch, library)
    sc0 = {k: v[0] for k, v in sc.items()}
    bound_ms, bound_by = _extend_bound(torch, q, kp[0], kn, bt, pos, sc0)
    plan = pea.paged_plan(B, K, H // K, S, bt.shape[1], bs, hd, kp.dtype,
                          q.dtype, _sms(torch, q.device), suffix=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_max_abs_err": kernel_err, "library_max_abs_err": lib_err,
            "pos": [int(x) for x in pos.tolist()], "pools": L,
            "plan": plan._asdict(),
            "shape": f"B={B} S={S} H={H} K={K} hd={hd} bs={bs} "
            f"n_blk={bt.shape[1]} int8"}


def check_paged_extend_attention(torch, pea, ref, timer, dev="cuda"):
    """Hold the extend kernel against its plain version on every case, on
    the split plan's boundaries and at gemma3-1b's global-layer shape;
    two calls bitwise equal; a merge that drops the last split's partial
    outside the tolerance; time the kernel (and its plain version and a
    library call) at the serving path's shapes."""
    errs, moves = {}, {}
    worst = 0.0

    def plain(q, kp, vp, kn, vn, bt, pos, **kw):
        return ref.paged_extend_attention_ref(q.float(), kp, vp, kn.float(),
                                              vn.float(), bt, pos, **kw)

    def held(tol, case, *args, **kw):
        nonlocal worst
        out = pea.paged_extend_attention(*args, **kw)
        _sync(torch)
        exp = plain(*args, **kw)
        err = float((out.float() - exp).abs().max())
        if not torch.allclose(out.float(), exp, **TOL[tol]):
            raise AssertionError(f"paged_extend_attention {case}: max abs "
                                 f"err {err} beyond tolerance {TOL[tol]}")
        errs[case] = err
        worst = max(worst, err)
        return out.float()

    for seed, (name, pages, q_dtype, tol) in enumerate(CASES):
        q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            seed=seed, dev=dev)
        if int(bt[0, 0]) != -1 or int(pos[0]) <= kp.shape[2] \
                or int(pos[-1]) != 0:
            raise AssertionError("extend inputs lack the -1 hole below pos "
                                 "or the pos-0 row")
        sc = {k: v[0] for k, v in sc.items()}
        args = (q, kp[0], vp[0], kn, vn, bt, pos)
        held(tol, f"{name}/softcap0", *args, scale=128 ** -0.5, **sc)
        capped = held(tol, f"{name}/softcap50/scale1", *args, scale=1.0,
                      softcap=50.0, **sc)
        free = held(tol, f"{name}/softcap0/scale1", *args, scale=1.0, **sc)
        moves[name] = float((capped - free).abs().max())
        if moves[name] <= CAP_MOVES:
            raise AssertionError(f"paged_extend_attention {name}: softcap "
                                 f"50 moved the output by only {moves[name]}")

    # pos on the plan's split boundaries, a hole that empties a split, and
    # gemma3-1b's global-layer shape (one kv head of 256); two calls
    # bitwise equal; the last split's partial (the suffix's) dropped
    plan = pea.paged_plan(4, 10, 4, 4, 32, 16, 128, torch.int8,
                          torch.bfloat16, _sms(torch, dev), suffix=True)
    boundary = {}
    for name, pages, q_dtype, tol in CASES:
        q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            pos=_boundary_lengths(plan, 16, 32, S=4), seed=21, dev=dev)
        _split_holes(bt, plan)
        sc = {k: v[0] for k, v in sc.items()}
        kw = dict(scale=1.0, softcap=50.0, **sc)
        args = (q, kp[0], vp[0], kn, vn, bt, pos)
        out = held(tol, f"{name}/split boundaries", *args, **kw)
        again = pea.paged_extend_attention(*args, **kw).float()
        _sync(torch)
        if not torch.equal(out, again):
            raise AssertionError(f"paged_extend_attention {name}: two calls "
                                 f"differ")
        broken = pea.split_reference(*args, plan, drop=plan.splits - 1, **kw)
        exp = plain(*args, **kw)
        boundary[name] = float((broken - exp).abs().max())
        if torch.allclose(broken, exp, **TOL[tol]):
            raise AssertionError(f"paged_extend_attention {name}: a merge "
                                 f"without the last split passes the "
                                 f"tolerance")
    q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
        torch, torch.int8, q_dtype=torch.bfloat16, H=4, K=1, hd=256,
        n_blk=256, seed=31, dev=dev)
    held("bfloat16", "gemma3 global", q, kp[0], vp[0], kn, vn, bt, pos,
         scale=256 ** -0.5, **{k: v[0] for k, v in sc.items()})

    # the widths a catch-up wave may have, bf16 q over int8 pages (a
    # -1 hole below row 0's pos, the last row at pos 0); each plan's
    # merge without its last split (the suffix's) must fail
    widths = {}
    for name, shape, widths_S in EXTEND_WIDTHS:
        for S in widths_S:
            q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
                torch, torch.int8, q_dtype=torch.bfloat16, S=S,
                seed=40 + S, dev=dev, **shape)
            B, _, H, hd = q.shape
            K = kp.shape[-2]
            kw = dict(scale=hd ** -0.5, **{k: v[0] for k, v in sc.items()})
            args = (q, kp[0], vp[0], kn, vn, bt, pos)
            case = f"{name} S={S}"
            held("bfloat16", case, *args, **kw)
            plan = pea.paged_plan(B, K, H // K, S, bt.shape[1], 16, hd,
                                  torch.int8, torch.bfloat16,
                                  _sms(torch, dev), suffix=True)
            row = {"rows": H // K * S, "plan": plan._asdict()}
            if plan.splits > 1:
                broken = pea.split_reference(*args, plan,
                                             drop=plan.splits - 1, **kw)
                exp = plain(*args, **kw)
                row["broken_merge_err"] = float((broken - exp).abs().max())
                if torch.allclose(broken, exp, **TOL["bfloat16"]):
                    raise AssertionError(f"paged_extend_attention {case}: "
                                         "a merge without the last split "
                                         "passes the tolerance")
            widths[case] = row
            del q, kp, vp, kn, vn, args

    # timing at the serving path's shapes: a catch-up wave of 4 slots x 4
    # tokens at prompt positions past the largest prefill bucket (128),
    # bf16 queries over int8 pages, one pool per layer (40 pools) cycled
    # per call so L2 holds no layer's pages
    g = torch.Generator(device="cpu").manual_seed(7)
    S = 4
    pos = torch.randint(128, MAX_PROMPT - S + 1, (4,), generator=g)
    q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
        torch, torch.int8, q_dtype=torch.bfloat16, layers=40, S=S, pos=pos,
        seed=11, dev=dev)
    row = _extend_times(torch, pea, ref, timer, q, kp, vp, kn, vn, bt, pos,
                        sc, 128 ** -0.5)
    worst = max(worst, row["kernel_max_abs_err"])
    del q, kp, vp

    # gemma3-1b's served int8 catch-up wave: 4 slots x 16 tokens past the
    # 512-token window over 128-page tables, 4 query heads over one kv
    # head of 256; 16 pools cycled
    g = torch.Generator(device="cpu").manual_seed(9)
    gpos = torch.randint(512, 2048 - 16 + 1, (4,), generator=g)
    args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                          layers=16, S=16, H=4, K=1, hd=256, n_blk=128,
                          pos=gpos, seed=32, dev=dev)
    timed_gemma = _extend_times(torch, pea, ref, timer, *args, 256 ** -0.5)
    errs["gemma3 served chunk (S=16)"] = timed_gemma["kernel_max_abs_err"]
    worst = max(worst, timed_gemma["kernel_max_abs_err"])
    del args
    # and at wider catch-up chunks, 8 pools cycled
    timed_wide = {}
    for S in EXTEND_TIMED_GEMMA:
        gpos = torch.randint(512, 2048 - S + 1, (4,), generator=g)
        args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                              layers=8, S=S, H=4, K=1, hd=256, n_blk=128,
                              pos=gpos, seed=33 + S, dev=dev)
        timed_wide[f"S={S}"] = _extend_times(torch, pea, ref, timer, *args,
                                             256 ** -0.5)
        worst = max(worst, timed_wide[f"S={S}"]["kernel_max_abs_err"])
        del args
    return {
        "name": "paged_extend_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_extend_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:283",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL, "softcap50_moves": moves,
        "timed_pos": row["pos"], "timed_S": S,
        "timed_kernel_max_abs_err_bf16": row["kernel_max_abs_err"],
        "timed_gemma3": timed_gemma, "timed_gemma3_wide": timed_wide,
        "widths": widths,
        "library_call": "gather + dequantize, then "
        "F.scaled_dot_product_attention(enable_gqa=True) with a boolean "
        "mask, all timed",
        "library_max_abs_err": row["library_max_abs_err"],
        "plan_serve": plan._asdict(),
        "broken_merge_without_last_split_err": boundary,
        "ptxas_bf16": _ptxas_bf16("paged_extend_attention")}


# ---------------------------------------------------------------------------
# phase 3: quant_matmul against its plain version
# ---------------------------------------------------------------------------

def _qm_inputs(torch, qm, M, K, N, x_dtype, seed, dev="cuda"):
    """x at randn rounded to bfloat16 (held in ``x_dtype``), and a randn /
    sqrt(K) weight quantized per output channel (outputs of order 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((M, K), generator=g).to(torch.bfloat16).to(x_dtype)
    w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dev)
    wq, scale = qm.quantize_weights(w)
    return x.to(dev), wq, scale


def _qm_bound(M, K, N, x_elt: int):
    """Least time (ms) of one call: x, the int8 weight and the scales
    read once, the output (x's dtype) written once, against 2MNK
    operations at the bfloat16 tensor-core rate."""
    nbytes = M * K * x_elt + K * N + 4 * N + M * N * x_elt
    return _roofline(nbytes, 2 * M * N * K, "bfloat16")


def _qm_cold(torch, w):
    """Copies of ``w`` that together exceed the 50 MB L2 cache by far, so
    a timer that walks them finds each weight in device memory, as the
    draft's 56 distinct projections a step do."""
    n = max(1, math.ceil(QM_COLD_BYTES / (w.numel() * w.element_size())))
    return [w] + [w.clone() for _ in range(n - 1)]


def time_gemv(torch, qm, ref, timer, M, K, N, *, seed=7, dev="cuda"):
    """Time the kernel at (M, K, N) with bf16 x on cold weights, beside
    its bound, the bf16 cuBLAS yardstick (torch.matmul on a bf16 copy of
    the dequantized weight, cold too) and the plain version."""
    x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.bfloat16,
                              seed=seed, dev=dev)
    wqs = _qm_cold(torch, wq)
    ms = timer(torch, lambda i: qm.quant_matmul(
        x, wqs[i % len(wqs)], scale, out_dtype=torch.bfloat16))
    del wqs
    w_bf16 = _qm_cold(torch, (wq.float() * scale[None, :]).to(torch.bfloat16))
    library_ms = timer(torch, lambda i: torch.matmul(x, w_bf16[i % len(w_bf16)]))
    del w_bf16
    row = {"shape": [M, K, N], "ms": ms, "library_ms": library_ms}
    row["plain_ms"] = timer(torch, lambda i: ref.quant_matmul_ref(
        x, wq, scale, out_dtype=torch.bfloat16), iters=20, warmup=3)
    row["bound_ms"], row["bound_by"] = _qm_bound(M, K, N, 2)
    row["weight_gb_per_s"] = K * N / (ms * 1e-3) / 1e9
    return row


def _qm_weight(torch, qm, K, N, seed, dev="cuda"):
    """A randn / sqrt(K) weight made on ``dev``, quantized per output
    channel: one per projection, shared by the M > 8 cases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    return qm.quantize_weights(w)


def _qm_check(torch, ref, out, x, wq, scale, name, dt):
    """max |kernel - plain| of one call, raising beyond QM_TOL[dt]."""
    _sync(torch)
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    err = float((out.float() - exp).abs().max())
    if out.dtype != getattr(torch, dt) or not torch.allclose(
            out.float(), exp, **QM_TOL[dt]):
        raise AssertionError(f"quant_matmul {name} {dt}: max abs err {err} "
                             f"beyond tolerance {QM_TOL[dt]}")
    return err


def check_quant_matmul(torch, qm, ref, timer, dev="cuda"):
    """Hold both kernels against their plain version (x in bf16 and f32,
    out_dtype = x's): the M <= 8 GEMV at the draft's decode shapes, a
    ragged one and one whose K is too short to split; the M > 8 kernel
    at QM_PREFILL_M rows against every projection and at QM_EDGES.  Show
    three broken versions fall outside the tolerance.  Two calls on the
    same inputs give bitwise-equal outputs, K split or not, in either
    kernel.  Time kernel, plain version and the bf16 yardstick at every
    decode shape and at QM_TIMED_M rows of every projection (cold
    weights), and sum one draft layer's seven decode launches."""
    errs, worst = {}, 0.0
    shapes = {f"decode {n}": (4, k, nn) for n, (k, nn) in QM_DECODE.items()}
    shapes["ragged"] = (3, 200, 72)
    shapes["unsplit"] = QM_UNSPLIT
    shapes.update({f"M > 8, {n}": s for n, s in QM_EDGES.items()})
    for i, (name, (M, K, N)) in enumerate(shapes.items()):
        for dt in ("bfloat16", "float32"):
            x, wq, scale = _qm_inputs(torch, qm, M, K, N, getattr(torch, dt),
                                      seed=i, dev=dev)
            out = qm.quant_matmul(x, wq, scale, out_dtype=getattr(torch, dt))
            err = _qm_check(torch, ref, out, x, wq, scale, name, dt)
            errs[f"{name} {M}x{K}x{N} {dt}"] = err
            worst = max(worst, err)
    # the M > 8 kernel at the draft's prefill rows, one weight a projection
    sms = _sms(torch, dev)
    plans = {}
    for i, (n, (K, N)) in enumerate(QM_DECODE.items()):
        wq, scale = _qm_weight(torch, qm, K, N, seed=100 + i, dev=dev)
        for M in QM_PREFILL_M:
            plans[f"M={M} {n}"] = qm.mma_plan(M, K, N, sms)._asdict()
            for dt in ("bfloat16", "float32"):
                g = torch.Generator(device=dev).manual_seed(M)
                x = torch.randn((M, K), generator=g, device=dev).to(
                    torch.bfloat16).to(getattr(torch, dt))
                out = qm.quant_matmul(x, wq, scale,
                                      out_dtype=getattr(torch, dt))
                err = _qm_check(torch, ref, out, x, wq, scale,
                                f"M={M} {n}", dt)
                errs[f"prefill M={M} {n} {dt}"] = err
                worst = max(worst, err)
        del wq, scale

    # two calls, bitwise equal: the split partials are summed in a fixed
    # order (both kernels; split and unsplit plans)
    repeat, rep_plans = {}, {}
    rep_shapes = dict((n, s) for n, s in shapes.items() if s[0] <= 8)
    rep_shapes["decode w_gate M=8"] = (8, *QM_DECODE["w_gate / w_up"])
    rep_shapes["prefill w_gate M=512"] = (512, *QM_DECODE["w_gate / w_up"])
    rep_shapes["prefill wk / wv M=512"] = (512, *QM_DECODE["wk / wv"])
    rep_shapes["prefill w_down M=64"] = (64, *QM_DECODE["w_down"])
    for name, (M, K, N) in rep_shapes.items():
        x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.bfloat16,
                                  seed=11, dev=dev)
        a = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
        b = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
        _sync(torch)
        plan = (qm.gemv_plan if M <= qm.GEMV_MAX_M else qm.mma_plan)(
            M, K, N, sms)
        rep_plans[name] = plan._asdict()
        repeat[name] = bool(torch.equal(a, b))
        if not repeat[name]:
            raise AssertionError(f"quant_matmul {name}: two calls differ by "
                                 f"{float((a - b).abs().max())}")
    for kernel_rows in ((0, 8), (9, 1 << 30)):
        split = [p["splits"] for n, p in rep_plans.items()
                 if kernel_rows[0] <= rep_shapes[n][0] <= kernel_rows[1]]
        if min(split) != 1 or max(split) == 1:
            raise AssertionError(f"quant_matmul: the repeatability shapes "
                                 f"must hold split and unsplit plans of "
                                 f"each kernel, got {rep_plans}")

    # what three broken kernels would return, from the plain version: the
    # scale along K (the square wq shape), K short by one 32-row tile, and
    # (M > 8) K short by one 64-row step
    moves = {}
    for M, broken_names in ((4, ("scale_on_k_axis", "k_short_one_tile")),
                            (64, ("k_short_one_64_row_step",))):
        K, N = QM_DECODE["wq / wo"]
        x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.float32, seed=0,
                                  dev=dev)
        exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
        cut = {"k_short_one_tile": 32, "k_short_one_64_row_step": 64}
        for k in broken_names:
            v = (x @ (wq.float() * scale[:, None]) if k == "scale_on_k_axis"
                 else ref.quant_matmul_ref(x[:, :K - cut[k]],
                                           wq[:K - cut[k]], scale,
                                           out_dtype=torch.float32))
            moves[k] = float((v - exp).abs().max())
            if torch.allclose(v, exp, **QM_TOL["float32"]) \
                    or moves[k] <= QM_BROKEN_MOVES:
                raise AssertionError(f"quant_matmul: the broken version {k} "
                                     f"moves the output by only {moves[k]}")

    # timing: bf16 x as the draft runs it; the yardstick (never called by
    # the port) is torch.matmul on the weight dequantized to bf16
    # beforehand: the same product without int8 weights, reading twice the
    # weight bytes
    times = {f"decode {n}": time_gemv(torch, qm, ref, timer, 4, k, nn,
                                      dev=dev)
             for n, (k, nn) in QM_DECODE.items()}
    for M in QM_TIMED_M:
        for n, (k, nn) in QM_DECODE.items():
            times[f"prefill M={M} {n}"] = time_gemv(torch, qm, ref, timer,
                                                    M, k, nn, dev=dev)
    layer = {k: sum(QM_LAYER_LAUNCHES[n] * times[f"decode {n}"][k]
                    for n in QM_DECODE)
             for k in ("ms", "library_ms", "bound_ms")}
    draft_prefill = {f"M={M}": {k: DRAFT_LAYERS * sum(
        QM_LAYER_LAUNCHES[n] * times[f"prefill M={M} {n}"][k]
        for n in QM_DECODE) for k in ("ms", "library_ms", "bound_ms")}
        for M in QM_TIMED_M}
    row = times["decode w_gate / w_up"]
    return {
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:50",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": QM_TOL, "broken_moves": moves,
        "bitwise_repeatable": repeat, "repeat_plans": rep_plans,
        "prefill_plans": plans, "timed": times,
        "draft_layer_seven_launches": layer,
        "draft_prefill_56_launches": draft_prefill,
        "row_shape": "decode w_gate, M=4 bf16",
        "cold_weights": f"timers walk copies of each weight totalling >= "
        f"{QM_COLD_BYTES / 1e6:.0f} MB",
        "library_call": "torch.matmul(x_bf16, w_bf16) with w dequantized to "
        "bf16 beforehand (twice the int8 weight bytes; not the same "
        "rounding)",
        "ptxas_wgmma": _ptxas(qm.NAME, "wgmma_kernel")}


# ---------------------------------------------------------------------------
# phase 3: ssd_scan against the plain chunked path
# ---------------------------------------------------------------------------

def _ssd_inputs(torch, b, l, dtype, *, seed=0, dev="cuda", h=SSD_H,
                p=SSD_P, n=SSD_N):
    """x, dt, A, B, C at mamba2-370m's width (or h, p, n), with x, B and C
    as strided views into one (b, l, h*p + 2n) tensor, as the model hands
    them to the scan.  dt in [0.001, 0.021] and A in [-2, -0.5] keep a
    chunk's decay at ~0.1, so the carried state moves the next chunk's
    rows by about their own size: a dropped state or a missing decay
    shows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xbc = torch.cat([torch.randn((b, l, h * p), generator=g),
                     torch.randn((b, l, 2 * n), generator=g) * n ** -0.5],
                    dim=-1).to(dtype).to(dev)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = (torch.rand((b, l, h), generator=g) * 0.02 + 0.001).to(dev)
    A = -(torch.rand((h,), generator=g) * 1.5 + 0.5).to(dev)
    return x, dt, A, B, C


def _ssd_ops(b, l, h, p, n, Q) -> int:
    """Least operations of one scan: per (b, chunk) the score product
    C B^T once (every head shares B and C) over the causal pairs j <= i,
    Q (Q + 1) / 2 of them at n multiply-adds; per (b, h, chunk) the
    scores x (x dt) product over the same pairs at p, and the inter-chunk
    product and the state update at Q p n each."""
    nc = -(-l // Q)
    pairs = Q * (Q + 1) // 2
    return 2 * b * nc * (pairs * n + h * (pairs * p + 2 * Q * p * n))


def _ssd_bound(b, l, h, p, n, Q, x_elt: int, rate="float32"):
    """Least time (ms) of one scan: x, dt, A, B, C read once, y and the
    float32 final state written once, against ``_ssd_ops`` at the peak
    rate of ``rate``: bfloat16 for the bf16 instantiation, whose
    products run on the tensor cores, float32 for a scan on the CUDA
    cores."""
    nbytes = (2 * b * l * h * p * x_elt + b * l * h * 4 + h * 4
              + 2 * b * l * n * x_elt + b * h * p * n * 4)
    return _roofline(nbytes, _ssd_ops(b, l, h, p, n, Q), rate)


def _ssd_err(torch, got, want, dtype) -> tuple:
    """(max |got - want|, whether it is within SSD_TOL): float32 within
    SSD_F32_REL x max |want|; a bfloat16 y within one bfloat16 step of
    each value on top of that."""
    scale = float(want.abs().max())
    diff = (got.float() - want).abs()
    allowed = SSD_F32_REL * scale
    if dtype == torch.bfloat16:
        allowed = allowed + SSD_BF16_STEP * want.abs()
    return float(diff.max()), bool((diff <= allowed).all())


def _ssd_by_chunks(torch, ssm, x, dt, A, B, C, decay=True):
    """The plain chunked path one chunk at a time, the state carried in
    between: as the whole with ``decay``; without it, the broken version
    whose carried state skips each chunk's decay exp(cums_last)
    (state_c = state_{c-1} + local_c)."""
    ys, carried = [], None
    for i in range(0, x.shape[1], SSD_CHUNK):
        part = (x[:, i:i + SSD_CHUNK], dt[:, i:i + SSD_CHUNK], A,
                B[:, i:i + SSD_CHUNK], C[:, i:i + SSD_CHUNK], SSD_CHUNK)
        y, h_next = ssm.ssd_chunked(*part, h0=carried)
        ys.append(y)
        if not decay:
            local = ssm.ssd_chunked(*part)[1]
            h_next = local if carried is None else carried + local
        carried = h_next
    return torch.cat(ys, dim=1)


def check_ssd_scan(torch, ssd, ref, ssm, timer, dev="cuda"):
    """Hold the kernel against the model's plain chunked path in float32
    (``ssm.ssd_chunked`` without the kernel, on the same inputs rounded
    to the kernel's input type) at mamba2-370m's width and chunk for
    SSD_CASES (b 1 and 4, l 16 / 256 / 300 (ragged) / 1024 / 2048, up to
    8 chunks), at zamba2-7b's (112 heads, p 64, n 64) and at 30 heads, x
    in bf16 and f32; a split sequence continued through ``h0`` must
    equal the whole; three broken versions (the carried state dropped
    between chunks, the decay left out everywhere, the state passed
    without its decay) must land more than SSD_BROKEN_MOVES x max |y|
    away.  Times the kernel and the plain chunked path at SSD_TIMED (bf16,
    as the model serves) and its plain version (the sequential
    recurrence) at the first; no single PyTorch call computes this
    function."""
    errs, worst = {}, 0.0
    cases = [(b, l, {}) for b, l in SSD_CASES]
    cases += [(2, 1024, dict(zip("hpn", SSD_ZAMBA))), (4, 1024, {"h": 30})]
    for b, l, width in cases:
        for dt_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dt_name)
            x, dt, A, B, C = _ssd_inputs(torch, b, l, dtype, seed=b * l,
                                         dev=dev, **width)
            y, hf = ssd.ssd_scan(x, dt, A, B, C, chunk=SSD_CHUNK)
            _sync(torch)
            yr, hr = ssm.ssd_chunked(x.float(), dt, A, B.float(), C.float(),
                                     SSD_CHUNK)
            ey, oky = _ssd_err(torch, y, yr, dtype)
            eh, okh = _ssd_err(torch, hf, hr, torch.float32)
            name = f"b{b} l{l} {dt_name}" + "".join(
                f" {k}={v}" for k, v in width.items())
            if y.dtype != dtype or not (oky and okh) \
                    or not bool(torch.isfinite(y.float()).all()):
                raise AssertionError(
                    f"ssd_scan {name}: |y - plain| {ey}, |h - plain| {eh} "
                    f"(max |y| {float(yr.abs().max())})")
            errs[name] = {"y": ey, "h_final": eh}
            worst = max(worst, ey)
            del x, dt, B, C, y, hf, yr, hr
    # a split sequence: [0, 300) then [300, 1024) from its final state
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        x, dt, A, B, C = _ssd_inputs(torch, 4, 1024, dtype, seed=5, dev=dev)
        y_all, h_all = ssm.ssd_chunked(x.float(), dt, A, B.float(),
                                       C.float(), SSD_CHUNK)
        _, h1 = ssd.ssd_scan(x[:, :300], dt[:, :300], A, B[:, :300],
                             C[:, :300], chunk=SSD_CHUNK)
        y2, h2 = ssd.ssd_scan(x[:, 300:], dt[:, 300:], A, B[:, 300:],
                              C[:, 300:], chunk=SSD_CHUNK, h0=h1)
        _sync(torch)
        ey, oky = _ssd_err(torch, y2, y_all[:, 300:], dtype)
        eh, okh = _ssd_err(torch, h2, h_all, torch.float32)
        if not (oky and okh):
            raise AssertionError(f"ssd_scan h0 continuation {dt_name}: "
                                 f"|y - whole| {ey}, |h - whole| {eh}")
        errs[f"h0 continuation {dt_name}"] = {"y": ey, "h_final": eh}

    # broken versions, from the plain chunked path
    x, dt, A, B, C = _ssd_inputs(torch, 4, 1024, torch.float32, seed=9,
                                 dev=dev)
    want, _ = ssm.ssd_chunked(x, dt, A, B, C, SSD_CHUNK)
    got, _ = ssd.ssd_scan(x, dt, A, B, C, chunk=SSD_CHUNK)
    scale = float(want.abs().max())
    broken = {
        "state_dropped": torch.cat([ssm.ssd_chunked(
            x[:, i:i + SSD_CHUNK], dt[:, i:i + SSD_CHUNK], A,
            B[:, i:i + SSD_CHUNK], C[:, i:i + SSD_CHUNK], SSD_CHUNK)[0]
            for i in range(0, 1024, SSD_CHUNK)], dim=1),
        "no_decay": ssm.ssd_chunked(x, dt, torch.zeros_like(A), B, C,
                                    SSD_CHUNK)[0],
        "state_passed_without_decay": _ssd_by_chunks(
            torch, ssm, x, dt, A, B, C, decay=False),
    }
    moves = {k: float((v - want).abs().max()) / scale
             for k, v in broken.items()}
    for k, v in moves.items():
        if v <= SSD_BROKEN_MOVES or _ssd_err(torch, broken[k], want,
                                             torch.float32)[1]:
            raise AssertionError(f"ssd_scan: the broken version {k} moves "
                                 f"y by only {v} x max |y|")
    if not _ssd_err(torch, got, want, torch.float32)[1] or not _ssd_err(
            torch, _ssd_by_chunks(torch, ssm, x, dt, A, B, C), want,
            torch.float32)[1]:
        raise AssertionError("ssd_scan: kernel (or the chunk-by-chunk plain "
                             "path) off the plain chunked path")

    # timing, bf16 as served; the row: the path's largest prefill
    times = {}
    for b, l in SSD_TIMED:
        x, dt, A, B, C = _ssd_inputs(torch, b, l, torch.bfloat16, seed=7,
                                     dev=dev)
        Q = min(SSD_CHUNK, l)
        row = {"ms": timer(torch, lambda i: ssd.ssd_scan(
            x, dt, A, B, C, chunk=SSD_CHUNK)),
            "chunked_path_ms": timer(torch, lambda i: ssm.ssd_chunked(
                x, dt, A, B, C, SSD_CHUNK), iters=5, warmup=1),
            "ops": _ssd_ops(b, l, SSD_H, SSD_P, SSD_N, Q)}
        for rate in ("bfloat16", "float32"):
            row[f"bound_ms_{rate}"], row[f"bound_by_{rate}"] = _ssd_bound(
                b, l, SSD_H, SSD_P, SSD_N, Q, 2, rate)
        if not times:
            row["plain_ms"] = timer(torch, lambda i: ref.ssd_scan_ref(
                x, dt, A, B, C), iters=3, warmup=1)
        times[f"b={b} l={l}"] = row
    # zamba2-7b's width on its served prefill
    b, l = SSD_ZAMBA_TIMED
    h, p, n = SSD_ZAMBA
    x, dt, A, B, C = _ssd_inputs(torch, b, l, torch.bfloat16, seed=8,
                                 dev=dev, h=h, p=p, n=n)
    Q = min(SSD_CHUNK, l)
    row = {"ms": timer(torch, lambda i: ssd.ssd_scan(
        x, dt, A, B, C, chunk=SSD_CHUNK)),
        "chunked_path_ms": timer(torch, lambda i: ssm.ssd_chunked(
            x, dt, A, B, C, SSD_CHUNK), iters=5, warmup=1),
        "plain_ms": timer(torch, lambda i: ref.ssd_scan_ref(
            x, dt, A, B, C), iters=3, warmup=1),
        "ops": _ssd_ops(b, l, h, p, n, Q)}
    for rate in ("bfloat16", "float32"):
        row[f"bound_ms_{rate}"], row[f"bound_by_{rate}"] = _ssd_bound(
            b, l, h, p, n, Q, 2, rate)
    times[f"zamba2 b={b} l={l} h={h} p={p} n={n}"] = row
    del x, dt, B, C
    first = next(iter(times.values()))
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:69",
        "max_abs_err": worst, "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms_bfloat16"],
        "bound_by": first["bound_by_bfloat16"], "library_ms": None,
    }, {"errors": errs,
        "tolerance": f"{SSD_F32_REL} x max |y| (float32); plus one bf16 "
        f"step ({SSD_BF16_STEP} x |y|) for a bf16 y",
        "broken_moves_share_of_max_y": moves,
        "row_shape": f"b=4 l=1024 h={SSD_H} p={SSD_P} n={SSD_N} "
        f"chunk={SSD_CHUNK}, bf16 x/B/C as strided views",
        "timed": times,
        "bound_note": "the row's bound is at the bf16 tensor-core rate, "
        "where the bf16 instantiation runs its products; bound_ms_float32 "
        "is a scan on the CUDA cores",
        "plain": "ref.ssd_scan_ref, the sequential recurrence",
        "library_call": "none: no single PyTorch call computes the scan",
        "ptxas_bf16": _ptxas_bf16(ssd.NAME)}


# ---------------------------------------------------------------------------
# phase 3: flash_attention against its plain version
# ---------------------------------------------------------------------------

def _flash_inputs(torch, B, S, T, H, K, hd, dtype, *, seed=0, dev="cuda"):
    """q at 3 x randn, k and v at 0.5 x randn: each softmax is peaked,
    so a key seen or missed moves the output far past the tolerances."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g) * 3.0
    k = torch.randn((B, T, K, hd), generator=g) * 0.5
    v = torch.randn((B, T, K, hd), generator=g) * 0.5
    return tuple(t.to(dtype).to(dev) for t in (q, k, v))


def _flash_pairs(S: int, T: int, window: int) -> int:
    """Visible (query, key) pairs of one (row, head): key j <= i (and
    j > i - window), j < T."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        total += max(0, min(i, T - 1) - lo + 1)
    return total


def _flash_bound(B, S, T, H, K, hd, window, elt: int, rate: str):
    """Least time (ms) of one call: q, k, v read once and the output
    written once, against 4 hd operations (q.k and p.v) per visible pair
    and query head at the peak rate of ``rate``."""
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * elt
    ops = 4 * hd * H * B * _flash_pairs(S, T, window)
    return _roofline(nbytes, ops, rate) + (ops,)


def _flash_shifted(torch, q, k, v, scale, window):
    """A broken kernel: the causal mask one key late (query i also sees
    key i + 1, and the window moves with it), in float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None] + 1
    j = torch.arange(T, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(q.shape)


def check_flash_attention(torch, fa, ref, timer, dev="cuda"):
    """Hold the kernel against its plain version computed in float64 on
    the same inputs (the float32 plain version's own summation errors
    reach the bf16 tolerance in near-tie rows at scale 1:
    ``exact_misses_float32_plain`` counts the outputs where even the
    exact result, rounded to the kernel's dtype, misses it) at the
    evaluation path's shape, window 0 and 512, and beside it (phi3's
    GQA, a ragged S, T < S and T > S), bf16 and f32;
    a softcap of 50 at scale 1 must bind; two broken versions (window
    ignored, causal mask one key late) must land far outside the
    tolerance; the window-512 launch must take under FLASH_BAND_SHARE of
    the global launch's time.  Times the kernel, the plain version and
    SDPA at the path's shape, next to the bound."""
    import torch.nn.functional as F
    errs, worst, errs_f32, exact_misses = {}, 0.0, {}, {}

    def held(case, q, k, v, **kw):
        nonlocal worst
        out = fa.flash_attention(q, k, v, **kw)
        _sync(torch)
        exp = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                      **kw)
        tol = TOL[str(q.dtype).replace("torch.", "")]
        err = float((out.double() - exp).abs().max())
        if out.dtype != q.dtype or not torch.allclose(out.double(), exp,
                                                      **tol):
            raise AssertionError(f"flash_attention {case}: max abs err {err} "
                                 f"beyond tolerance {tol}")
        plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        errs_f32[case] = float((out.float() - plain).abs().max())
        exact_misses[case] = int((~torch.isclose(
            exp.to(q.dtype).float(), plain, **tol)).sum())
        errs[case] = err
        worst = max(worst, err)
        return out.float(), exp.float()

    for seed, (name, B, S, T, H, K, hd, w) in enumerate(FLASH_CASES):
        for dt in ("bfloat16", "float32"):
            q, k, v = _flash_inputs(torch, B, S, T, H, K, hd,
                                    getattr(torch, dt), seed=seed, dev=dev)
            held(f"{name} {dt}", q, k, v, scale=hd ** -0.5, window=w)
    q, k, v = _flash_inputs(torch, 2, 1024, 1024, 4, 1, 256, torch.bfloat16,
                            seed=20, dev=dev)
    capped, _ = held("softcap50/scale1", q, k, v, scale=1.0,
                     window=FLASH_WINDOW, softcap=50.0)
    free, _ = held("softcap0/scale1", q, k, v, scale=1.0,
                   window=FLASH_WINDOW)
    cap_moves = float((capped - free).abs().max())
    if cap_moves <= CAP_MOVES:
        raise AssertionError(f"flash_attention: softcap 50 moved the output "
                             f"by only {cap_moves}")

    # broken versions at the path's local launch, from the plain version
    B, S, T, H, K, hd = FLASH_PATH
    scale = hd ** -0.5
    q, k, v = _flash_inputs(torch, B, S, T, H, K, hd, torch.bfloat16,
                            seed=21, dev=dev)
    got, want = held("path local bf16 (broken check)", q, k, v, scale=scale,
                     window=FLASH_WINDOW)
    broken = {"window_ignored": ref.flash_attention_ref(
                  q.float(), k.float(), v.float(), scale=scale),
              "mask_one_key_late": _flash_shifted(torch, q, k, v, scale,
                                                  FLASH_WINDOW)}
    moves = {n: float((b - want).abs().max()) for n, b in broken.items()}
    for n, b in broken.items():
        if moves[n] <= CAP_MOVES or torch.allclose(b, want,
                                                   **TOL["bfloat16"]):
            raise AssertionError(f"flash_attention: the broken version {n} "
                                 f"moves the output by only {moves[n]}")
    del broken, got, want

    # times at the path's shape, bf16 as the evaluation runs
    times = {}
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    for w in (0, FLASH_WINDOW):
        ms = timer(torch, lambda i, w=w: fa.flash_attention(
            q, k, v, scale=scale, window=w))
        plain_ms = timer(torch, lambda i, w=w: ref.flash_attention_ref(
            q, k, v, scale=scale, window=w), iters=10, warmup=2)
        if w:
            i_ = torch.arange(S, device=q.device)[:, None]
            j_ = torch.arange(T, device=q.device)[None, :]
            mask = (j_ <= i_) & (j_ > i_ - w)
            lib_kw = dict(attn_mask=mask)
        else:
            lib_kw = dict(is_causal=True)
        library_ms = timer(torch, lambda i, kw=lib_kw: (
            F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                           enable_gqa=True, **kw)))
        bound_ms, bound_by, ops = _flash_bound(B, S, T, H, K, hd, w, 2,
                                               "bfloat16")
        f32_ms, f32_by, _ = _flash_bound(B, S, T, H, K, hd, w, 2, "float32")
        times["global" if w == 0 else "local"] = {
            "window": w, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ops": ops,
            "bound_float32_rate_ms": f32_ms, "bound_float32_rate_by": f32_by}
    lib = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                         enable_gqa=True, is_causal=True)
    lib_err = float((lib.transpose(1, 2).float() - ref.flash_attention_ref(
        q.float(), k.float(), v.float(), scale=scale)).abs().max())
    del lib, qt, kt, vt

    # zamba2-7b's admission prefill: 32 heads over 32 kv heads of 112
    # (the 128-wide instantiation), causal, bf16
    hB, hS, hT, hH, hK, hhd = FLASH_HYBRID
    hq, hk, hv = _flash_inputs(torch, *FLASH_HYBRID, torch.bfloat16,
                               seed=22, dev=dev)
    hscale = hhd ** -0.5
    hqt, hkt, hvt = (t.transpose(1, 2).contiguous() for t in (hq, hk, hv))
    bound_ms, bound_by, ops = _flash_bound(*FLASH_HYBRID, 0, 2, "bfloat16")
    times["zamba2 prefill"] = {
        "shape": f"B={hB} S=T={hS} H={hH} K={hK} hd={hhd} bf16 causal",
        "ms": timer(torch, lambda i: fa.flash_attention(
            hq, hk, hv, scale=hscale)),
        "plain_ms": timer(torch, lambda i: ref.flash_attention_ref(
            hq, hk, hv, scale=hscale), iters=10, warmup=2),
        "library_ms": timer(torch, lambda i: F.scaled_dot_product_attention(
            hqt, hkt, hvt, scale=hscale, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops}
    del hq, hk, hv, hqt, hkt, hvt
    share = times["local"]["ms"] / times["global"]["ms"]
    if share >= FLASH_BAND_SHARE:
        raise AssertionError(f"flash_attention: the window-512 launch takes "
                             f"{share} of the global launch's time (band "
                             f"skipping must keep it under "
                             f"{FLASH_BAND_SHARE})")
    row = times["global"]
    from repro_torch.kernels import build
    log = build.library_path("flash_attention").with_suffix(".log")
    ptxas = ptxas_report(log, "mma_kernel") if log.exists() else {}
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:366",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL,
        "reference": "ref.flash_attention_ref on float64 copies",
        "errors_vs_float32_plain": errs_f32,
        "exact_misses_float32_plain": exact_misses,
        "softcap50_moves": cap_moves,
        "broken_moves": moves, "timed": times,
        "local_over_global_time": share,
        "local_over_global_work": times["local"]["ops"] / row["ops"],
        "row_shape": "B=2 S=T=4096 H=4 K=1 hd=256 bf16, window 0 (the "
        "global layers; the local window-512 launch under timed.local)",
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True), "
        "is_causal for window 0, a boolean band mask for window 512",
        "library_max_abs_err": lib_err, "ptxas_bf16_kernel": ptxas}


# ---------------------------------------------------------------------------
# phases 4-14
# ---------------------------------------------------------------------------

def serve_phase(torch, kernels, serve, scale="full", dev="cuda"):
    """Drive the first main path (bf16 pool); returns (engine, cfg,
    phase fields).  ``kernels`` maps each kernel's name to its wrapper
    module (with its ``launches`` counter)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(ARCH, scale, SERVE, dev)
    init_s = clock() - t0
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": 0, "quant_matmul": 0, "ssd_scan": 0},
        needs=("paged_attention",))
    fields["init_s"] = init_s
    return eng, cfg, fields


def serve_int8_phase(torch, kernels, serve, eng0, cfg):
    """Drive the second main path: the first engine's model and traffic
    on an int8 pool; returns (engine, phase fields)."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **SERVE), device=eng0.device)
    L = cfg.num_layers
    return eng, _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": L * eng.extend_waves, "quant_matmul": 0,
        "ssd_scan": 0},
        needs=("paged_attention", "paged_extend_attention"))


def _drive(torch, kernels, serve, eng, cfg, expected, needs,
           traffic=(N_REQ, MIN_PROMPT, MAX_PROMPT, MAX_NEW)):
    """Serve the phase's traffic (requests, shortest and longest prompt,
    new tokens) through ``eng`` with every kernel count zeroed just
    before and read just after; check the output, that each kernel made
    exactly the launches ``expected()`` gives after the run (one per
    layer of each wave or prefill that goes through it), and that every
    kernel of ``needs`` — the phase's path — launched at all."""
    dev = eng.device
    n_req, _, _, max_new = traffic
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reqs = serve.make_requests(cfg, *traffic, eng.scfg.policy)
    _zero(kernels)
    raw = serve.run_drain(eng, reqs)
    launches = _counts(kernels)
    done = eng.completed
    if len(done) != n_req or any(len(r.generated) != max_new for r in done):
        raise AssertionError(f"serve: {len(done)} requests done, lengths "
                             f"{[len(r.generated) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("serve: token id outside the vocabulary")
    expect = dict.fromkeys(kernels, 0)
    expect.update(expected())
    if launches != expect or any(launches[n] == 0 for n in needs):
        raise AssertionError(
            f"serve: kernel launches {launches} for {eng.decode_waves} "
            f"decode and {eng.extend_waves} extend waves x "
            f"{cfg.num_layers} layers (expected {expect}, none 0 of "
            f"{needs})")
    if eng.paged:
        eng.pool.assert_consistent()
        if eng.pool.num_free != eng.pool.num_blocks:
            raise AssertionError(f"serve: {eng.pool.num_used} pages leaked")
    ttft = raw["ttft_ms"]
    return {
        "arch": cfg.name, "depth": cfg.num_layers, "depth_cut": False,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "param_dtype": cfg.param_dtype,
        "kv_pool": (str(_pool(eng)["k"].dtype).replace("torch.", "")
                    if eng.paged else "none (pool-free)"),
        "requests": raw["requests"], "tokens": raw["tokens"],
        "steps": raw["decode_steps"], "decode_waves": eng.decode_waves,
        "extend_waves": eng.extend_waves, "elapsed_s": raw["elapsed_s"],
        "tok_per_s": raw["tok_per_s"],
        "ms_per_step": raw["elapsed_s"] * 1e3 / raw["decode_steps"],
        "ttft_p50_ms": ttft[len(ttft) // 2],
        "ttft_p99_ms": ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None),
    }


def _pool(eng) -> dict:
    """The engine's page pool: every layer's on a uniform trunk, the
    global layers' on a local:global pattern."""
    cache = eng.cache
    return cache["layers"] if "layers" in cache else cache["super"]["global"]


def _device_profile(torch, fn) -> dict:
    """One profiled call of ``fn``: wall ms, device-busy ms (sum of the
    kernels' own times), idle share, and the top ops by device time.
    Busy time sums the device events only: an operator's row repeats the
    time of the kernels it launched, so summing every row counts each
    kernel twice."""
    from torch.autograd import DeviceType
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
    busy = sum(dev_us(e) for e in evs if e.device_type != DeviceType.CPU) \
        / 1e3
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
    B = 4
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)
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


def _wave_state(torch, eng, cfg, S, dev):
    """Block tables, positions and tokens of one 4-slot wave over the
    engine's pool: rows at positions 300, 211, 97, 33 with tables
    covering them and S more tokens (pages of the served pool)."""
    B, bs = 4, eng.block_size
    lengths = [300, 211, 97, 33]
    bt = torch.full((B, eng.n_blk), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        k = -(-(n + S) // bs)
        bt[b, :k] = torch.arange(b * eng.n_blk, b * eng.n_blk + k)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    return lengths, bt.to(dev), pos, tok


def _layerwise_blocks(torch, cfg, params, cache, tokens, block):
    """Run the trunk block by block through the gather read and, at
    every layer, the same block through the kernel read on the same
    input and a copy of the same pool: the two outputs then differ in
    summation order only.  Returns the largest per-layer max |kernel -
    gather| and whether every layer's pair is within TOL["float32"]."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    x = L.embed(cfg, params["embed"], tokens)
    worst, ok = 0.0, True
    for lp, pool in T.paged_layers(cfg, params, cache):
        shadow = {k: v.clone() for k, v in pool.items()}
        ker, _ = block(lp, x, shadow, True)
        x, _ = block(lp, x, pool, False)
        worst = max(worst, float((ker - x).abs().max()))
        ok = ok and bool(torch.allclose(ker, x, **TOL["float32"]))
    return worst, ok


def model_int8_phase(torch, M, eng, cfg, dev="cuda"):
    """On the int8 pool of the served model, kernel reads against gather
    reads at float32 activations, for decode and for extend.

    Every layer is held on identical inputs: the trunk runs through the
    gather read, and each block also runs through the kernel read on the
    same input and a copy of the same pool; the outputs must agree within
    TOL["float32"].  This takes the place of holding two full-model runs'
    logits within F32_REL_TOL x max |logit|: each run quantizes the K/V
    it writes, so float noise between the runs moves some written bytes
    by one int8 level (a step of max |k| / 127, far above float32
    rounding), and the step travels on through the later layers.  The
    two runs' logits are reported beside the count of written bytes that
    differ, and their greedy tokens must agree.  Times one extend and
    one decode wave of each read at the serving bf16 activations."""
    from repro_torch.models import transformer as T
    S = eng.K
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, S, dev)
    cfg32 = cfg.replace(dtype="float32")
    pool = eng.cache["layers"]
    runs = {
        "decode": (tok[:, :1], lambda c, k: M.decode_step_paged(
            c, eng.params, eng.cache, tok[:, :1], pos, bt, k)[0][:, 0],
            lambda lp, x, pg, k: T.block_decode_paged(cfg32, lp, x, pg, pos,
                                                      bt, k)),
        "extend": (tok, lambda c, k: M.extend_paged(
            c, eng.params, eng.cache, tok, pos, bt, None, k)[0],
            lambda lp, x, pg, k: T.block_extend_paged(
                cfg32, lp, x, pos, pg, bt, None, use_pallas=k)),
    }
    res = {"lengths": lengths, "extend_tokens": S,
           "layer_tolerance": TOL["float32"],
           "logits": "reported, not held: see the written bytes that differ"}
    for name, (tokens, full, block) in runs.items():
        layer_err, layer_ok = _layerwise_blocks(torch, cfg32, eng.params,
                                                eng.cache, tokens, block)
        if not layer_ok:
            raise AssertionError(f"model_int8: {name} kernel read differs "
                                 f"from the gather read on identical "
                                 f"inputs by {layer_err}")
        ker = full(cfg32, True).float()
        written = {k: pool[k].clone() for k in ("k", "v")}
        gat = full(cfg32, False).float()
        if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
            raise AssertionError(f"model_int8: non-finite {name} logits")
        differ = sum(int((pool[k] != written[k]).sum()) for k in written)
        del written
        same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
        total = ker.argmax(-1).numel()
        res.update({f"{name}_layerwise_max_abs_err": layer_err,
                    f"{name}_max_abs_logit_f32": float(gat.abs().max()),
                    f"{name}_f32_kernel_vs_gather":
                        float((ker - gat).abs().max()),
                    f"{name}_written_bytes_differ": differ,
                    f"{name}_argmax_agree_f32": f"{same}/{total}"})
        if same != total:
            raise AssertionError(f"model_int8: {name} greedy tokens agree "
                                 f"{same}/{total}")
    for name, call in (
            ("extend", lambda k: M.extend_paged(cfg, eng.params, eng.cache,
                                                tok, pos, bt, None, k)),
            ("decode", lambda k: M.decode_step_paged(
                cfg, eng.params, eng.cache, tok[:, :1], pos, bt, k))):
        for k in (True, False):
            res[f"{name}_wave_ms_{'kernel' if k else 'gather'}"] = cuda_ms(
                torch, lambda i, k=k, call=call: call(k), iters=10,
                warmup=2)
    res["extend_wave_profile"] = _device_profile(torch, lambda: M.extend_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, None, True))
    return res


def _tree(fn, tree):
    return {k: (_tree(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def make_draft(cfg, params, n: int):
    """The explicit draft of the speculative phases: the verify model's
    first ``n`` trunk layers, copied out of the stacked trunk, its
    embedding and unembedding by reference, and an early-exit norm as
    the final norm (``core.earlyexit.init_exit_heads``).  Built here, not
    in the package: the engine refuses ``quant_draft`` for the
    by-reference self-draft, and quantizing a reference to the whole
    trunk would make an int8 copy of all of it."""
    from repro_torch.core.earlyexit import init_exit_heads
    from repro_torch.devices import tensor_device
    dparams = dict(params)
    dparams["trunk"] = {"layers": _tree(lambda t: t[:n].clone(),
                                        params["trunk"]["layers"])}
    dparams["final_norm"] = init_exit_heads(
        cfg, [n - 1], device=tensor_device(params))["exits"][0]["ln"]
    return cfg.replace(num_layers=n, name=f"{cfg.name}-draft{n}"), dparams


def _count_calls(obj, names, counter: dict) -> None:
    """Wrap the methods ``names`` of ``obj`` (on the instance) so each
    call adds one to ``counter[name]``."""
    for name in names:
        fn = getattr(obj, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counter[_name] += 1
            return _fn(*a, **kw)
        setattr(obj, name, counted)


def _projection_bytes(tree) -> int:
    """Bytes of the projection weights of a (draft) parameter tree: the
    int8 bytes plus scales of {"q", "scale"} leaves, or the float
    leaves' bytes."""
    from repro_torch.models.layers import QUANT_WEIGHT_DIMS
    total = 0
    for name, sub in tree.items():
        if name in QUANT_WEIGHT_DIMS:
            leaves = sub.values() if isinstance(sub, dict) else [sub]
            total += sum(t.numel() * t.element_size() for t in leaves)
        elif isinstance(sub, dict):
            total += _projection_bytes(sub)
    return total


def serve_spec_phase(torch, kernels, serve, M, params, cfg, dev="cuda"):
    """Drive the third main path: the served model and traffic with
    speculative decoding on an int8 pool and an int8 draft of its first
    DRAFT_LAYERS layers.  Every wave is a verify extend wave; the draft's
    forward calls are counted around ``SpecDecoder._decode`` /
    ``_prefill``, each of which must run its 7 projections per layer
    through ``quant_matmul``.  Also times one draft decode step with the
    same layers in bf16 (before serving) and in int8 (after).  Returns
    phase fields."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    dcfg, dparams = make_draft(cfg, params, DRAFT_LAYERS)
    # one draft decode step (4 rows) on a dense cache of the path's size,
    # bf16 weights first: the bf16 copy is dropped before serving
    cache = M.init_cache(dcfg, 4, SERVE["max_len"], dev)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([300, 211, 97, 33], dtype=torch.int32, device=dev)

    def draft_step_ms(p):
        return cuda_ms(torch, lambda i: M.decode_step(dcfg, p, cache, tok,
                                                      pos),
                       iters=10, warmup=2)
    bf16 = {"draft_bf16_projection_bytes": _projection_bytes(dparams),
            "draft_step_ms_bf16": draft_step_ms(dparams)}
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8", **SPEC,
        **SERVE), device=dev, draft=(dcfg, dparams))
    del dparams
    calls = {"_decode": 0, "_prefill": 0}
    _count_calls(eng.spec, calls, calls)
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": 0,
        "paged_extend_attention": L * eng.extend_waves,
        "quant_matmul": 7 * DRAFT_LAYERS * sum(calls.values()),
        "ssd_scan": 0},
        needs=("paged_extend_attention", "quant_matmul"))
    st = eng.stats()
    if st["spec_rounds"] < 1 or not st["quant_draft"] \
            or eng.decode_waves != 0:
        raise AssertionError(f"serve_spec: {st} with {eng.decode_waves} "
                             "decode waves")
    fields.update(
        draft_layers=DRAFT_LAYERS, draft_calls=dict(calls),
        spec_rounds=st["spec_rounds"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"],
        spec_acceptance=st["spec_acceptance"],
        spec_tokens_per_round=st["spec_tokens_per_round"],
        acceptance_note="both models have random weights: acceptance near "
        "0 is expected and is no target",
        draft_int8_projection_bytes=_projection_bytes(eng.spec.params),
        draft_step_ms_int8=draft_step_ms(eng.spec.params), **bf16)
    fields["draft_step_profile_int8"] = _device_profile(
        torch, lambda: M.decode_step(dcfg, eng.spec.params, cache, tok, pos))
    # one draft admission prefill of a full group: 4 rows padded to the
    # bucket, M = 4 x DRAFT_BUCKET rows through each of the 7 x 8 int8
    # projections (SpecDecoder.admit_group's call)
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, cfg.vocab_size, (4, DRAFT_BUCKET), generator=g,
                         dtype=torch.int32).to(dev)
    true_len = torch.tensor([DRAFT_BUCKET, 400, 300, 200], dtype=torch.int32,
                            device=dev)

    def draft_prefill():
        return M.prefill(dcfg, eng.spec.params, {"tokens": rows},
                         SERVE["max_len"], true_len=true_len)
    before = kernels["quant_matmul"].launches
    draft_prefill()
    fields.update(
        draft_prefill_rows=[4, DRAFT_BUCKET],
        draft_prefill_quant_matmul_launches=kernels["quant_matmul"].launches
        - before,
        draft_prefill_ms_int8=cuda_ms(torch, lambda i: draft_prefill(),
                                      iters=5, warmup=1),
        draft_prefill_profile_int8=_device_profile(torch, draft_prefill))
    return fields


def _serve_pool_free(torch, kernels, serve, M, arch, serve_kw, traffic,
                     per_prefill, scale, dev):
    """Serve ``traffic`` through ``launch.serve.build_engine(arch)``
    behind the pool-free engine (``use_pallas_paged=True``).  Admission
    prefill calls are counted around the engine's ``_admit_group`` (one
    fused prefill each, no pool to refuse a row), and each kernel of
    ``per_prefill(cfg)`` ({name: launches per prefill call}) must have
    launched that many times per call, every other kernel never.  Also
    times and profiles one 4-row decode wave.  Returns (engine, cfg,
    phase fields)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(arch, scale, serve_kw, dev)
    init_s = clock() - t0
    if eng.paged or eng.pool is not None:
        raise AssertionError(f"serve {arch}: the pool-free engine has a "
                             "page pool")
    calls = {"_admit_group": 0}
    _count_calls(eng, calls, calls)
    per = per_prefill(cfg)
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        name: n * calls["_admit_group"] for name, n in per.items()},
        needs=tuple(per), traffic=traffic)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((4,), dtype=torch.int32, device=dev)

    def wave():
        return M.decode_step(cfg, eng.params, eng.cache, tok, pos)
    fields.update(
        init_s=init_s, paged=eng.paged, prefill_calls=calls["_admit_group"],
        prefill_buckets=list(serve_kw["prefill_buckets"]),
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave))
    return eng, cfg, fields


def serve_ssm_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the fourth main path: mamba2-370m at full width and depth
    behind the pool-free engine: every layer of every admission prefill
    scans through ``ssd_scan``; no paged or quant kernel runs."""
    return _serve_pool_free(torch, kernels, serve, M, SSM_ARCH, SSM_SERVE,
                            SSM_TRAFFIC,
                            lambda cfg: {"ssd_scan": cfg.num_layers}, scale,
                            dev)


def model_ssm_phase(torch, M, eng, cfg, dev="cuda"):
    """``ssm.prefill`` of one 4-row bucket-1024 batch with ragged
    ``true_len`` through the kernel and through the plain chunked path:
    at float32 activations the logits must agree within F32_REL_TOL x
    max |logit|, every layer's final SSM state within F32_REL_TOL x max
    |state|, and the greedy next tokens must be equal; then one such
    prefill of each is timed at the serving bf16 activations."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                           dtype=torch.int32).to(dev)
    true_len = torch.tensor([1000, 777, 513, 300], dtype=torch.int32,
                            device=dev)
    batch = {"tokens": tokens}

    def run(c, use_kernel):
        return M.prefill(c, eng.params, batch, SSM_SERVE["max_len"],
                         true_len=true_len, use_kernel=use_kernel)
    cfg32 = cfg.replace(dtype="float32")
    ker, ker_cache = run(cfg32, True)
    gat, gat_cache = run(cfg32, False)
    ker, gat = ker[:, 0].float(), gat[:, 0].float()
    if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
        raise AssertionError("model_ssm: non-finite logits")
    scale = float(gat.abs().max())
    d_logit = float((ker - gat).abs().max())
    st_k, st_g = ker_cache["layers"]["ssm"], gat_cache["layers"]["ssm"]
    st_scale = float(st_g.abs().max())
    d_state = float((st_k - st_g).abs().max())
    same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
    if d_logit > F32_REL_TOL * scale or d_state > F32_REL_TOL * st_scale \
            or same != 4:
        raise AssertionError(
            f"model_ssm: kernel vs plain chunked prefill: logits differ by "
            f"{d_logit} (max {scale}), states by {d_state} (max "
            f"{st_scale}), greedy tokens agree {same}/4")
    del ker_cache, gat_cache
    times = {k: cuda_ms(torch, lambda i, k=k: run(cfg, k), iters=5, warmup=1)
             for k in (True, False)}
    return {"rows": 4, "bucket": 1024, "true_len": true_len.tolist(),
            "max_abs_logit_f32": scale, "f32_kernel_vs_plain": d_logit,
            "f32_tolerance": f"{F32_REL_TOL} x max |logit|",
            "max_abs_state_f32": st_scale, "f32_state_kernel_vs_plain":
            d_state, "state_tolerance": f"{F32_REL_TOL} x max |state|",
            "greedy_agree_f32": f"{same}/4",
            "prefill_ms_bf16_kernel": times[True],
            "prefill_ms_bf16_plain_chunked": times[False],
            "prefill_profile_bf16_kernel": _device_profile(
                torch, lambda: run(cfg, True))}


def _reference_pool_free(torch, serve_mod, get_smoke_config, kernels, arch,
                         needs, dev):
    """``arch``'s smoke config at float32 behind the pool-free engine,
    prompts of 4-150 tokens (those past the largest bucket, 64, catch up
    one token a decode wave): the card (hand kernels) and the CPU (plain
    versions) must emit the same greedy tokens, and each kernel of
    ``needs`` must have launched on the card.  Returns (card launches,
    longest prompt)."""
    from repro_torch.models import model as M
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = {}
    for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
        eng = EdgeServingEngine(cfg, _to(params, leg_dev), ServeConfig(
            max_slots=3, max_len=192, prefix_cache=False,
            use_pallas_paged=True, policy="priority",
            prefill_buckets=(16, 32, 64)), device=leg_dev)
        reqs = serve_mod.make_requests(cfg, 6, 4, 150, 8, "priority")
        _zero(kernels)
        serve_mod.run_drain(eng, reqs)
        tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
    launches = _counts(kernels)
    longest = max(len(r.prompt) for r in reqs)
    if tokens["card"] != tokens["cpu"] or len(tokens["cpu"]) != 6 \
            or any(launches[n] == 0 for n in needs) or longest <= 64:
        raise AssertionError(f"reference {arch}: card tokens "
                             f"{tokens['card']} vs CPU {tokens['cpu']}, "
                             f"launches {launches}, longest prompt "
                             f"{longest}")
    return launches, longest


def reference_ssm(torch, serve_mod, get_smoke_config, kernels, dev="cuda"):
    """The mamba2 smoke config: card (``ssd_scan``) tokens equal to the
    CPU's (the sequential plain version)."""
    launches, longest = _reference_pool_free(
        torch, serve_mod, get_smoke_config, kernels, SSM_ARCH,
        ("ssd_scan",), dev)
    return {"ssm_arch": f"{SSM_ARCH} smoke, float32",
            "ssm_tokens_equal": True,
            "ssm_ssd_scan_launches": launches["ssd_scan"],
            "ssm_longest_prompt_past_bucket_64": longest > 64}


def train_phase(torch, kernels, train, M, argv=TRAIN_ARGV, dev="cuda"):
    """Drive the fifth main path's training half: gemma3-1b at full width
    and depth through ``repro_torch.launch.train``'s own flags, state and
    step (bigram data, AdamW, remat ``nothing_saveable``), timing each
    step to a synchronised end.  The step runs the plain attention under
    autograd (no kernel has a backward), so every kernel count stays 0.
    Returns (cfg, state, phase fields)."""
    clock = train.default_clock
    args = train.parse_args([*argv, "--device", dev])
    on_card = dev != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    cfg, state, step, it = train.build(args)
    init_s = clock() - t0
    _zero(kernels)
    steps = []
    for i in range(args.steps):
        batch = next(it)
        t0 = clock()
        state, m = step(state, batch)
        _sync(torch)
        steps.append({"step": i, "ms": (clock() - t0) * 1e3,
                      **{k: float(v) for k, v in m.items()}})
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched in a training step: "
                             f"{launches}")
    if not all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
               for st in steps):
        raise AssertionError(f"train: non-finite loss or grad norm {steps}")
    tokens = args.batch * args.seq
    later = [st["ms"] for st in steps[1:]] or [steps[0]["ms"]]
    fields = {
        "arch": cfg.name, "depth": cfg.num_layers, "depth_cut": False,
        "d_model": cfg.d_model, "params": M.count_params(state["params"]),
        "flags": vars(args), "init_s": init_s,
        "steps": steps, "tokens_per_step": tokens,
        "ms_per_step_after_first": sum(later) / len(later),
        "tokens_per_s": tokens / (sum(later) / len(later) / 1e3),
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}
    batch = next(it)
    fields["step_profile"] = _device_profile(torch,
                                             lambda: step(state, batch))
    return cfg, state, fields


def _trunk_order(cfg, trunk):
    """(layer params, is_global) in the trunk's order: each super-block's
    locals, its global, then the remainder locals."""
    from repro_torch.models.transformer import _layer
    nb, rem = cfg.pattern_blocks()
    out = []
    for i in range(nb):
        sp = _layer(trunk["super"], i)
        out += [(_layer(sp["local"], j), False)
                for j in range(cfg.pattern_period - 1)]
        out.append((sp["global"], True))
    out += [(_layer(trunk["rem_local"], i), False) for i in range(rem)]
    return out


def model_train_phase(torch, kernels, M, cfg, params, dev="cuda"):
    """Drive the fifth path's evaluation half on the trained weights:
    ``loss_fn(use_flash=True)`` against ``loss_fn(use_flash=False)`` under
    ``torch.no_grad()`` on a 2 x 4096 bigram batch.  At float32
    activations (TF32 off) the CE must agree within CE_F32_REL and the
    logits within LOGIT_F32_REL x max |logit|; at bf16 every layer's
    ``attention_fwd`` through the kernel and through the plain path, on
    identical inputs, within LAYER_BF16_REL x max |o| (the full-model CE
    gap is reported only).  ``flash_attention`` must launch once per
    layer of every forward through it, and nothing else may launch.
    Returns phase fields."""
    from repro_torch.data import DataConfig, synthetic_tokens
    from repro_torch.models import layers as L
    toks = torch.from_numpy(synthetic_tokens(
        DataConfig(seed=1, branching=4), cfg.vocab_size, EVAL_ROWS,
        EVAL_SEQ, 0)).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    cfg32 = cfg.replace(dtype="float32")
    nL = cfg.num_layers
    forwards = 0
    _zero(kernels)
    res = {"rows": EVAL_ROWS, "seq": batch["tokens"].shape[1]}
    with torch.no_grad():
        ker = M.apply(cfg32, params, batch, use_flash=True)[0]
        plain = M.apply(cfg32, params, batch)[0]
        forwards += 1
        if not bool(torch.isfinite(ker).all() and torch.isfinite(plain).all()):
            raise AssertionError("model_train: non-finite logits")
        scale = float(plain.abs().max())
        d_logit = float((ker - plain).abs().max())
        del ker, plain
        ce = {}
        for name, c in (("f32", cfg32), ("bf16", cfg)):
            ce[f"{name}_kernel"] = float(M.loss_fn(c, params, batch,
                                                   use_flash=True)[1]["ce"])
            ce[f"{name}_plain"] = float(M.loss_fn(c, params, batch)[1]["ce"])
            forwards += 1
        d_ce = abs(ce["f32_kernel"] - ce["f32_plain"])
        if d_ce > CE_F32_REL * abs(ce["f32_plain"]) \
                or d_logit > LOGIT_F32_REL * scale:
            raise AssertionError(f"model_train: float32 kernel vs plain: CE "
                                 f"{ce}, logits differ by {d_logit} (max "
                                 f"{scale})")
        # bf16: every layer on identical inputs, the trunk walked plainly
        _, norm = L.make_norm(cfg)
        x = L.embed(cfg, params["embed"], batch["tokens"])
        S = x.shape[1]
        pos = torch.broadcast_to(torch.arange(S, dtype=torch.int32,
                                              device=x.device), x.shape[:2])
        layers = []
        for lp, is_global in _trunk_order(cfg, params["trunk"]):
            h = norm(lp["ln1"], x)
            ok_, k1, v1 = L.attention_fwd(cfg, lp["attn"], h, pos,
                                          is_global=is_global,
                                          use_flash=True)
            op_, k2, v2 = L.attention_fwd(cfg, lp["attn"], h, pos,
                                          is_global=is_global)
            err = float((ok_.float() - op_.float()).abs().max())
            top = float(op_.float().abs().max())
            layers.append({"global": is_global, "max_abs_err": err,
                           "max_abs_o": top})
            if err > LAYER_BF16_REL * top or not (torch.equal(k1, k2)
                                                  and torch.equal(v1, v2)):
                raise AssertionError(f"model_train: bf16 layer "
                                     f"{len(layers) - 1} (global "
                                     f"{is_global}): kernel vs plain "
                                     f"attention differ by {err} (max {top})")
            x = M.transformer.block_fwd(cfg, lp, x, pos, is_global=is_global)
        forwards += 1

        def loss(use_flash):
            return M.loss_fn(cfg, params, batch, use_flash=use_flash)[0]
        times = {k: cuda_ms(torch, lambda i, k=k: loss(k), iters=3,
                            warmup=1) for k in (True, False)}
        prof = _device_profile(torch, lambda: loss(True))
        forwards += 4 + 1
    launches = _counts(kernels)
    expect = dict.fromkeys(kernels, 0)
    expect["flash_attention"] = nL * forwards
    if launches != expect:
        raise AssertionError(f"model_train: kernel launches {launches} for "
                             f"{forwards} forwards of {nL} layers (expected "
                             f"{expect})")
    res.update({
        "max_abs_logit_f32": scale, "f32_logits_kernel_vs_plain": d_logit,
        "f32_logit_tolerance": f"{LOGIT_F32_REL} x max |logit|",
        "ce": ce, "f32_ce_kernel_vs_plain": d_ce,
        "f32_ce_tolerance": f"{CE_F32_REL} relative",
        "bf16_ce_kernel_minus_plain": ce["bf16_kernel"] - ce["bf16_plain"],
        "bf16_layers": layers,
        "bf16_layer_tolerance": f"{LAYER_BF16_REL} x max |o| of the layer",
        "forwards_through_kernel": forwards, "launches": launches,
        "loss_forward_ms_bf16_kernel": times[True],
        "loss_forward_ms_bf16_plain": times[False],
        "loss_forward_profile_bf16_kernel": prof})
    return res


def reference_train(torch, M, get_smoke_config, dev="cuda"):
    """The gemma3-1b smoke config at float32, 8 layers (2 super-blocks and
    2 remainder locals): ``loss_fn(use_flash=True)`` on the card (the
    kernel) equals the CPU's (the plain version) within CE_F32_REL, and
    two train steps (2 micro-batches, remat) on the card give the CPU's
    losses and gradient norms within 1e-4 relative."""
    from repro_torch.data import DataConfig, synthetic_tokens
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR
    cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32", num_layers=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = [torch.from_numpy(synthetic_tokens(DataConfig(), cfg.vocab_size,
                                              4, 64, s)) for s in range(2)]
    tcfg = TR.TrainConfig(optimizer=O.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=2), microbatches=2)
    res = {"train_arch": f"{TRAIN_ARCH} smoke, 8 layers, float32"}
    legs = {}
    for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
        p = _to(params, leg_dev)
        t = [x.to(leg_dev) for x in toks]
        with torch.no_grad():
            ce = float(M.loss_fn(cfg, p, {"tokens": t[0][:2, :-1],
                                          "targets": t[0][:2, 1:]},
                                 use_flash=True)[1]["ce"])
        state = {"params": p, "opt": O.init_opt_state(tcfg.optimizer, p)}
        step = TR.make_train_step(cfg, tcfg)
        hist = []
        for x in t:
            state, m = step(state, {"tokens": x[:, :-1], "targets": x[:, 1:]})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        legs[leg] = (ce, hist)
    (ce_cpu, h_cpu), (ce_card, h_card) = legs["cpu"], legs["card"]
    res.update({"train_loss_flash_cpu": ce_cpu,
                "train_loss_flash_card": ce_card,
                "train_steps_cpu": h_cpu, "train_steps_card": h_card})
    if abs(ce_card - ce_cpu) > CE_F32_REL * abs(ce_cpu) or any(
            abs(a - b) > 1e-4 * abs(b)
            for x, y in zip(h_card, h_cpu) for a, b in zip(x, y)):
        raise AssertionError(f"reference train: card {legs['card']} vs CPU "
                             f"{legs['cpu']}")
    return res


def _int8_gate(card: dict, cpu: dict) -> tuple:
    """(first tokens equal, longest common prefix, tokens) of two runs'
    greedy tokens by request: the JAX package's int8 gate reads them."""
    first = sum(card[u][0] == cpu[u][0] for u in cpu)
    lcp = total = 0
    for u in cpu:
        total += len(cpu[u])
        for a, b in zip(cpu[u], card[u]):
            if a != b:
                break
            lcp += 1
    return first, lcp, total


def _gemma_drive(torch, kernels, serve, M, eng, cfg, int8: bool, dev):
    """Serve GEMMA_TRAFFIC through ``eng``: ``paged_attention`` launches
    == global layers x decode waves, and on an int8 pool
    ``paged_extend_attention`` launches == global layers x extend waves
    (a float pool's extend waves read through the gather, as in JAX);
    the traffic must hold a prompt past the largest bucket and the
    window, which catches up through extend waves and wraps the rings.
    Then times and profiles one 4-slot decode wave."""
    n_global = cfg.pattern_blocks()[0]
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": n_global * eng.decode_waves,
        "paged_extend_attention": n_global * eng.extend_waves if int8 else 0,
        "quant_matmul": 0, "ssd_scan": 0},
        needs=("paged_attention",) + (("paged_extend_attention",)
                                      if int8 else ()),
        traffic=GEMMA_TRAFFIC)
    longest = max(fields["prompt_lengths"])
    W = min(cfg.local_window, eng.scfg.max_len)
    if longest <= max(eng.scfg.prefill_buckets) or longest <= W \
            or eng.extend_waves == 0 or not eng.extend_ok:
        raise AssertionError(f"serve_gemma: longest prompt {longest}, "
                             f"window {W}, {eng.extend_waves} extend waves")
    _, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)

    def wave():
        return M.decode_step_paged(cfg, eng.params, eng.cache, tok, pos, bt,
                                   True)
    fields.update(
        global_layers=n_global, local_layers=cfg.num_layers - n_global,
        window=W, catch_chunk=eng.K, longest_prompt_past_window=longest - W,
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave))
    return fields


def serve_gemma_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the sixth main path: gemma3-1b at full width and depth
    through ``launch.serve.build_engine`` on a bf16 pool; returns
    (engine, cfg, phase fields)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(GEMMA_ARCH, scale, GEMMA_SERVE, dev)
    init_s = clock() - t0
    fields = _gemma_drive(torch, kernels, serve, M, eng, cfg, False, dev)
    fields["init_s"] = init_s
    return eng, cfg, fields


def serve_gemma_int8_phase(torch, kernels, serve, M, eng0, cfg):
    """The same model (the first engine's weights) and traffic on an int8
    pool; the rings stay in the activation dtype."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **GEMMA_SERVE), device=eng0.device)
    fields = _gemma_drive(torch, kernels, serve, M, eng, cfg, True,
                          eng0.device)
    ring = eng.cache["super"]["local"]["k"].dtype
    if ring != eng0.cache["super"]["local"]["k"].dtype:
        raise AssertionError(f"serve_gemma_int8: rings in {ring}")
    return fields


def serve_gemma_wide_phase(torch, kernels, M, eng0, cfg):
    """A short drive of the first gemma engine's weights on an int8 pool
    with ``catch_chunk=64`` (GEMMA_WIDE_TRAFFIC: every prompt past the
    largest bucket catches up 64 tokens a slot a wave): with the hand
    kernels, ``paged_extend_attention`` launches == 4 global layers x
    extend waves, each call at S = 64 (the first version refused S >=
    22 at this shape); held against the same engine reading through the
    gather (``use_pallas_paged=False``) by the int8 gate."""
    from repro_torch.kernels import paged_extend_attention as pea
    from repro_torch.launch import serve
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    n_global = cfg.pattern_blocks()[0]
    widths = []
    kernel = pea.paged_extend_attention

    def recorded(q, *args, **kw):
        widths.append(int(q.shape[1]))
        return kernel(q, *args, **kw)
    tokens, res = {}, {}
    for leg, use_kernels in (("gather", False), ("kernels", True)):
        eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
            prefix_cache=False, use_pallas_paged=use_kernels,
            quant_kv="int8", **GEMMA_WIDE_SERVE), device=eng0.device)
        reqs = serve.make_requests(cfg, *GEMMA_WIDE_TRAFFIC, "priority")
        _zero(kernels)
        pea.paged_extend_attention = recorded
        try:
            raw = serve.run_drain(eng, reqs)
        finally:
            pea.paged_extend_attention = kernel
        launches = _counts(kernels)
        tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        res[leg] = {"steps": raw["decode_steps"],
                    "decode_waves": eng.decode_waves,
                    "extend_waves": eng.extend_waves, "catch_chunk": eng.K,
                    "tok_per_s": raw["tok_per_s"], "launches": launches}
    extend = n_global * eng.extend_waves
    if launches["paged_extend_attention"] != extend or extend == 0 \
            or set(widths) != {GEMMA_WIDE_SERVE["catch_chunk"]} \
            or len(widths) != extend \
            or launches["paged_attention"] != n_global * eng.decode_waves:
        raise AssertionError(f"serve_gemma_wide: launches {launches} for "
                             f"{eng.decode_waves} decode and "
                             f"{eng.extend_waves} extend waves, extend "
                             f"widths {sorted(set(widths))}")
    first, lcp, total = _int8_gate(tokens["kernels"], tokens["gather"])
    n = len(tokens["gather"])
    if len(tokens["kernels"]) != n or first != n \
            or lcp < INT8_LCP_SHARE * total:
        raise AssertionError(f"serve_gemma_wide: first tokens {first}/{n}, "
                             f"LCP {lcp}/{total}: kernels "
                             f"{tokens['kernels']} vs gather "
                             f"{tokens['gather']}")
    return {"legs": res, "extend_widths": sorted(set(widths)),
            "prompt_lengths": [len(r.prompt) for r in reqs],
            "int8_first_tokens_equal": f"{first}/{n}",
            "int8_lcp_share": lcp / total,
            "tokens_equal": tokens["kernels"] == tokens["gather"],
            "launches": launches}


def serve_hybrid_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the seventh main path: zamba2-7b at full width and depth
    behind the pool-free engine: each admission prefill scans its 68
    mamba blocks through ``ssd_scan`` and runs the shared block's 13
    applications through ``flash_attention``; no paged or quant kernel
    runs."""
    def per_prefill(cfg):
        n_attn = cfg.num_layers // cfg.hybrid_attn_period
        return {"ssd_scan": cfg.num_layers - n_attn, "flash_attention": n_attn}
    eng, cfg, fields = _serve_pool_free(
        torch, kernels, serve, M, HYBRID_ARCH, HYBRID_SERVE, HYBRID_TRAFFIC,
        per_prefill, scale, dev)
    per = per_prefill(cfg)
    fields.update(mamba_blocks=per["ssd_scan"],
                  attention_applications=per["flash_attention"],
                  ring=eng.cache["attn"]["k"].shape[2])
    return eng, cfg, fields


def model_hybrid_phase(torch, M, eng, cfg, dev="cuda"):
    """``hybrid.prefill`` of one 4-row bucket-1024 batch with ragged
    ``true_len`` through the kernels (``ssd_scan`` and
    ``flash_attention``) and through the plain path: at float32
    activations the logits must agree within F32_REL_TOL x max |logit|,
    every mamba state (conv and ssm) and every ring's K and V within
    F32_REL_TOL x their max, and the greedy next tokens must be equal;
    then one such prefill of each is timed at the serving bf16
    activations."""
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                           dtype=torch.int32).to(dev)
    true_len = torch.tensor([1000, 777, 513, 300], dtype=torch.int32,
                            device=dev)
    batch = {"tokens": tokens}

    def run(c, kernels):
        return M.prefill(c, eng.params, batch, HYBRID_SERVE["max_len"],
                         true_len=true_len, use_kernel=kernels,
                         use_flash=kernels)
    cfg32 = cfg.replace(dtype="float32")
    ker, ker_cache = run(cfg32, True)
    gat, gat_cache = run(cfg32, False)
    ker, gat = ker[:, 0].float(), gat[:, 0].float()
    if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
        raise AssertionError("model_hybrid: non-finite logits")
    scale = float(gat.abs().max())
    d_logit = float((ker - gat).abs().max())
    states = {}
    for part, leaves in (("mamba", ("conv", "ssm")), ("attn", ("k", "v"))):
        for leaf in leaves:
            want = gat_cache[part][leaf].float()
            states[f"{part}.{leaf}"] = (
                float((ker_cache[part][leaf].float() - want).abs().max()),
                float(want.abs().max()))
    if not torch.equal(ker_cache["attn"]["slots"], gat_cache["attn"]["slots"]):
        raise AssertionError("model_hybrid: ring slots differ")
    same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
    bad = {k: v for k, v in states.items() if v[0] > F32_REL_TOL * v[1]}
    if d_logit > F32_REL_TOL * scale or bad or same != 4:
        raise AssertionError(
            f"model_hybrid: kernel vs plain prefill: logits differ by "
            f"{d_logit} (max {scale}), states beyond tolerance {bad}, "
            f"greedy tokens agree {same}/4")
    del ker_cache, gat_cache
    times = {k: cuda_ms(torch, lambda i, k=k: run(cfg, k), iters=5, warmup=1)
             for k in (True, False)}
    return {"rows": 4, "bucket": 1024, "true_len": true_len.tolist(),
            "max_abs_logit_f32": scale, "f32_kernel_vs_plain": d_logit,
            "f32_tolerance": f"{F32_REL_TOL} x max |logit| (and x max "
            "|value| of each state)",
            "f32_states_kernel_vs_plain_and_max": states,
            "greedy_agree_f32": f"{same}/4",
            "prefill_ms_bf16_kernels": times[True],
            "prefill_ms_bf16_plain": times[False],
            "prefill_profile_bf16_kernels": _device_profile(
                torch, lambda: run(cfg, True))}


def reference_hybrid(torch, serve_mod, get_smoke_config, kernels,
                     dev="cuda"):
    """The zamba2 smoke config (6 layers, window 16: prompts past 16
    wrap the rings): card (``ssd_scan`` and ``flash_attention``) tokens
    equal to the CPU's (plain versions)."""
    launches, longest = _reference_pool_free(
        torch, serve_mod, get_smoke_config, kernels, HYBRID_ARCH,
        ("ssd_scan", "flash_attention"), dev)
    return {"hybrid_arch": f"{HYBRID_ARCH} smoke, float32, window 16",
            "hybrid_tokens_equal": True, "hybrid_card_launches": launches,
            "hybrid_longest_prompt": longest}


def reference_gemma(torch, M, serve_mod, get_smoke_config, kernels,
                    dev="cuda"):
    """The gemma3-1b smoke config at float32 (window 16, 2 super-blocks
    of 2 local + 1 global layers): the engine on the card (hand kernels)
    and on the CPU (plain versions), prompts of 20-150 tokens (all past
    the window; those past the largest bucket catch up through extend
    waves).  On a float pool the greedy tokens must be equal; on an int8
    pool every first token equal and the longest common prefix at least
    INT8_LCP_SHARE of the tokens.  The card legs must have launched
    ``paged_attention`` and, on the int8 pool, ``paged_extend_attention``."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(GEMMA_ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    res = {"arch": f"{GEMMA_ARCH} smoke, float32", "requests": 6,
           "window": cfg.local_window}
    for pool in ("float32", "int8"):
        tokens = {}
        for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
            eng = EdgeServingEngine(cfg, _to(params, leg_dev), ServeConfig(
                max_slots=3, max_len=192, prefix_cache=False,
                use_pallas_paged=True, policy="priority",
                quant_kv="int8" if pool == "int8" else None),
                device=leg_dev)
            reqs = serve_mod.make_requests(cfg, 6, 20, 150, 8, "priority")
            _zero(kernels)
            serve_mod.run_drain(eng, reqs)
            tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        launches = _counts(kernels)
        res[f"{pool}_card_launches"] = launches
        res[f"{pool}_waves_decode_extend"] = [eng.decode_waves,
                                              eng.extend_waves]
        need = ["paged_attention"] + (["paged_extend_attention"]
                                      if pool == "int8" else [])
        if any(launches[n] == 0 for n in need) or eng.extend_waves == 0:
            raise AssertionError(f"reference_gemma {pool}: launches "
                                 f"{launches}, {eng.extend_waves} extend "
                                 "waves")
        cpu, card = tokens["cpu"], tokens["card"]
        if len(card) != 6 or set(card) != set(cpu):
            raise AssertionError(f"reference_gemma {pool}: requests "
                                 f"{sorted(card)} on the card, "
                                 f"{sorted(cpu)} on the CPU")
        if pool == "float32":
            if card != cpu:
                raise AssertionError(f"reference_gemma: card tokens {card} "
                                     f"!= CPU tokens {cpu}")
            res["float32_tokens_equal"] = True
            continue
        first, lcp, total = _int8_gate(card, cpu)
        res.update({"int8_first_tokens_equal": f"{first}/{len(cpu)}",
                    "int8_lcp_share": lcp / total,
                    "int8_tokens_equal": card == cpu})
        if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
            raise AssertionError(f"reference_gemma int8: first tokens "
                                 f"{first}/{len(cpu)}, LCP {lcp}/{total}: "
                                 f"card {card} vs CPU {cpu}")
    return res


def reference_phase(torch, M, serve_mod, get_smoke_config, qm, dev="cuda"):
    """Small input: the engine on the card (hand kernels) and on the CPU
    (plain versions) at float32.  On a float pool the greedy tokens must
    be equal; on an int8 pool, where one int8 level can move with the
    summation order, every first token must be equal and the longest
    common prefix at least INT8_LCP_SHARE of the tokens (the JAX
    package's int8 gate).  The speculative engine on the card, with an
    int8 draft of the first layer (of 2), is held the same way against
    the CPU's vanilla engine: equal tokens on the float pool (the
    verify model alone decides them), the int8 gate on the int8 pool;
    it must have run speculative rounds through ``quant_matmul``."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dcfg, dparams = make_draft(cfg, params, 1)
    res = {"arch": f"{ARCH} smoke, float32", "requests": 6,
           "spec_draft": f"first layer of {cfg.num_layers}, int8"}
    for pool in ("float32", "int8"):
        base = dict(max_slots=3, max_len=192, prefix_cache=False,
                    use_pallas_paged=True, policy="priority",
                    quant_kv="int8" if pool == "int8" else None)
        tokens, waves = {}, {}
        for leg, leg_dev in (("cpu", "cpu"), ("card", dev), ("spec", dev)):
            spec = leg == "spec"
            eng = EdgeServingEngine(
                cfg, _to(params, leg_dev),
                ServeConfig(**base, **(SPEC if spec else {})),
                device=leg_dev,
                draft=(dcfg, _to(dparams, leg_dev)) if spec else None)
            reqs = serve_mod.make_requests(cfg, 6, 4, 150, 8, "priority")
            qm.launches = 0
            serve_mod.run_drain(eng, reqs)
            tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
            waves[leg] = (eng.decode_waves, eng.extend_waves)
            if spec:
                st = eng.stats()
                res[f"{pool}_spec"] = {
                    "rounds": st["spec_rounds"],
                    "acceptance": st["spec_acceptance"],
                    "quant_matmul_launches": qm.launches}
                if st["spec_rounds"] < 1 or qm.launches == 0:
                    raise AssertionError(f"reference {pool} spec: {st}, "
                                         f"{qm.launches} quant_matmul "
                                         "launches")
        cpu = tokens["cpu"]
        for leg in ("card", "spec"):
            card = tokens[leg]
            name = pool if leg == "card" else f"{pool}_spec"
            if len(card) != 6 or set(card) != set(cpu):
                raise AssertionError(f"reference {name}: requests "
                                     f"{sorted(card)} on the card, "
                                     f"{sorted(cpu)} on the CPU")
            if pool == "float32":
                if card != cpu:
                    raise AssertionError(f"reference {name}: card tokens "
                                         f"{card} != CPU tokens {cpu}")
                res[f"{name}_tokens_equal"] = True
                continue
            first, lcp, total = _int8_gate(card, cpu)
            res.update({f"{name}_first_tokens_equal": f"{first}/{len(cpu)}",
                        f"{name}_lcp_share": lcp / total,
                        f"{name}_tokens_equal": card == cpu,
                        f"{name}_waves_decode_extend": list(waves[leg])})
            if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
                raise AssertionError(f"reference {name}: first tokens "
                                     f"{first}/{len(cpu)}, LCP {lcp}/{total}"
                                     f": card {card} vs CPU {cpu}")
    return res


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` whose leaves are new tensor objects
    (``detach``), so flags set on them leave ``tree`` as it was."""
    return {k: (_to(v, dev) if isinstance(v, dict) else v.detach().to(dev))
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_extend_attention as pea
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.models import ssm

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
    rows, details = {}, {}
    kernels = {"paged_attention": pa, "paged_extend_attention": pea,
               "flash_attention": fa, "quant_matmul": qm, "ssd_scan": ssd}
    checks = {"paged_attention": check_paged_attention,
              "paged_extend_attention": check_paged_extend_attention,
              "flash_attention": check_flash_attention,
              "quant_matmul": check_quant_matmul,
              "ssd_scan": lambda torch, k, r, t: check_ssd_scan(torch, k, r,
                                                                ssm, t)}
    for name, check in checks.items():
        rows[name], details[name] = check(torch, kernels[name], ref, cuda_ms)
    emit("kernels", seconds=clock() - t0,
         **{n: dict(rows[n], **details[n]) for n in rows})

    t0 = clock()
    eng, cfg, fields = serve_phase(torch, kernels, serve)
    launches = dict(fields["launches"])
    emit("serve", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_phase(torch, M, eng, cfg)
    emit("model", seconds=clock() - t0, **fields)

    t0 = clock()
    eng8, fields = serve_int8_phase(torch, kernels, serve, eng, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    del eng
    _release(torch)
    emit("serve_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_int8_phase(torch, M, eng8, cfg)
    emit("model_int8", seconds=clock() - t0, **fields)
    params = eng8.params
    del eng8
    _release(torch)

    t0 = clock()
    fields = serve_spec_phase(torch, kernels, serve, M, params, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    del params
    _release(torch)
    emit("serve_spec", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_ssm, cfg_ssm, fields = serve_ssm_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_ssm", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_ssm_phase(torch, M, eng_ssm, cfg_ssm)
    del eng_ssm
    _release(torch)
    emit("model_ssm", seconds=clock() - t0, **fields)

    t0 = clock()
    cfg_tr, state, fields = train_phase(torch, kernels, train, M)
    emit("train", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_train_phase(torch, kernels, M, cfg_tr, state["params"])
    for name, n in fields["launches"].items():
        launches[name] += n
    del state
    _release(torch)
    emit("model_train", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_g, cfg_g, fields = serve_gemma_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_gemma", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_gemma_int8_phase(torch, kernels, serve, M, eng_g, cfg_g)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_gemma_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_gemma_wide_phase(torch, kernels, M, eng_g, cfg_g)
    for name, n in fields["launches"].items():
        launches[name] += n
    del eng_g
    _release(torch)
    emit("serve_gemma_wide", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_h, cfg_h, fields = serve_hybrid_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_hybrid", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_hybrid_phase(torch, M, eng_h, cfg_h)
    del eng_h
    _release(torch)
    emit("model_hybrid", seconds=clock() - t0, **fields)

    t0 = clock()
    emit("reference_gemma", **reference_gemma(
        torch, M, serve, get_smoke_config, kernels), seconds=clock() - t0)

    t0 = clock()
    fields = reference_phase(torch, M, serve, get_smoke_config, qm)
    fields.update(reference_ssm(torch, serve, get_smoke_config, kernels))
    fields.update(reference_hybrid(torch, serve, get_smoke_config, kernels))
    fields.update(reference_train(torch, M, get_smoke_config))
    emit("reference", seconds=clock() - t0, **fields)

    emit("done", seconds=clock() - t_start)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, row in rows.items():
        # main-path launches: the serve phases (the gemma int8 drive at
        # catch chunk 64 included) and model_train, each counted from 0
        row["launches"] = launches[name]
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
