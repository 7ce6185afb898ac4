"""Step-driven multi-tenant serving engine over a paged KV cache
(PyTorch port of ``repro.serving.engine``).

The unit of work is one ``step()`` — admit, plan, one wave, retire — and
requests arrive (``submit``) and leave (``cancel``) between any two
steps; ``run_until_drained`` loops ``drain_step``.  The contract is the
JAX engine's, and on the same weights the greedy tokens are the same:

* ADMIT — ``core.scheduler.admission_rank`` orders the queue (fifo /
  priority / edf); admission is capacity-aware (a request is taken only
  when the pool can cover its first span plus one decode write).
  Prompts are right-padded to the smallest prefill bucket and prefilled
  in one batch per bucket with ``true_len``, writing K/V straight into
  the pages (``model.prefill_paged``); prompts past the largest bucket
  catch up teacher-forced through extend waves.  With
  ``ServeConfig.chunked_prefill`` admission is bookkeeping only and the
  whole prompt enters as wave spans (``_admit_wave``).
* PLAN — each active slot gets ``(mode, width)``: ``spec`` (a
  draft-backed verify of up to ``spec_gamma`` tokens), ``catch`` (up to
  ``max(spec_gamma, catch_chunk)`` prompt tokens) or ``plain`` (one
  decode token), budgeted by ``wave_tokens`` through
  ``core.scheduler.plan_wave``.  ``engine.last_plan`` keeps the plan.
* WAVE — one call for every active slot: ``model.extend_paged`` while
  any slot speculates or catches up, else ``model.decode_step_paged``,
  which with ``use_pallas_paged`` reads the pages through the
  hand-written ``paged_attention`` kernel.  With ``quant_kv="int8"`` the
  pool holds int8 pages with per-row float32 scales, and
  ``use_pallas_paged`` also sends the extend waves' page read through
  the hand-written ``paged_extend_attention`` kernel.  The eager calls
  update the page pool in place (the JAX engine donates its cache to a
  jitted call instead).
* RETIRE — committed tokens land in ``Request.generated``; EOS, budget,
  the ``max_len`` wall or cancellation free the slot and its pages.

Speculative decoding (``spec_decode``, ``serving.spec_decode``): on a
``model.spec_decodable`` config every wave is an extend wave.  The draft
(an explicit ``draft=(cfg, params)``, the early-exit self-draft, or a
registry smoke config drawn from a ``torch.Generator`` seeded with
``ServeConfig.seed``) proposes up to ``spec_gamma - 1`` tokens per slot
from its own dense cache; one ``extend_paged`` call verifies them; greedy
or rejection-sampling acceptance commits ``n_accepted + 1`` tokens and
``_truncate_slot`` returns the rejected tail's pages.  Greedy output is
the vanilla engine's token for token.  ``quant_draft`` quantizes the
draft's projection weights to int8 (``layers.quantize_matmul_params``),
which then run through the hand-written ``quant_matmul`` kernel on the
card.

Paged KV: every slot holds an ordered list of pool pages
(``kv_pool.KVBlockPool``), mirrored into the ``(max_slots, max_len //
kv_block_size)`` int32 block tables (-1 = unallocated) that every wave
sends to the device.  Before a wave each slot's table covers its write
span (``_ensure_blocks``); on pool exhaustion the slot is preempted back
to the queue with its pages detached (preempt-or-queue), and resumes
with no re-prefill.  When nothing can run and detached requests hold
every page, the worst-ranked one is reclaimed (its context is replayed
as a prompt), so ``step()`` loops never wedge.  Zero pages leak:
``drain_step`` re-checks ``pool.assert_consistent()`` after every step.

Sampling is per request (``Request.temperature`` / ``top_k`` over the
``ServeConfig`` defaults): the decode wave samples on the device from
the engine's ``torch.Generator`` (Gumbel-max), first tokens and
catch-up tokens on the host from the engine's numpy generator, as in
the JAX engine.  Greedy tokens match the JAX engine; sampled tokens
match it in distribution only (the generators differ).

Pool-free path: a family whose paged cache has no pool leaf (ssm: O(1)
recurrent state per row; hybrid: that and the shared attention block's
rings of ``min(max_len, local_window)`` entries per row) runs with
``self.paged = False``, as in JAX: no
``KVBlockPool`` and no block tables; the cache is ``model.init_cache``
with one row per slot (batch axes from ``cache_batch_axes``); admission
prefills write each row's state at its slot (``prefill_paged`` without
tables); every wave is a ``model.decode_step`` wave, and prompts past
the largest bucket catch up one teacher-forced token a wave; preemption
copies the slot's rows out (``extract_slot``) and resumption copies them
back (``insert_slot``).  ``quant_kv="int8"`` is disarmed there (no pages
to quantize) and ``spec_decode`` is quietly ignored (the recurrence
cannot roll back).  One choice is the port's own: on a pool-free config
``use_pallas_paged=True`` sends the admission prefill's scan through the
hand-written ``ssd_scan`` kernel (``prefill_paged(use_kernel=True)``)
and, on the hybrid, the shared block's causal prefill attention through
the hand-written ``flash_attention`` kernel (``use_flash=True``).  The
JAX engine sets neither ``use_kernel`` nor ``use_flash``, and the flag
is its only "serve through the hand kernels" switch; with it off the
port runs the plain chunked scan and the plain masked softmax, which is
what the JAX engine runs.

Not ported yet — each raises ``NotImplementedError`` when its
``ServeConfig`` field is set: the radix prefix cache and its
persistence, tracing, and the dense ``paged=False`` twin (an explicit
``paged=False`` on a family that needs pages raises at construction).
``prefix_cache`` defaults to True as in the JAX config, so callers pass
``prefix_cache=False``.  Without the prefix cache no page is ever
shared, so the JAX engine's copy-on-write backstop (``_cow_guard``) has
nothing to do and is left out.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import admission_rank, plan_wave
from repro_torch.devices import DeviceLike, resolve_device, tensor_device
from repro_torch.models import model as M
from repro_torch.serving.kv_pool import KVBlockPool, PoolExhausted, \
    blocks_for_tokens, page_bytes
from repro_torch.serving.spec_decode import (SpecDecoder, accept_greedy,
                                             accept_proposals,
                                             make_self_draft,
                                             sample_from_logits,
                                             validate_spec)
from repro_torch.serving.telemetry import MetricsRegistry


# ---------------------------------------------------------------------------
# per-slot rows of a dense cache (the draft's)
# ---------------------------------------------------------------------------

# batch-axis discovery: the cache is built on the meta device at two
# batch sizes and the batch axis is the one whose extent changed
_PROBE_A, _PROBE_B = 3, 5


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _diff_axis(a, b) -> int:
    """Axis where the two probe shapes differ; -1 when none does (a
    batchless shared-pool leaf)."""
    diffs = [i for i, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]
    if not diffs:
        return -1
    if len(diffs) > 1:
        raise ValueError(
            f"ambiguous batch axis: shapes {tuple(a.shape)} / "
            f"{tuple(b.shape)} differ on {diffs}")
    return diffs[0]


def cache_batch_axes(cfg: ModelConfig, max_len: int):
    """Nested dict of ints: which axis of each dense cache leaf is the
    batch axis, found by building the cache (shapes only) at two batch
    sizes."""
    s1 = M.init_cache(cfg, _PROBE_A, max_len, device="meta")
    s2 = M.init_cache(cfg, _PROBE_B, max_len, device="meta")
    return _tree_map(_diff_axis, s1, s2)


def paged_cache_axes(cfg: ModelConfig, max_len: int, num_blocks: int,
                     block_size: int, kv_dtype=None):
    """Like ``cache_batch_axes`` for the paged cache: shared page-pool
    leaves have no batch axis and map to -1.  A cache with no -1 leaf
    has no pool (the ssm family)."""
    s1 = M.init_paged_cache(cfg, _PROBE_A, max_len, num_blocks, block_size,
                            kv_dtype=kv_dtype, device="meta")
    s2 = M.init_paged_cache(cfg, _PROBE_B, max_len, num_blocks, block_size,
                            kv_dtype=kv_dtype, device="meta")
    return _tree_map(_diff_axis, s1, s2)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def insert_slot(cache, one, slot: int, axes):
    """Copy a batch=1 cache ``one`` into row ``slot`` of the batched
    ``cache`` IN PLACE (pool leaves, axis -1, are left untouched) and
    return ``cache``."""
    def put(full, single, ax):
        if ax >= 0:
            full.narrow(ax, slot, 1).copy_(single)
    _tree_map(put, cache, one, axes)
    return cache


def extract_slot(cache, slot: int, axes):
    """A copy of row ``slot`` of ``cache`` as a batch=1 cache (the
    inverse of ``insert_slot``); pool leaves yield an empty
    placeholder."""
    return _tree_map(
        lambda full, ax: (full.new_zeros((0,)) if ax < 0
                          else full.narrow(ax, slot, 1).clone()),
        cache, axes)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    priority: int = 0                   # higher = more urgent (QoE)
    deadline: Optional[float] = None    # for the "edf" admission policy
    temperature: Optional[float] = None  # None -> ServeConfig.temperature
    top_k: Optional[int] = None          # None -> ServeConfig.top_k
    extras: dict = field(default_factory=dict)  # image/audio embeds
    # filled by the engine:
    generated: list = field(default_factory=list)
    done: bool = False
    cancelled: bool = False             # set by engine.cancel(uid)
    arrival: Optional[float] = None     # submission stamp (engine-set)
    saved_state: Optional[dict] = None  # KV snapshot from preemption


# field -> (the value that means "off", ROADMAP item that ports it)
_NOT_PORTED = {
    "prefix_cache": (False, "A.5 (prefix cache)"),
    "prefix_persist_path": (None, "A.5 (prefix-store persistence)"),
    "min_match_tokens": (1, "A.5 (prefix cache)"),
    "trace": (False, "A.8 (tracer)"),
    "trace_clock": (None, "A.8 (tracer)"),
}


@dataclass(frozen=True)
class ServeConfig:
    """The JAX ``ServeConfig``, field for field and default for default
    (see ``repro.serving.engine.ServeConfig`` for each field).  A field
    whose feature is not ported yet raises ``NotImplementedError`` here
    when it is set to anything but "off"."""
    max_slots: int = 4
    max_len: int = 256
    temperature: float = 0.0            # 0 => greedy
    top_k: int = 0                      # 0 disables top-k filtering
    eos_id: int = -1                    # -1 disables EOS stopping
    prefill_buckets: tuple = (16, 32, 64, 128)
    policy: str = "priority"            # fifo | priority | edf (QoE)
    seed: int = 0
    paged: bool = True
    kv_block_size: int = 16
    kv_pool_blocks: Optional[int] = None  # None -> max_slots*max_len/bs
    prefix_cache: bool = True
    prefix_persist_path: Optional[str] = None
    # read paged decode KV through the hand-written paged_attention
    # kernel (CUDA tensors; its plain version on CPU tensors) instead of
    # the gather, and int8 extend waves through paged_extend_attention
    use_pallas_paged: bool = False
    spec_decode: bool = False
    draft_arch: Optional[str] = None
    # also the chunk width of multi-token catch-up prefill
    spec_gamma: int = 4
    chunked_prefill: bool = False
    catch_chunk: Optional[int] = None
    wave_tokens: Optional[int] = None
    min_match_tokens: int = 1
    quant_kv: Optional[str] = None
    quant_draft: bool = False
    trace: bool = False
    trace_clock: Optional[Callable[[], float]] = None

    def __post_init__(self):
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r}: not ported "
                    f"to repro_torch yet (ROADMAP {item}); leave it at "
                    f"{off!r}")


class EdgeServingEngine:
    """Continuous-batching decode engine for one model on one device
    (``device`` default ``cuda``; ``params`` must lie there).

    ``draft``: optional ``(draft_cfg, draft_params)`` for speculative
    decoding, on the same device; it overrides
    ``ServeConfig.draft_arch``.

    ``paged`` is False for a family whose cache has no page-pool leaf
    (the pool-free path of the module docstring); an explicit
    ``ServeConfig(paged=False)`` on a family that needs pages raises
    ``NotImplementedError`` (the dense twin, ROADMAP A.4)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 device: DeviceLike = None, draft=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        pdev = tensor_device(params)
        if pdev is not None and (pdev.type != dev.type or (
                dev.type == "cuda" and pdev.index != dev.index)):
            raise ValueError(f"params lie on {pdev}, the engine runs on {dev}")
        self.device = dev
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        B, T = scfg.max_slots, scfg.max_len
        bs = scfg.kv_block_size
        if scfg.quant_kv not in (None, "int8"):
            raise ValueError(
                f"quant_kv must be None or 'int8', got {scfg.quant_kv!r}")
        if scfg.paged:
            # validated and shrunk as in JAX, for a pool-free family too
            if bs < 1:
                raise ValueError(f"kv_block_size must be >= 1, got {bs}")
            # the logical page view must tile max_len exactly; shrink the
            # block size until it divides rather than reject the config
            while T % bs:
                bs //= 2
        # one probe on the meta device: a family whose paged cache has
        # no page-pool leaf (ssm) runs pool-free outright
        axes = paged_cache_axes(cfg, T, 1, 1, kv_dtype=scfg.quant_kv)
        self.paged = any(a < 0 for a in _leaves(axes))
        if self.paged and not scfg.paged:
            raise NotImplementedError(
                f"ServeConfig.paged=False for {cfg.name}: the dense twin "
                "of a paged family is not ported to repro_torch yet "
                "(ROADMAP A.4 (dense paged=False twin)); leave it at True")
        if self.paged:
            self.n_blk = T // bs
            if scfg.kv_pool_blocks:
                # a user-set pool is a TOKEN budget
                n_pool = scfg.kv_pool_blocks * scfg.kv_block_size // bs
            else:
                n_pool = B * self.n_blk
        self.block_size = bs              # effective page size
        # int8 pages with per-row float32 scales: the pool's capacity
        # lever; a pool-free family has no pages to quantize
        self.quant = bool(self.paged and scfg.quant_kv == "int8")
        if self.paged:
            self.axes = axes
            self.pool = KVBlockPool(n_pool, bs)
            self.cache = M.init_paged_cache(cfg, B, T, n_pool, bs,
                                            kv_dtype=scfg.quant_kv,
                                            device=dev)
            self.block_tables = np.full((B, self.n_blk), -1, np.int32)
            self.slot_blocks: list[list[int]] = [[] for _ in range(B)]
        else:
            self.pool = None
            self.cache = M.init_cache(cfg, B, T, device=dev)
            self.axes = cache_batch_axes(cfg, T)
        # static extend-wave width: the catch-up chunk; a local ring
        # extends with pre-write semantics only while the chunk fits the
        # window, as in JAX
        self.K = max(scfg.spec_gamma, scfg.catch_chunk or 0)
        self.extend_ok = bool(M.extendable(cfg) and self.K >= 2
                              and (cfg.pattern_period <= 1
                                   or self.K <= min(cfg.local_window, T)))
        self.chunked = bool(scfg.chunked_prefill)
        self.spec = self._make_spec(draft)
        self.tokens = np.zeros((B, 1), np.int32)
        self.pos = np.zeros((B,), np.int32)
        self.temps = np.zeros((B,), np.float32)
        self.topks = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.slot_req: list[Optional[Request]] = [None] * B
        self.pending: list[Optional[np.ndarray]] = [None] * B
        self.queue: list[Request] = []
        self._gen = torch.Generator(device=dev).manual_seed(scfg.seed)
        self._rng = np.random.default_rng(scfg.seed)   # host sampling
        self._arrival = itertools.count()
        self.steps = 0
        self.decode_waves = 0       # waves through decode_step_paged
        self.extend_waves = 0       # waves through extend_paged
        self.completed: list[Request] = []
        self.cancelled: list[Request] = []
        self.last_plan: dict[int, tuple] = {}
        self.mixed_waves = 0
        self.wave_admitted = 0
        self.cancels = 0
        self.peak_active = 0
        self.peak_pool_used = 0
        self.exhaust_preempts = 0
        self.reclaims = 0
        # speculative decoding: rounds = (slot, wave) drafting
        # participations; emitted includes each round's correction/bonus
        self.spec_steps = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.metrics = MetricsRegistry()
        self._legacy_stats = self._register_metrics()

    def _make_spec(self, draft) -> Optional[SpecDecoder]:
        """The draft runtime, or None.  Speculation engages only on a
        ``model.spec_decodable`` config (a quiet vanilla fallback
        otherwise, as in JAX); an incompatible draft or gamma, and
        ``quant_draft`` without a separate draft, are errors."""
        scfg, cfg, dev = self.scfg, self.cfg, self.device
        if not (scfg.spec_decode and M.spec_decodable(cfg)):
            if scfg.quant_draft and not scfg.spec_decode:
                raise ValueError("quant_draft without spec_decode: there "
                                 "is no draft model to quantize")
            return None
        if draft is not None:
            dcfg, dparams = draft
            ddev = tensor_device(dparams)
            if ddev is not None and ddev.type != dev.type:
                raise ValueError(f"draft params lie on {ddev}, the engine "
                                 f"runs on {dev}")
        elif scfg.draft_arch in (None, "self"):
            if scfg.quant_draft:
                # the self-draft trunk IS the verify trunk (shared by
                # reference): quantizing it would make a private copy
                raise ValueError(
                    "quant_draft requires a separate draft model "
                    "(draft_arch or an explicit draft); the early-exit "
                    "self-draft shares the verify trunk by reference")
            dcfg, dparams = make_self_draft(cfg, self.params)
        else:
            from repro_torch.configs import get_smoke_config
            dcfg = get_smoke_config(scfg.draft_arch)
            gen = torch.Generator(device=dev).manual_seed(scfg.seed)
            dparams = M.init_params(dcfg, gen, dev)
        problems = validate_spec(cfg, dcfg, scfg.spec_gamma, scfg.max_len)
        if problems:
            raise ValueError("spec_decode misconfigured: "
                             + "; ".join(problems))
        if scfg.quant_draft:
            from repro_torch.models.layers import quantize_matmul_params
            dparams = quantize_matmul_params(dparams)
        return SpecDecoder(dcfg, dparams, scfg.max_slots, scfg.max_len,
                           device=dev)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.extras:
            raise NotImplementedError(
                "requests with extras (VLM images, enc-dec audio) are not "
                "ported to repro_torch yet (ROADMAP A.9)")
        limit = self.scfg.max_len - 1
        if req.saved_state is None:
            if len(req.prompt) > limit:
                raise ValueError(
                    f"prompt length {len(req.prompt)} exceeds max_len "
                    f"budget {limit} (max_len={self.scfg.max_len})")
            worst = len(req.prompt) + req.max_new_tokens
        else:
            st = req.saved_state
            pend = st.get("pending")
            n_pend = 0 if pend is None else int(np.size(pend))
            if len(req.generated) >= req.max_new_tokens:
                raise ValueError(
                    f"resumed request {req.uid} already generated "
                    f"{len(req.generated)}/{req.max_new_tokens} tokens — "
                    "nothing left to decode")
            if int(st["pos"]) + n_pend >= self.scfg.max_len - 1:
                raise ValueError(
                    f"resumed request {req.uid} cannot make progress: "
                    f"pos {int(st['pos'])} + pending {n_pend} >= "
                    f"max_len-1 ({self.scfg.max_len - 1})")
            worst = (int(st["pos"]) + n_pend + 1
                     + req.max_new_tokens - len(req.generated))
        if self.paged:
            need = blocks_for_tokens(min(worst, self.scfg.max_len),
                                     self.block_size)
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"request {req.uid} may need {need} KV blocks but the "
                    f"pool holds only {self.pool.num_blocks} "
                    f"(kv_pool_blocks); it could never finish")
        if req.arrival is None:
            req.arrival = float(next(self._arrival))
        self.queue.append(req)

    def _rank(self, req: Request):
        return admission_rank(self.scfg.policy, priority=req.priority,
                              arrival=req.arrival, deadline=req.deadline,
                              uid=req.uid)

    def _bucket(self, n: int) -> int:
        for b in self.scfg.prefill_buckets:
            if n <= b:
                return b
        return self.scfg.prefill_buckets[-1]

    def _sample_first(self, req: Request, logits: np.ndarray) -> int:
        """First generated token, from the admission logits (host-side,
        engine rng — deterministic for a fixed ServeConfig.seed)."""
        temp = (self.scfg.temperature if req.temperature is None
                else req.temperature)
        top_k = self.scfg.top_k if req.top_k is None else req.top_k
        return sample_from_logits(logits, temp, top_k, self._rng)

    def _first_span(self, suffix_len: int) -> int:
        """Tokens a request's FIRST admission step covers: the bucketed
        prefill normally; under chunked_prefill the first wave span."""
        if self.chunked:
            return min(suffix_len, self.K if self.extend_ok else 1)
        return min(suffix_len, self.scfg.prefill_buckets[-1])

    def _blocks_needed(self, req: Request) -> int:
        """New pool blocks this request needs to be admitted NOW: the
        first span's pages + one covering the next write (resumed
        requests already hold pages for [0, pos)); 0 without a pool."""
        if not self.paged:
            return 0
        bs = self.block_size
        if req.saved_state is not None:
            held = len(req.saved_state.get("blocks", ()))
            return max(0, blocks_for_tokens(
                int(req.saved_state["pos"]) + 1, bs) - held)
        return blocks_for_tokens(self._first_span(len(req.prompt)) + 1, bs)

    def _set_table(self, slot: int, blocks: list[int]) -> None:
        self.slot_blocks[slot] = blocks
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :len(blocks)] = blocks

    def _place(self, req: Request, slot: int) -> None:
        """Common slot bookkeeping after admission."""
        self.temps[slot] = (self.scfg.temperature if req.temperature is None
                            else req.temperature)
        self.topks[slot] = self.scfg.top_k if req.top_k is None else req.top_k
        self.active[slot] = True
        self.slot_req[slot] = req

    def _admit_resumed(self, req: Request, slot: int) -> None:
        need = self._blocks_needed(req)   # same formula the scan reserved
        st = req.saved_state
        req.saved_state = None
        if self.paged:
            blocks = list(st.get("blocks", ()))
            if need:  # feasibility pre-checked by the admission scan
                blocks += self.pool.alloc(need)
            self._set_table(slot, blocks)
        insert_slot(self.cache, st["cache"], slot, self.axes)
        if self.spec is not None:
            self.spec.insert(slot, st.get("draft"))
        self.pos[slot] = st["pos"]
        self.tokens[slot, 0] = st["last_tok"]
        self.pending[slot] = st["pending"]
        self._place(req, slot)

    def _admit_wave(self, req: Request, slot: int) -> None:
        """Chunked-prefill admission: NO prefill call — the prompt
        becomes the slot's pending span, consumed through the same
        extend/decode waves every other slot rides; the first wave's
        ``_ensure_blocks`` allocates its pages."""
        if self.paged:
            self._set_table(slot, [])
        prompt = np.asarray(req.prompt, np.int32)
        if self.spec is not None:
            # the draft prefills the full prompt (it never chunks), so
            # the slot is draft-complete once its prompt is consumed
            self.spec.admit_group([req], [slot])
        self.pos[slot] = 0
        self.tokens[slot, 0] = int(prompt[0])
        self.pending[slot] = prompt[1:]
        self._place(req, slot)
        self.wave_admitted += 1

    def _admit_batch(self) -> None:
        """Admit queued requests into free slots in rank order, batching
        prefill per bucket — one call per bucket group.  Capacity-aware:
        a request is taken only if the pool can cover its first span +
        first decode write; requests that don't fit now wait."""
        if not self.queue:
            return
        free = [s for s in range(self.scfg.max_slots) if not self.active[s]]
        if not free:
            return
        self.queue.sort(key=self._rank)
        avail = self.pool.num_free if self.paged else 0
        taken, kept = [], []
        for req in self.queue:
            if not free:
                kept.append(req)
                continue
            need = self._blocks_needed(req)
            if self.paged and need > avail:
                kept.append(req)
                continue
            avail -= need
            taken.append((req, free.pop(0)))
        self.queue = kept

        fresh: dict[int, list] = {}   # bucket -> [(req, slot)]
        for req, slot in taken:
            if req.saved_state is not None:
                self._admit_resumed(req, slot)
            elif self.chunked:
                self._admit_wave(req, slot)
            else:
                n1 = self._first_span(len(req.prompt))
                fresh.setdefault(self._bucket(n1), []).append((req, slot))
        for bucket, group in fresh.items():
            self._admit_group(bucket, group)

    def _admit_group(self, bucket: int, group) -> None:
        """One fused admission call: batched bucketed prefill that writes
        prompt K/V straight into the slots' pages (or, pool-free, each
        row's state into its slot's cache rows)."""
        bs = self.block_size
        if self.paged:
            admitted = []
            for req, slot in group:
                try:
                    blocks = self.pool.alloc(self._blocks_needed(req))
                except PoolExhausted:
                    self.queue.append(req)
                    continue
                self._set_table(slot, blocks)
                admitted.append((req, slot))
            group = admitted
            if not group:
                return
        m = len(group)
        prompts = np.zeros((m, bucket), np.int32)
        true_len = np.zeros((m,), np.int32)
        n_wblk = blocks_for_tokens(bucket, bs) if self.paged else 0
        tables = np.full((m, n_wblk), -1, np.int32)
        for i, (req, slot) in enumerate(group):
            prompt = np.asarray(req.prompt, np.int32)
            n1 = min(len(prompt), bucket)
            # pad value is irrelevant (true_len masks it) — repeat last tok
            prompts[i] = prompt[n1 - 1]
            prompts[i, :n1] = prompt[:n1]
            true_len[i] = n1
            if self.paged:
                blk = self.slot_blocks[slot][:n_wblk]
                tables[i, :len(blk)] = blk
        dev = self.device
        if self.paged:
            kw = dict(write_tables=torch.from_numpy(tables).to(dev))
        else:
            # the port's choice: the hand-kernel switch also runs the
            # pool-free families' prefill scan through ssd_scan and the
            # hybrid's shared-block prefill attention through
            # flash_attention (the ssm family has no attention)
            kw = dict(use_kernel=self.scfg.use_pallas_paged,
                      use_flash=self.scfg.use_pallas_paged)
        logits, self.cache = M.prefill_paged(
            self.cfg, self.params, {"tokens": torch.from_numpy(prompts).to(dev)},
            self.scfg.max_len, self.cache,
            slots=torch.tensor([s for _, s in group], dtype=torch.int32,
                               device=dev),
            true_len=torch.from_numpy(true_len).to(dev), **kw)
        if self.spec is not None:
            # the draft prefills the FULL prompt (it never chunks), so
            # catch-up slots are draft-complete once their prompt is in
            self.spec.admit_group([r for r, _ in group],
                                  [s for _, s in group])
        logits_host = logits[:, -1].float().cpu().numpy()      # (m, V)
        for i, (req, slot) in enumerate(group):
            n1 = int(true_len[i])
            remainder = np.asarray(req.prompt, np.int32)[n1:]
            tok = None
            if not remainder.size:
                tok = self._sample_first(req, logits_host[i])
                req.generated.append(tok)
                hit_eos = (self.scfg.eos_id >= 0
                           and tok == self.scfg.eos_id)
                if len(req.generated) >= req.max_new_tokens or hit_eos:
                    # the admission token already completed the request
                    if self.paged:
                        self.pool.free(self.slot_blocks[slot])
                        self._set_table(slot, [])
                    req.done = True
                    self.completed.append(req)
                    continue
            self.pos[slot] = n1
            if remainder.size:
                # long prompt: catch up through extend waves
                self.pending[slot] = remainder[1:]
                self.tokens[slot, 0] = int(remainder[0])
            else:
                self.pending[slot] = None
                self.tokens[slot, 0] = tok
            self._place(req, slot)

    # ------------------------------------------------------------------
    # waves
    # ------------------------------------------------------------------
    def _device_tensors(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _decode_fn(self, tokens, pos, temps, topks, block_tables,
                   any_temp: bool, any_topk: bool):
        """One decode wave on the device: next token per slot (greedy
        argmax, or a Gumbel-max draw from the engine generator for slots
        with temperature > 0, after an optional top-k filter).  Without a
        pool (``block_tables`` None) the wave is ``model.decode_step``."""
        if block_tables is None:
            logits, self.cache = M.decode_step(self.cfg, self.params,
                                               self.cache, tokens, pos)
        else:
            logits, self.cache = M.decode_step_paged(
                self.cfg, self.params, self.cache, tokens, pos, block_tables,
                self.scfg.use_pallas_paged)
        logits = logits[:, -1, :].float()                      # (B, V)
        greedy = torch.argmax(logits, dim=-1)
        if not any_temp:
            return greedy.to(torch.int32)
        masked = logits
        if any_topk:
            V = logits.shape[-1]
            desc = torch.sort(logits, dim=-1, descending=True).values
            kth = torch.gather(
                desc, 1, torch.clamp(topks - 1, 0, V - 1)[:, None].long())
            masked = torch.where((topks > 0)[:, None] & (logits < kth),
                                 -torch.inf, logits)
        scaled = masked / torch.clamp(temps, min=1e-6)[:, None]
        u = torch.rand(scaled.shape, generator=self._gen,
                       device=scaled.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
        sampled = torch.argmax(scaled + gumbel, dim=-1)
        return torch.where(temps > 0, sampled, greedy).to(torch.int32)

    def _extend_fn(self, tokens, pos, valid, block_tables,
                   need_logits: bool = False):
        """Multi-token wave: score ``K`` tokens per slot in one call.
        Ships only the (B, K) argmax ids to the host unless some active
        slot samples at temperature > 0."""
        logits, self.cache = M.extend_paged(
            self.cfg, self.params, self.cache, tokens, pos, block_tables,
            valid, self.scfg.use_pallas_paged)
        logits = logits.float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return greedy, (logits if need_logits else None)

    def _ensure_blocks(self, spans: Optional[dict] = None) -> None:
        """Guarantee every active slot's table covers its write span
        ``[pos, pos + span)``.  Crossing block boundaries appends pages;
        if the pool is exhausted the slot is preempted back to the queue
        (pages detached) — preempt-or-queue.  Best-ranked slots get
        first pick of the remaining pages."""
        bs = self.block_size
        spans = spans or {}
        needy = []
        for s in range(self.scfg.max_slots):
            if not self.active[s]:
                continue
            target = blocks_for_tokens(
                int(self.pos[s]) + spans.get(s, 1), bs)
            if target > len(self.slot_blocks[s]):
                needy.append((s, target))
        needy.sort(key=lambda t: self._rank(self.slot_req[t[0]]))
        for s, target in needy:
            n = target - len(self.slot_blocks[s])
            try:
                blk = self.pool.alloc(n)
            except PoolExhausted:
                req = self.preempt(s)
                self.exhaust_preempts += 1
                self.queue.append(req)   # resumes when a page frees
                continue
            j0 = len(self.slot_blocks[s])
            self.slot_blocks[s].extend(blk)
            self.block_tables[s, j0:j0 + n] = blk

    def _has_pending(self) -> bool:
        return any(self.active[s] and self.pending[s] is not None
                   and self.pending[s].size
                   for s in range(self.scfg.max_slots))

    def _apply_budget(self, plan: dict) -> dict:
        """Wave-token budget: shrink catch-up widths so the wave's total
        fed tokens fit ``ServeConfig.wave_tokens``, best QoE rank first
        (``core.scheduler.plan_wave``; every slot keeps width >= 1)."""
        if self.scfg.wave_tokens is None or not plan:
            return plan
        entries = []
        for s, (mode, want) in plan.items():
            r = self.slot_req[s]
            entries.append({"id": s, "want": want, "priority": r.priority,
                            "arrival": r.arrival, "deadline": r.deadline,
                            "uid": r.uid})
        widths = plan_wave(self.scfg.policy, entries,
                           self.scfg.wave_tokens, metrics=self.metrics)
        out = {}
        for s, (mode, want) in plan.items():
            v = min(want, widths[s])
            if mode == "spec" and v < 2:
                # a 1-wide speculative round is just a decode
                mode, v = "plain", 1
            out[s] = (mode, v)
        return out

    def _record_plan(self, plan: dict) -> None:
        """Keep the committed plan (``last_plan``) and count waves where
        a prompt chunk interleaved with a decoding slot."""
        self.last_plan = dict(plan)
        modes = {m for m, _ in plan.values()}
        if "catch" in modes and len(modes) > 1:
            self.mixed_waves += 1

    def step(self) -> int:
        """ONE step of the serving core: admit, plan, one wave (extend
        while any slot speculates or catches up, decode otherwise),
        retire.  When
        nothing stepped, requests are queued and detached requests hold
        every page, the worst-ranked holder is reclaimed.  Returns the
        number of active slots stepped (0 = idle)."""
        self._admit_batch()
        if self.extend_ok and (self.spec is not None
                               or self._has_pending()):
            stepped = self._extend_step()
        else:
            stepped = self._decode_wave()
        if (stepped == 0 and self.paged and self.queue
                and not self.active.any()):
            # requests requeued by _ensure_blocks mid-step may need zero
            # new pages — give admission one more look before reclaiming
            self._admit_batch()
            if not self.active.any():
                self._reclaim()
        return stepped

    def _decode_wave(self) -> int:
        """The plain one-token wave (every active slot has width 1;
        slots still consuming a prompt on a non-extendable config
        teacher-force one pending token)."""
        if self.paged:
            self._ensure_blocks()
        self._record_plan({
            s: (("catch", 1) if (self.pending[s] is not None
                                 and self.pending[s].size) else
                ("plain", 1))
            for s in range(self.scfg.max_slots) if self.active[s]})
        n_active = int(self.active.sum())
        if n_active == 0:
            return 0
        self.peak_active = max(self.peak_active, n_active)
        if self.paged:
            self.peak_pool_used = max(self.peak_pool_used,
                                      self.pool.num_used)

        act = self.active
        tokens, pos, temps, topks = self._device_tensors(
            self.tokens, self.pos, self.temps, self.topks)
        tables = (self._device_tensors(self.block_tables)[0] if self.paged
                  else None)
        nxt = self._decode_fn(tokens, pos, temps, topks, tables,
                              any_temp=bool((self.temps[act] > 0).any()),
                              any_topk=bool((self.topks[act] > 0).any()))
        nxt_host = nxt.cpu().numpy()
        for slot in range(self.scfg.max_slots):
            if not self.active[slot]:
                continue
            self.pos[slot] += 1
            req = self.slot_req[slot]
            pend = self.pending[slot]
            out_of_room = int(self.pos[slot]) >= self.scfg.max_len - 1
            if pend is not None and pend.size:
                # still consuming the prompt: teacher-force the next
                # prompt token, discard the sampled one
                self.tokens[slot, 0] = int(pend[0])
                self.pending[slot] = pend[1:]
                if out_of_room:
                    self._finish(slot, req)
                continue
            self.pending[slot] = None
            tok = int(nxt_host[slot])
            self.tokens[slot, 0] = tok
            req.generated.append(tok)
            hit_eos = self.scfg.eos_id >= 0 and tok == self.scfg.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos
                    or out_of_room):
                self._finish(slot, req)
        self.steps += 1
        self.decode_waves += 1
        return n_active

    def _truncate_slot(self, slot: int) -> None:
        """KV rollback: free the slot's pages past its write frontier
        (block-boundary granular).  Rejected verify writes above ``pos``
        are already invisible (every context read masks strictly below
        the frontier), so rollback returns whole tail pages and keeps
        the partial one the next write lands in."""
        if not self.paged:
            return
        keep = blocks_for_tokens(int(self.pos[slot]) + 1, self.block_size)
        blocks = self.slot_blocks[slot]
        if len(blocks) > keep:
            self.pool.free(blocks[keep:])
            self._set_table(slot, blocks[:keep])

    def _retire(self, s: int, req: Request, tok: int) -> None:
        """Commit one sampled token to slot ``s`` (already advanced);
        finish on budget, EOS or the ``max_len`` wall."""
        self.tokens[s, 0] = tok
        req.generated.append(tok)
        eos = self.scfg.eos_id
        if (len(req.generated) >= req.max_new_tokens
                or (eos >= 0 and tok == eos)
                or int(self.pos[s]) >= self.scfg.max_len - 1):
            self._finish(s, req)

    def _extend_step(self) -> int:
        """One multi-token wave: plan per-slot widths, draft proposals
        for speculative slots, verify/teacher-force everything in a
        single ``extend_paged`` call, then accept and roll back.

        Slot modes — ``spec`` (no pending prompt, speculative engine):
        feed ``[t0, d_1..d_{v-1}]``, judge the proposals, emit
        ``n_accepted + 1`` tokens; ``catch``: teacher-force up to ``K``
        pending prompt tokens (sampled rows discarded until the prompt
        is consumed); ``plain``: one decode token (a slot out of room
        for proposals, or a vanilla engine's decoding slot)."""
        B, K = self.scfg.max_slots, self.K
        gamma = self.scfg.spec_gamma
        eos = self.scfg.eos_id
        plan: dict[int, tuple] = {}
        for s in range(B):
            if not self.active[s]:
                continue
            pend = self.pending[s]
            npend = 0 if pend is None else int(pend.size)
            room = self.scfg.max_len - 1 - int(self.pos[s])
            if npend:
                plan[s] = ("catch", max(1, min(1 + npend, K, room)))
            elif self.spec is not None and min(gamma, room) >= 2:
                plan[s] = ("spec", min(gamma, room))
            else:
                plan[s] = ("plain", 1)
        plan = self._apply_budget(plan)
        self._ensure_blocks({s: v for s, (_, v) in plan.items()})
        plan = {s: p for s, p in plan.items() if self.active[s]}
        self._record_plan(plan)
        n_active = int(self.active.sum())
        if n_active == 0:
            return 0
        self.peak_active = max(self.peak_active, n_active)
        self.peak_pool_used = max(self.peak_pool_used, self.pool.num_used)

        spec_slots = [s for s, (m, _) in plan.items() if m == "spec"]
        proposals, dists = {}, {}
        if spec_slots:
            # draft only as wide as the widest planned spec span: a
            # budget-shrunk round must not burn draft steps it cannot
            # verify
            k_spec = max(v for m, v in plan.values() if m == "spec")
            proposals, dists = self.spec.propose(
                spec_slots, self.tokens[:, 0], self.temps, self.topks,
                k_spec, self._rng)

        fed = np.zeros((B, K), np.int32)
        valid = np.ones((B,), np.int32)
        for s, (mode, v) in plan.items():
            seq = [int(self.tokens[s, 0])]
            if mode == "catch":
                seq += [int(t) for t in self.pending[s][:v - 1]]
            elif mode == "spec":
                seq += proposals[s][:v - 1]
            fed[s, :len(seq)] = seq
            fed[s, len(seq):] = seq[-1]       # pad (write-dropped)
            valid[s] = v

        # all-greedy waves bring only the (B, K) argmax ids to the host
        need_logits = bool((self.temps[self.active] > 0).any())
        fed_t, pos_t, valid_t, tables = self._device_tensors(
            fed, self.pos, valid, self.block_tables)
        greedy, logits = self._extend_fn(fed_t, pos_t, valid_t, tables,
                                         need_logits=need_logits)
        greedy = greedy.cpu().numpy()                        # (B, K)
        logits = logits.cpu().numpy() if need_logits else None

        def sample(s, row, temp, top_k):
            if temp <= 0:
                return int(greedy[s, row])
            return sample_from_logits(logits[s, row], temp, top_k,
                                      self._rng)

        any_spec = False
        for s in range(B):
            if s not in plan or not self.active[s]:
                continue
            mode, v = plan[s]
            req = self.slot_req[s]
            temp, top_k = float(self.temps[s]), int(self.topks[s])
            if mode == "catch":
                self.pos[s] += v
                rest = self.pending[s][v - 1:]
                if rest.size:
                    self.tokens[s, 0] = int(rest[0])
                    self.pending[s] = rest[1:]
                    if int(self.pos[s]) >= self.scfg.max_len - 1:
                        self._finish(s, req)
                    continue
                self.pending[s] = None
                self._retire(s, req, sample(s, v - 1, temp, top_k))
                continue
            if mode == "plain":
                self.pos[s] += 1
                self._retire(s, req, sample(s, 0, temp, top_k))
                continue
            # speculative round
            any_spec = True
            if temp <= 0:
                n_acc, emitted = accept_greedy(proposals[s][:v - 1],
                                               greedy[s, :v])
            else:
                n_acc, emitted = accept_proposals(
                    proposals[s][:v - 1], dists[s][:v - 1],
                    logits[s, :v], temp, top_k, self._rng)
            self.spec.advance(s, n_acc + 1)
            self.spec_rounds += 1
            self.spec_proposed += v - 1
            self.spec_accepted += n_acc
            # acceptance by draft depth (registry counters)
            for j in range(v - 1):
                self.metrics.counter(f"spec.depth{j}.proposed").inc()
            for j in range(n_acc):
                self.metrics.counter(f"spec.depth{j}.accepted").inc()
            # budget / EOS truncation (both finish the request)
            emit = emitted[:req.max_new_tokens - len(req.generated)]
            if eos >= 0 and eos in emit:
                emit = emit[:emit.index(eos) + 1]
            req.generated.extend(emit)
            self.spec_emitted += len(emit)
            # frontier: every emitted token but a final correction/bonus
            # was fed (and written) this wave
            self.pos[s] += min(len(emit) + 1, n_acc + 1)
            if (len(req.generated) >= req.max_new_tokens
                    or (eos >= 0 and emit and emit[-1] == eos)
                    or int(self.pos[s]) >= self.scfg.max_len - 1):
                self._finish(s, req)
            else:
                self.tokens[s, 0] = emit[-1]
                self._truncate_slot(s)   # rejected-tail pages back
        if any_spec:
            self.spec_steps += 1
        self.steps += 1
        self.extend_waves += 1
        return n_active

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        self.completed.append(req)
        self._release_slot(slot)

    def _release_slot(self, slot: int) -> None:
        """Free a slot and its pages (no prefix cache keeps them)."""
        self.active[slot] = False
        self.slot_req[slot] = None
        self.pending[slot] = None
        if self.paged:
            self.pool.free(self.slot_blocks[slot])
            self._set_table(slot, [])

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _register_metrics(self) -> dict:
        """Register the serving counters/gauges into the registry and
        return the ``stats()`` map ``{legacy_key: metric_name}`` — the
        JAX engine's keys for the same (paged, no prefix cache) config."""
        m, legacy = self.metrics, {}

        def view(key: Optional[str], name: str, fn) -> None:
            m.gauge(name, fn)
            if key is not None:
                legacy[key] = name

        view("steps", "engine.steps", lambda: self.steps)
        view("peak_active", "engine.peak_active", lambda: self.peak_active)
        view("peak_pool_used", "engine.peak_pool_used",
             lambda: self.peak_pool_used)
        view("exhaust_preempts", "engine.exhaust_preempts",
             lambda: self.exhaust_preempts)
        view("reclaims", "engine.reclaims", lambda: self.reclaims)
        # pages are never shared without the prefix cache: nothing forks
        view("cow_forks", "engine.cow_forks", lambda: 0)
        view("mixed_waves", "engine.mixed_waves", lambda: self.mixed_waves)
        view("wave_admitted", "engine.wave_admitted",
             lambda: self.wave_admitted)
        view("cancels", "engine.cancels", lambda: self.cancels)
        if self.paged:
            self.pool.attach_metrics(m)
            legacy.update(pool_blocks="kv_pool.blocks",
                          pool_free="kv_pool.free",
                          pool_shared="kv_pool.shared")
        if self.quant or self.scfg.quant_draft:
            view("quant_kv", "quant.kv", lambda: self.scfg.quant_kv or "")
            view("quant_draft", "quant.draft",
                 lambda: bool(self.scfg.quant_draft
                              and self.spec is not None))
            # capacity facts: bytes of one page under this layout vs f32
            view("quant_page_bytes", "quant.page_bytes",
                 lambda: page_bytes(self.cfg, self.block_size,
                                    self.scfg.quant_kv
                                    if self.quant else None))
            view("quant_f32_page_bytes", "quant.f32_page_bytes",
                 lambda: page_bytes(self.cfg, self.block_size, None))
        if self.scfg.spec_decode:
            view("spec_active", "spec.active",
                 lambda: self.spec is not None)
            view("spec_steps", "spec.steps", lambda: self.spec_steps)
            view("spec_rounds", "spec.rounds", lambda: self.spec_rounds)
            view("spec_proposed", "spec.proposed",
                 lambda: self.spec_proposed)
            view("spec_accepted", "spec.accepted",
                 lambda: self.spec_accepted)
            view("spec_emitted", "spec.emitted", lambda: self.spec_emitted)
            view("spec_acceptance", "spec.acceptance",
                 lambda: self.spec_accepted / max(self.spec_proposed, 1))
            # mean verify-model tokens per round per slot (1.0 = vanilla)
            view("spec_tokens_per_round", "spec.tokens_per_round",
                 lambda: self.spec_emitted / max(self.spec_rounds, 1))
            # acceptance by draft depth, bumped in _extend_step
            for j in range(max(self.scfg.spec_gamma - 1, 0)):
                m.counter(f"spec.depth{j}.proposed")
                m.counter(f"spec.depth{j}.accepted")
        # wave kinds (registry only): decode waves launch the paged
        # decode read once per layer
        view(None, "engine.decode_waves", lambda: self.decode_waves)
        view(None, "engine.extend_waves", lambda: self.extend_waves)
        return legacy

    def stats(self) -> dict:
        """Pool observability — a view over the metrics registry.  Every
        call re-checks the pool accounting invariant (with a pool)."""
        if self.paged:
            self.pool.assert_consistent()
        return {key: self.metrics.get(name)
                for key, name in self._legacy_stats.items()}

    # ------------------------------------------------------------------
    def cancel(self, uid: int) -> bool:
        """Abort a request — queued, preempted-and-detached, mid-catch-up
        or decoding.  Returns True when it was found (marked
        ``cancelled`` + ``done``, moved to ``self.cancelled``).  Its
        pages go back to the pool; a live slot is freed between waves,
        so no token already delivered is rolled back."""
        for i, req in enumerate(self.queue):
            if req.uid != uid:
                continue
            self.queue.pop(i)
            st = req.saved_state
            if st is not None:
                req.saved_state = None
                if self.paged:
                    self.pool.free(st.get("blocks", ()))
            self._mark_cancelled(req)
            return True
        for s in range(self.scfg.max_slots):
            req = self.slot_req[s]
            if not self.active[s] or req is None or req.uid != uid:
                continue
            self._release_slot(s)
            self._mark_cancelled(req)
            return True
        return False

    def _mark_cancelled(self, req: Request) -> None:
        req.done = True
        req.cancelled = True
        self.cancelled.append(req)
        self.cancels += 1

    def preempt(self, slot: int) -> Optional[Request]:
        """Evict a running request, taking its per-slot cache rows (a copy,
        ``extract_slot``) and decode position with it; its KV pages stay
        in the pool, DETACHED onto the request — re-submission restores
        the rows and the block table and resumes decode where it stopped,
        with no re-prefill and no page copies.  A uniform paged trunk
        has no per-slot rows (empty placeholders), a pattern trunk's
        rows are its local rings; the pool-free ssm cache is all rows.  A speculative engine also saves a copy of the
        slot's draft row and frontier."""
        req = self.slot_req[slot]
        if req is None:
            return None
        req.saved_state = {
            "cache": extract_slot(self.cache, slot, self.axes),
            "pos": int(self.pos[slot]),
            "last_tok": int(self.tokens[slot, 0]),
            "pending": self.pending[slot],
        }
        if self.spec is not None:
            req.saved_state["draft"] = self.spec.extract(slot)
        if self.paged:
            req.saved_state["blocks"] = self.slot_blocks[slot]
            self._set_table(slot, [])
        self.active[slot] = False
        self.slot_req[slot] = None
        self.pending[slot] = None
        return req

    def _drop_saved(self, req: Request) -> None:
        """Forced reclaim under pool exhaustion: release the detached
        pages and rebuild the request as a fresh prompt (original prompt
        + tokens generated so far, folded once).  The exact context is
        replayed, but prefill and decode logits agree only to float
        tolerance: the contract is liveness and the token budget."""
        st = req.saved_state
        req.saved_state = None
        self.pool.free(st.get("blocks", ()))
        folded = getattr(req, "_folded_generated", 0)
        fresh = req.generated[folded:]
        if fresh:
            req.prompt = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(fresh, np.int32)])
            req._folded_generated = len(req.generated)

    def _reclaim(self) -> None:
        holders = [r for r in self.queue
                   if r.saved_state is not None
                   and r.saved_state.get("blocks")]
        if not holders:
            raise RuntimeError(
                "serving pool wedged: no active slots, queue non-empty, "
                "and no detached pages to reclaim (pool misconfigured?)")
        victim = max(holders, key=self._rank)   # worst-ranked holder
        self._drop_saved(victim)
        self.reclaims += 1

    def drain_step(self) -> int:
        """One ``step()`` with the pool accounting invariant re-checked
        after it."""
        stepped = self.step()
        if self.paged:
            self.pool.assert_consistent()
        return stepped

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or self.active.any()) and self.steps < max_steps:
            self.drain_step()
        return self.completed
