"""Step-driven multi-tenant serving engine over a paged KV cache
(PyTorch port of ``repro.serving.engine``).

The unit of work is one ``step()`` — admit, plan, one wave, retire — and
requests arrive (``submit``) and leave (``cancel``) between any two
steps; ``run_until_drained`` loops ``drain_step``.  The contract is the
JAX engine's, and on the same weights the greedy tokens are the same:

* ADMIT — ``core.scheduler.admission_rank`` orders the queue (fifo /
  priority / edf); admission is capacity-aware (a request is taken only
  when the pool, counting prefix-cache pages evictable now, can cover
  its first span plus one decode write).  A fresh request is looked up
  in the radix prefix cache first: a hit pins the shared chain and only
  the unmatched suffix is prefilled.  Prompts are right-padded to the
  smallest prefill bucket and prefilled in one batch per (bucket,
  context width) with ``true_len``, writing K/V straight into the pages
  (``model.prefill_paged``); prompts past the largest bucket catch up
  teacher-forced through extend waves.  With
  ``ServeConfig.chunked_prefill`` admission is bookkeeping only and the
  prompt (or the suffix after a hit) enters as wave spans
  (``_admit_wave``).
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
* RETIRE — committed tokens land in ``Request.generated``; a finished
  slot's pages go to the radix cache (``_finish``), live slots publish
  their frontier pages for in-flight sharing, and EOS, budget, the
  ``max_len`` wall or cancellation free the slot.

Speculative decoding (``spec_decode``, ``serving.spec_decode``): on a
``model.spec_decodable`` config every wave is an extend wave.  The draft
(an explicit ``draft=(cfg, params)``, the early-exit self-draft, or a
registry smoke config drawn from a ``torch.Generator`` seeded with
``ServeConfig.seed``) proposes up to ``spec_gamma - 1`` tokens per slot
from its own dense cache; one extend call verifies them; greedy or
rejection-sampling acceptance commits ``n_accepted + 1`` tokens and
``_truncate_slot`` returns the rejected tail's pages.  Greedy output is
the vanilla engine's token for token.  ``quant_draft`` quantizes the
draft's projection weights to int8 (``layers.quantize_matmul_params``),
which then run through the hand-written ``quant_matmul`` kernel on the
card.

Paged KV: every slot holds an ordered list of pool pages
(``kv_pool.KVBlockPool``), mirrored into the ``(max_slots, max_len //
kv_block_size)`` int32 block tables (-1 = unallocated) that every wave
sends to the device.  Before a wave each slot's table covers its write
span (``_ensure_blocks``, evicting LRU prefix-cache chains under
pressure); on pool exhaustion the slot is preempted back to the queue
with its pages detached (preempt-or-queue), and resumes with no
re-prefill.  When nothing can run and detached requests hold every
page, the worst-ranked one is reclaimed (its context is replayed as a
prompt), so ``step()`` loops never wedge.  No page leaks:
``drain_step`` re-checks ``pool.assert_consistent()`` after every step,
and at drain every page is free or held by the radix cache.

Shared pages (the radix prefix cache, ``serving.prefix_cache``, on a
``model.prefix_sharable`` config with ``ServeConfig.prefix_cache``):

* matching is token-granular; a hit that ends mid-page has that page
  forked private at admission (``KVBlockPool.fork`` plus a device page
  copy), and the suffix prefill reads the context below ``ctx_len``
  while it writes from ``ctx_len`` on through the row's full table;
* a slot's table may hold pages with refcount > 1; they are read-only:
  every page a wave writes is fresh or was forked, and ``_cow_guard``
  forks any write target with a second owner before the wave runs;
* after every wave each live slot publishes its full pages below
  ``floor(pos / block_size) * block_size`` (``_publish_frontiers``), so
  a later request can hit a chain that is still decoding; rollback
  (``_truncate_slot``) frees only pages above ``pos``;
* a finished or cancelled chain is indexed with its partial tail page
  (``_retire_chain``), duplicates of indexed pages are freed, and
  chains whose pages only the cache holds are evicted LRU under
  pressure;
* with ``ServeConfig.prefix_persist_path``, ``close()`` writes the
  cache's refcount-free chains (and chains evicted under pressure,
  spilled to the host first) to a store, and a new engine with the same
  path reads them back into its pool; a corrupt or mismatched store
  (config, weights, page layout) is rejected with its reason in
  ``persist_rejected`` and the engine starts cold.

Tokens after a hit — page-aligned, mid-page, in flight or read back from
a store — equal a cold run's.  Configs whose decode state is not all in
pages (gemma's local rings, the ssm and hybrid recurrences) never
share: the cache stays off.

Extras (the vlm and encdec families): a request carries its image or
audio embeddings in ``Request.extras``, and they enter the state only
through the admission prefill: such a request never takes the chunked
wave admission (under ``chunked_prefill`` it prefills the smallest
bucket, the rest catching up through waves), its admission group is
keyed by the extras' keys and shapes, and the extras are stacked per
group.  The vlm's image occupies positions [0, num_image_tokens) of the
slot's pages before the prompt (``_prefix``).  Its chains live in a
namespace digested from the extras' bytes (``_key_ns``), keyed with -42
pseudo-tokens for the image positions, so only requests with identical
extras share, and a vlm match that does not cover the whole image is a
miss.

MoE capacity (the moe family, ``models.moe``): an expert takes at most
``capacity(cfg, N)`` tokens of a call, with N the call's static token
count: a decode wave's ``max_slots`` rows (idle slots ride along with
their stale token and position, unmasked, as in JAX), an extend wave's
``max_slots x K`` (pad rows are kept out of capacity, not out of the
bound), an admission group's ``m x bucket`` (pads likewise).  Under
capacity pressure which tokens drop therefore depends on the batch: a
request served beside others, or admitted as a hit suffix, can emit
other tokens than served alone or cold.  The engine feeds the JAX
engine's rows in the JAX engine's order, so it drops the same tokens;
with ``capacity_factor`` high enough that nothing drops, moe is exact
like every other family and its hits equal cold runs.

Sampling is per request (``Request.temperature`` / ``top_k`` over the
``ServeConfig`` defaults): the decode wave samples on the device from
the engine's ``torch.Generator`` (Gumbel-max), first tokens and
catch-up tokens on the host from the engine's numpy generator, as in
the JAX engine.  Greedy tokens match the JAX engine; sampled tokens
match it in distribution only (the generators differ).
``reset_rng()`` re-seeds both.

Without pages (``self.paged = False``) the cache is ``model.init_cache``
with one row per slot (batch axes from ``cache_batch_axes``): no
``KVBlockPool``, no block tables, no prefix cache; admission prefills
write each row's state at its slot (``prefill_paged`` without tables);
waves are ``model.decode_step`` / ``model.extend``; preemption copies
the slot's rows out (``extract_slot``) and resumption copies them back
(``insert_slot``); ``quant_kv="int8"`` is disarmed (no pages to
quantize).  Two kinds of config run so:

* the dense twin, ``ServeConfig(paged=False)`` on a family with pages:
  ``max_len`` strips per slot and layer (rings for gemma's local
  layers), speculation rolling back by position masks, and
  ``use_pallas_paged`` launching nothing, as in JAX;
* a family whose paged cache has no pool leaf (ssm: O(1) recurrent
  state per row; hybrid: that and the shared attention block's rings
  of ``min(max_len, local_window)`` entries per row), whatever
  ``paged`` says.  Prompts past the largest bucket catch up one token a
  decode wave, and ``spec_decode`` is quietly ignored (the recurrence
  cannot roll back).  One choice is the port's own: there
  ``use_pallas_paged=True`` sends the admission prefill's scan through
  the hand-written ``ssd_scan`` kernel (``prefill_paged(use_kernel=
  True)``) and, on the hybrid, the shared block's causal prefill
  attention through the hand-written ``flash_attention`` kernel
  (``use_flash=True``).  The JAX engine sets neither, and the flag is
  its only "serve through the hand kernels" switch; with it off the
  port runs the plain chunked scan and the plain masked softmax, which
  is what the JAX engine runs.

Tracing (``ServeConfig.trace``, ``serving.telemetry.Tracer``) records
the JAX engine's spans and lifecycle events at the JAX engine's points:
``step`` / ``admit`` / ``plan`` / ``draft`` / ``dispatch`` / ``retire`` /
``publish`` on the engine track, ``prefill_dispatch`` around an
admission prefill, a residency span per slot, and per-request events
(submit, queued, admitted, prefill_chunk, prompt_done, first_token,
tokens, spec_round, cow_fork, preempt, resume, finish, cancel).  The
fences are the port's device synchronisation: a traced step waits for
the device in a ``sync`` span (``prefill_sync`` after an admission
prefill) just before it copies the wave's result to the host, which
waits for the device anyway, so tokens are unchanged; on CPU tensors the
span is empty.  Untraced, every span is a ``nullcontext`` and the step
is the same code.  ``dump_chrome_trace`` writes the Perfetto dump.

``step`` runs under ``torch.no_grad()``: no wave needs gradients, and
the frontend runs steps on an executor thread, where a caller's grad
mode does not reach.
"""
from __future__ import annotations

import hashlib
import itertools
import os
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device, tensor_device
from repro_torch.models import model as M
from repro_torch.serving.kv_pool import KVBlockPool, PoolExhausted, \
    blocks_for_tokens, page_bytes
from repro_torch.serving.prefix_cache import (PERSIST_VERSION,
                                              PrefixStoreError,
                                              RadixPrefixCache, dump_chains,
                                              load_store, save_store)
from repro_torch.serving.spec_decode import (SpecDecoder, accept_greedy,
                                             accept_proposals,
                                             make_self_draft,
                                             sample_from_logits,
                                             validate_spec)
# NOTE: repro_torch.core.scheduler is imported lazily in _rank and
# _apply_budget — core/__init__ pulls in hub.py, which imports this
# module back (as in the JAX engine).
from repro_torch.serving.telemetry import SLOT_TID0, MetricsRegistry, Tracer


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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array of ``prefix_cache.host_dtype``
    (a bfloat16 tensor as its int16 bits)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_host``, on ``like``'s device and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


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


@dataclass(frozen=True)
class ServeConfig:
    """The JAX ``ServeConfig``, field for field and default for default
    (see ``repro.serving.engine.ServeConfig`` for each field)."""
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
    # record engine-phase spans and request lifecycles (Tracer) against
    # trace_clock (None -> telemetry.grid_clock)
    trace: bool = False
    trace_clock: Optional[Callable[[], float]] = None


class EdgeServingEngine:
    """Continuous-batching decode engine for one model on one device
    (``device`` default ``cuda``; ``params`` must lie there).

    ``draft``: optional ``(draft_cfg, draft_params)`` for speculative
    decoding, on the same device; it overrides
    ``ServeConfig.draft_arch``.

    ``paged`` is False for the dense twin (``ServeConfig(paged=False)``)
    and for a family whose cache has no page-pool leaf (the module
    docstring's pages-free configs)."""

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
        # no page-pool leaf (ssm, hybrid) has no pages to serve from
        axes = paged_cache_axes(cfg, T, 1, 1, kv_dtype=scfg.quant_kv)
        has_pool = any(a < 0 for a in _leaves(axes))
        self.paged = bool(scfg.paged and has_pool)
        # the port's hand-kernel prefill of the pool-free families (the
        # module docstring); the dense twin's prefill launches nothing
        self._kernel_prefill = bool(scfg.use_pallas_paged and not has_pool)
        if self.paged:
            self.n_blk = T // bs
            if scfg.kv_pool_blocks:
                # a user-set pool is a TOKEN budget
                n_pool = scfg.kv_pool_blocks * scfg.kv_block_size // bs
            else:
                n_pool = B * self.n_blk
        self.block_size = bs              # effective page size
        # int8 pages with per-row float32 scales: the pool's capacity
        # lever; without pages there is nothing to quantize
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
        # radix prefix cache: only where the whole decode state lives in
        # pages (model.prefix_sharable), else a hit could not rebuild
        # ring or recurrent state
        self.sharable = bool(self.paged and scfg.prefix_cache
                             and M.prefix_sharable(cfg))
        self.prefix_cache = (RadixPrefixCache(
            self.pool, bs, min_match_tokens=scfg.min_match_tokens)
            if self.sharable else None)
        # persistence: chains evicted under pressure are spilled to the
        # host before the pool takes their pages back and join the
        # close()-time store; a store left at the same path rehydrates
        self._spilled: list = []
        self.persist_loaded_chains = 0
        self.persist_loaded_blocks = 0
        self.persist_rejected = ""
        if self.sharable and scfg.prefix_persist_path:
            self.prefix_cache.on_evict = self._spill_chain
            self._load_prefix_store(scfg.prefix_persist_path)
        # in-flight sharing: tokens (page-aligned) each slot has already
        # published to the radix tree
        self.slot_published = [0] * B
        self.published_frontiers = 0
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
        self.cow_forks = 0
        # speculative decoding: rounds = (slot, wave) drafting
        # participations; emitted includes each round's correction/bonus
        self.spec_steps = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(clock=scfg.trace_clock) if scfg.trace else None
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
    def reset_rng(self) -> None:
        """Re-seed the sampling state (the device generator and the host
        rng) to ``ServeConfig.seed``: after a warm-up pass, a sampled run
        draws what a fresh engine's would."""
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.scfg.seed)
        self._rng = np.random.default_rng(self.scfg.seed)

    @property
    def _prefix(self) -> int:
        """Positions before the prompt in a slot's pages: the vlm's image
        tokens."""
        return self.cfg.num_image_tokens if self.cfg.family == "vlm" else 0

    def submit(self, req: Request) -> None:
        """Queue ``req``.  ``req.extras`` carries the stub frontends'
        embeddings, one request's row each (no batch axis): the vlm's
        ``image_embeds`` (num_image_tokens, image_embed_dim) and the
        encdec's ``audio_embeds`` (encoder_seq, d_model), as numpy
        arrays, as in JAX; the image takes ``num_image_tokens`` of the
        ``max_len`` budget."""
        limit = self.scfg.max_len - 1 - self._prefix
        if req.saved_state is None:
            if len(req.prompt) > limit:
                raise ValueError(
                    f"prompt length {len(req.prompt)} exceeds max_len "
                    f"budget {limit} (max_len={self.scfg.max_len})")
            worst = self._prefix + len(req.prompt) + req.max_new_tokens
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
        if self.tracer is not None:
            fresh = req.saved_state is None and not req.generated
            self._revent(req, "submit" if fresh else "resubmit",
                         prompt_tokens=len(req.prompt))
            self._revent(req, "queued", depth=len(self.queue) + 1)
        self.queue.append(req)

    def _rank(self, req: Request):
        from repro_torch.core.scheduler import admission_rank
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

    # -- prefix-cache keys ---------------------------------------------
    def _key_ns(self, req: Request) -> int:
        """Namespace of a request's chains: 0 without extras, else a
        digest of its non-token inputs (sha1 over the sorted keys and
        each extra's bytes, the JAX engine's), so requests whose K/V
        depends on an image or audio share only with identical ones.
        Memoized on the request: its extras do not change, and
        ``_publish_frontiers`` asks once per page crossing."""
        ns = getattr(req, "_ns_digest", None)
        if ns is not None:
            return ns
        if not req.extras:
            ns = 0
        else:
            h = hashlib.sha1()
            for k in sorted(req.extras):
                h.update(k.encode())
                h.update(np.ascontiguousarray(req.extras[k]).tobytes())
            ns = int.from_bytes(h.digest()[:8], "little") & (2 ** 63 - 1)
        req._ns_digest = ns
        return ns

    def _key_tokens(self, req: Request) -> np.ndarray:
        """The token sequence whose positions map 1:1 onto the slot's
        pages: -42 pseudo-tokens for the vlm's image positions (the
        namespace pins the image), the prompt, then the tokens generated
        and not yet folded into it (the caller takes the KV-valid
        prefix)."""
        parts = [np.full((self._prefix,), -42, np.int64),
                 np.asarray(req.prompt, np.int64)]
        folded = getattr(req, "_folded_generated", 0)
        if len(req.generated) > folded:
            parts.append(np.asarray(req.generated[folded:], np.int64))
        return np.concatenate(parts)

    def _lookup(self, req: Request) -> None:
        """Radix lookup for a fresh request: pin (incref) the longest
        usable shared chain of its namespace — token-granular, possibly
        ending mid-page, possibly still being decoded by another slot —
        and keep it on the request for the admission pass.  Capped one
        token short of the prompt (the suffix prefill must produce the
        admission logits); a vlm match shorter than the image prefix is
        a miss (a text-only suffix prefill cannot start inside the
        image), and its hit is rolled back."""
        self._release_ctx(req)          # drop any stale acquisition
        if not self.sharable or req.saved_state is not None:
            return
        key = np.concatenate([np.full((self._prefix,), -42, np.int64),
                              np.asarray(req.prompt, np.int64)])
        blocks, n = self.prefix_cache.match(
            key, namespace=self._key_ns(req), max_tokens=len(key) - 1)
        if n and n < self._prefix:
            self.pool.free(blocks)
            self.prefix_cache.unrecord_hit(
                len(blocks), n, (n // self.block_size) * self.block_size)
            blocks, n = [], 0
        req._ctx_blocks, req._ctx_len = blocks, n

    def _release_ctx(self, req: Request) -> None:
        """Drop a pinned but unused chain (the request waits for the next
        admission round, which looks it up again) and roll the hit
        accounting back so retries do not inflate the stats."""
        blocks = getattr(req, "_ctx_blocks", None)
        if blocks:
            n = req._ctx_len
            self.pool.free(blocks)
            self.prefix_cache.unrecord_hit(
                len(blocks), n, (n // self.block_size) * self.block_size)
        req._ctx_blocks, req._ctx_len = [], 0

    # -- paged-pool bookkeeping ----------------------------------------
    def _first_span(self, req: Request, suffix_len: int) -> int:
        """Tokens a request's FIRST admission step covers: the bucketed
        prefill normally; under chunked_prefill the first wave span, but
        a request with extras still prefills (its image or audio enters
        only there), at most the smallest bucket."""
        if self.chunked:
            if req.extras:
                return min(suffix_len, self.scfg.prefill_buckets[0])
            return min(suffix_len, self.K if self.extend_ok else 1)
        return min(suffix_len, self.scfg.prefill_buckets[-1])

    def _blocks_needed(self, req: Request) -> int:
        """New pool blocks this request needs to be admitted NOW: the
        first span's pages + one covering the next write (resumed
        requests already hold pages for [0, pos), prefix-cache hits the
        shared chain's whole pages; a partial last page of a hit counts
        as needed, since admission forks it); 0 without a pool."""
        if not self.paged:
            return 0
        bs = self.block_size
        if req.saved_state is not None:
            held = len(req.saved_state.get("blocks", ()))
            return max(0, blocks_for_tokens(
                int(req.saved_state["pos"]) + 1, bs) - held)
        L = getattr(req, "_ctx_len", 0)
        if L:
            # a hit's L covers the image prefix and L - prefix prompt
            # tokens
            n1 = self._first_span(req, len(req.prompt) - (L - self._prefix))
            return blocks_for_tokens(L + n1 + 1, bs) - L // bs
        n1 = self._first_span(req, len(req.prompt))
        return blocks_for_tokens(self._prefix + n1 + 1, bs)

    def _reserve(self, n: int) -> bool:
        """Make ``n`` pool pages allocatable, evicting LRU prefix-cache
        chains if the free list alone is short."""
        if not self.paged:
            return True
        short = n - self.pool.num_free
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.pool.num_free >= n

    def _avail_blocks(self) -> int:
        """Pages admission may count on: free now + evictable now."""
        if not self.paged:
            return 0
        extra = (self.prefix_cache.evictable_blocks()
                 if self.prefix_cache is not None else 0)
        return self.pool.num_free + extra

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
        self._slot_begin(req, slot)
        self._revent(req, "resume", slot=slot)
        st = req.saved_state
        req.saved_state = None
        if self.paged:
            blocks = list(st.get("blocks", ()))
            if need:  # feasibility pre-checked by the admission scan
                self._reserve(need)
                blocks += self.pool.alloc(need)
            self._set_table(slot, blocks)
        insert_slot(self.cache, st["cache"], slot, self.axes)
        if self.spec is not None:
            self.spec.insert(slot, st.get("draft"))
        self.pos[slot] = st["pos"]
        self.tokens[slot, 0] = st["last_tok"]
        self.pending[slot] = st["pending"]
        self._place(req, slot)
        # publication resumes where the preempted slot left it
        self.slot_published[slot] = int(st.get("published", 0))

    def _admit_wave(self, req: Request, slot: int) -> None:
        """Chunked-prefill admission: NO prefill call — the prompt (or
        the unmatched suffix after a radix hit) becomes the slot's
        pending span, consumed through the same extend/decode waves
        every other slot rides.  Shared context pages attach as the
        prefill path would; the first wave's ``_ensure_blocks`` /
        ``_cow_guard`` allocate fresh pages and fork a partially matched
        tail page."""
        L = getattr(req, "_ctx_len", 0)
        self._slot_begin(req, slot)
        self._revent(req, "admitted", slot=slot, mode="wave",
                     prefix_hit_tokens=L)
        if self.paged:
            self._set_table(slot, list(getattr(req, "_ctx_blocks", None)
                                       or []))
        req._ctx_blocks, req._ctx_len = [], 0
        # (never a request with extras: those prefill their first span)
        suffix = np.asarray(req.prompt, np.int32)[max(0, L - self._prefix):]
        if self.spec is not None:
            # the draft prefills the full prompt (it never chunks), so
            # the slot is draft-complete once its prompt is consumed
            self.spec.admit_group([req], [slot])
        self.pos[slot] = L
        self.tokens[slot, 0] = int(suffix[0])
        self.pending[slot] = suffix[1:]
        self._place(req, slot)
        # the matched prefix is already indexed: publication resumes
        # from its page boundary
        self.slot_published[slot] = L // self.block_size * self.block_size
        self.wave_admitted += 1

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << (n - 1).bit_length() if n > 1 else n

    def _admit_batch(self) -> None:
        """Admit queued requests into free slots in rank order, batching
        prefill per (bucket, extras signature, context width) group — one
        call per group.
        Capacity-aware: a request is taken only if the pool, counting
        pages evictable now, can cover its suffix pages + first decode
        write; a fresh request is looked up in the prefix cache first (a
        hit pins the chain and shrinks both the pages needed and the
        prefill).  Requests that don't fit now wait."""
        if not self.queue:
            return
        free = [s for s in range(self.scfg.max_slots) if not self.active[s]]
        if not free:
            return
        self.queue.sort(key=self._rank)
        avail = self._avail_blocks()
        taken, kept = [], []
        for req in self.queue:
            if not free:
                kept.append(req)
                continue
            self._lookup(req)
            need = self._blocks_needed(req)
            # pinning a hit chain takes its pages out of the evictable
            # count — only pages this lookup pinned (cache + us = 2)
            pinned = sum(1 for b in (getattr(req, "_ctx_blocks", None)
                                     or ())
                         if self.pool.refcount(b) == 2)
            if self.paged and need + pinned > avail:
                self._release_ctx(req)
                kept.append(req)
                continue
            avail -= need + pinned
            taken.append((req, free.pop(0)))
        self.queue = kept

        # (bucket, extras signature, n_ctx) -> [(req, slot)]
        fresh: dict[tuple, list] = {}
        for req, slot in taken:
            if req.saved_state is not None:
                self._admit_resumed(req, slot)
            elif self.chunked and not req.extras:
                self._admit_wave(req, slot)
            else:
                L = getattr(req, "_ctx_len", 0)
                n1 = self._first_span(
                    req, len(req.prompt) - max(0, L - self._prefix))
                sig = tuple(sorted((k, np.shape(v))
                                   for k, v in req.extras.items()))
                # hit rows read and write through one full table over
                # [0, L + n1), pow2-bucketed so mixed depths share a call
                n_ctx = (self._pow2(blocks_for_tokens(L + n1,
                                                      self.block_size))
                         if L else 0)
                fresh.setdefault((self._bucket(n1), sig, n_ctx),
                                 []).append((req, slot))
        for (bucket, sig, n_ctx), group in fresh.items():
            self._admit_group(bucket, sig, n_ctx, group)

    def _admit_group(self, bucket: int, extras_sig: tuple, n_ctx: int,
                     group) -> None:
        """One fused admission call: batched (suffix-)prefill that writes
        prompt K/V straight into the slots' pages (without pages, each
        row's state into its slot's cache rows).  Rows share the extras
        signature (keys and shapes), stacked into the batch.  ``n_ctx``
        > 0 means every row is a prefix-cache hit admitted at its chain's
        end, which may be mid-page: that page is forked here so the
        suffix write never lands in a page the cache or a reader still
        holds.  A cold vlm row writes its image prefix and text from
        position 0."""
        bs = self.block_size
        if self.paged:
            # a row whose pages cannot be covered even after eviction (a
            # chain pinned mid-scan ate the budget) goes back to the queue
            admitted = []
            for req, slot in group:
                need = self._blocks_needed(req)
                L = getattr(req, "_ctx_len", 0)
                try:
                    self._reserve(need)
                    fresh_n = need
                    if L % bs:
                        # trade the shared partial page for a private
                        # copy; ``need`` counts it, and fork either draws
                        # that page or (the cache let go of its ref)
                        # hands the page back unshared
                        fresh_n = need - 1
                        old = req._ctx_blocks[-1]
                        new = self.pool.fork(old)
                        if new != old:
                            self._copy_page(old, new)
                            req._ctx_blocks[-1] = new
                            self.cow_forks += 1
                            self._revent(req, "cow_fork", slot=slot)
                    blocks = self.pool.alloc(fresh_n)
                except PoolExhausted:
                    self._release_ctx(req)
                    self.queue.append(req)
                    continue
                ctx = getattr(req, "_ctx_blocks", None) or []
                self._set_table(slot, list(ctx) + blocks)
                admitted.append((req, slot))
            group = admitted
            if not group:
                return
        for req, slot in group:
            self._slot_begin(req, slot)
            self._revent(req, "admitted", slot=slot, mode="prefill",
                         prefix_hit_tokens=getattr(req, "_ctx_len", 0))
        m = len(group)
        prompts = np.zeros((m, bucket), np.int32)
        true_len = np.zeros((m,), np.int32)
        ctx_len = np.zeros((m,), np.int32)
        # hit rows: one full table per row from logical block 0; cold
        # rows: the write span's table, the vlm's image prefix included
        n_wblk = n_ctx or (blocks_for_tokens(self._prefix + bucket, bs)
                           if self.paged else 0)
        tables = np.full((m, n_wblk), -1, np.int32)
        suffixes = []
        for i, (req, slot) in enumerate(group):
            L = getattr(req, "_ctx_len", 0)
            suffix = np.asarray(req.prompt, np.int32)[
                max(0, L - self._prefix):]
            suffixes.append(suffix)
            n1 = min(len(suffix), bucket)
            # pad value is irrelevant (true_len masks it) — repeat last tok
            prompts[i] = suffix[n1 - 1]
            prompts[i, :n1] = suffix[:n1]
            true_len[i] = n1
            ctx_len[i] = L
            if self.paged:
                blk = self.slot_blocks[slot][:n_wblk]
                tables[i, :len(blk)] = blk
        dev = self.device
        if self.paged:
            kw = dict(write_tables=torch.from_numpy(tables).to(dev))
            if n_ctx:
                kw.update(ctx_tables=kw["write_tables"],
                          ctx_len=torch.from_numpy(ctx_len).to(dev))
        else:
            # the port's choice on the pool-free families: the hand-kernel
            # switch also runs their prefill scan through ssd_scan and
            # the hybrid's shared-block prefill attention through
            # flash_attention (the dense twin passes neither)
            kw = dict(use_kernel=self._kernel_prefill,
                      use_flash=self._kernel_prefill)
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}
        for k, _ in extras_sig:
            batch[k] = torch.from_numpy(np.stack(
                [np.asarray(r.extras[k]) for r, _ in group])).to(dev)
        with self._span("prefill_dispatch", bucket=bucket, rows=m):
            logits, self.cache = M.prefill_paged(
                self.cfg, self.params, batch,
                self.scfg.max_len, self.cache,
                slots=torch.tensor([s for _, s in group], dtype=torch.int32,
                                   device=dev),
                true_len=torch.from_numpy(true_len).to(dev), **kw)
        # device prefill time apart from the host's first-token sampling
        self._fence("prefill_sync")
        if self.spec is not None:
            # the draft prefills the FULL prompt (it never chunks), so
            # catch-up slots are draft-complete once their prompt is in
            self.spec.admit_group([r for r, _ in group],
                                  [s for _, s in group])
        logits_host = logits[:, -1].float().cpu().numpy()      # (m, V)
        for i, (req, slot) in enumerate(group):
            L, n1 = int(ctx_len[i]), int(true_len[i])
            req._ctx_blocks, req._ctx_len = [], 0
            remainder = suffixes[i][n1:]
            self._revent(req, "prefill_chunk", slot=slot, n=n1)
            tok = None
            if not remainder.size:
                self._revent(req, "prompt_done", slot=slot)
                tok = self._sample_first(req, logits_host[i])
                req.generated.append(tok)
                self._rtokens(req, slot, 1)
                hit_eos = (self.scfg.eos_id >= 0
                           and tok == self.scfg.eos_id)
                if len(req.generated) >= req.max_new_tokens or hit_eos:
                    # the admission token already completed the request;
                    # its pages hold a valid chain: index it
                    if self.paged:
                        self._retire_chain(req, self.slot_blocks[slot],
                                           (L or self._prefix) + n1)
                        self._set_table(slot, [])
                    req.done = True
                    self.completed.append(req)
                    self._revent(req, "finish", slot=slot,
                                 n_generated=len(req.generated))
                    self._slot_end(slot)
                    continue
            self.pos[slot] = (L or self._prefix) + n1
            if remainder.size:
                # long prompt: catch up through extend waves
                self.pending[slot] = remainder[1:]
                self.tokens[slot, 0] = int(remainder[0])
            else:
                self.pending[slot] = None
                self.tokens[slot, 0] = tok
            self._place(req, slot)
            # the matched prefix is already indexed: publication resumes
            # from its page boundary
            self.slot_published[slot] = L // bs * bs

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
        """Multi-token wave: score ``K`` tokens per slot in one call
        (``model.extend`` without pages).  Ships only the (B, K) argmax
        ids to the host unless some active slot samples at temperature
        > 0."""
        if block_tables is None:
            logits, self.cache = M.extend(self.cfg, self.params, self.cache,
                                          tokens, pos, valid)
        else:
            logits, self.cache = M.extend_paged(
                self.cfg, self.params, self.cache, tokens, pos,
                block_tables, valid, self.scfg.use_pallas_paged)
        logits = logits.float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return greedy, (logits if need_logits else None)

    def _ensure_blocks(self, spans: Optional[dict] = None) -> None:
        """Guarantee every active slot's table covers its write span
        ``[pos, pos + span)``.  Crossing block boundaries appends pages
        (evicting LRU prefix-cache chains first under pressure); if the
        pool is exhausted the slot is preempted back to the queue (pages
        detached) — preempt-or-queue.  Best-ranked slots get first pick
        of the remaining pages."""
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
                self._reserve(n)
                blk = self.pool.alloc(n)
            except PoolExhausted:
                req = self.preempt(s)
                self.exhaust_preempts += 1
                self.queue.append(req)   # resumes when a page frees
                continue
            j0 = len(self.slot_blocks[s])
            self.slot_blocks[s].extend(blk)
            self.block_tables[s, j0:j0 + n] = blk

    def _copy_page(self, src: int, dst: int) -> None:
        """Device page copy ``src`` -> ``dst`` in every pool leaf, in
        place (a copy-on-write fork)."""
        for leaf, ax in zip(_leaves(self.cache), _leaves(self.axes)):
            if ax < 0:
                leaf[:, dst].copy_(leaf[:, src])

    def _cow_guard(self, spans: Optional[dict] = None) -> None:
        """Copy-on-write backstop: no wave may write a page with more
        than one owner.  A slot whose write span ``[pos, pos + span)``
        lands in a shared page trades its reference for a fresh page
        (``KVBlockPool.fork``) holding a copy of the bytes; on pool
        exhaustion the slot preempts, like ``_ensure_blocks``."""
        bs = self.block_size
        spans = spans or {}
        for s in range(self.scfg.max_slots):
            if not self.active[s]:
                continue
            j0 = int(self.pos[s]) // bs
            j1 = min((int(self.pos[s]) + spans.get(s, 1) - 1) // bs,
                     len(self.slot_blocks[s]) - 1)
            for j in range(j0, j1 + 1):
                old = self.slot_blocks[s][j]
                if self.pool.refcount(old) <= 1:
                    continue
                try:
                    self._reserve(1)
                    new = self.pool.fork(old)
                except PoolExhausted:
                    req = self.preempt(s)
                    self.exhaust_preempts += 1
                    self.queue.append(req)
                    break
                self._copy_page(old, new)
                self.slot_blocks[s][j] = new
                self.block_tables[s, j] = new
                self.cow_forks += 1
                self._revent(self.slot_req[s], "cow_fork", slot=s)

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
        from repro_torch.core.scheduler import plan_wave
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

    @torch.no_grad()
    def step(self) -> int:
        """ONE step of the serving core: admit, plan, one wave (extend
        while any slot speculates or catches up, decode otherwise),
        retire.  When
        nothing stepped, requests are queued and detached requests hold
        every page, the worst-ranked holder is reclaimed.  Returns the
        number of active slots stepped (0 = idle)."""
        with self._span("step", step=self.steps):
            with self._span("admit", queued=len(self.queue)):
                self._admit_batch()
            if self.extend_ok and (self.spec is not None
                                   or self._has_pending()):
                stepped = self._extend_step()
            else:
                stepped = self._decode_wave()
            if (stepped == 0 and self.paged and self.queue
                    and not self.active.any()):
                # requests requeued by _ensure_blocks mid-step may need
                # zero new pages — one more admission look before
                # reclaiming
                with self._span("admit", queued=len(self.queue)):
                    self._admit_batch()
                if not self.active.any():
                    self._reclaim()
        return stepped

    def _decode_wave(self) -> int:
        """The plain one-token wave (every active slot has width 1;
        slots still consuming a prompt on a non-extendable config
        teacher-force one pending token)."""
        with self._span("plan"):
            if self.paged:
                self._ensure_blocks()
                self._cow_guard()
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
        with self._span("dispatch", mode="decode", rows=n_active):
            tokens, pos, temps, topks = self._device_tensors(
                self.tokens, self.pos, self.temps, self.topks)
            tables = (self._device_tensors(self.block_tables)[0]
                      if self.paged else None)
            nxt = self._decode_fn(
                tokens, pos, temps, topks, tables,
                any_temp=bool((self.temps[act] > 0).any()),
                any_topk=bool((self.topks[act] > 0).any()))
        self._fence("sync")
        nxt_host = nxt.cpu().numpy()
        with self._span("retire"):
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
                    self._revent(req, "prefill_chunk", slot=slot, n=1)
                    self.tokens[slot, 0] = int(pend[0])
                    self.pending[slot] = pend[1:]
                    if out_of_room:
                        self._finish(slot, req)
                    continue
                if pend is not None:
                    # the wave that consumed the last prompt token
                    self._revent(req, "prompt_done", slot=slot)
                self.pending[slot] = None
                tok = int(nxt_host[slot])
                self.tokens[slot, 0] = tok
                req.generated.append(tok)
                self._rtokens(req, slot, 1)
                hit_eos = self.scfg.eos_id >= 0 and tok == self.scfg.eos_id
                if (len(req.generated) >= req.max_new_tokens or hit_eos
                        or out_of_room):
                    self._finish(slot, req)
        with self._span("publish"):
            self._publish_frontiers()
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
        self._rtokens(req, s, 1)
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
        with self._span("plan"):
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
            if self.paged:
                spans = {s: v for s, (_, v) in plan.items()}
                self._ensure_blocks(spans)
                self._cow_guard(spans)
                plan = {s: p for s, p in plan.items() if self.active[s]}
            self._record_plan(plan)
        n_active = int(self.active.sum())
        if n_active == 0:
            return 0
        self.peak_active = max(self.peak_active, n_active)
        if self.paged:
            self.peak_pool_used = max(self.peak_pool_used,
                                      self.pool.num_used)

        spec_slots = [s for s, (m, _) in plan.items() if m == "spec"]
        proposals, dists = {}, {}
        if spec_slots:
            # draft only as wide as the widest planned spec span: a
            # budget-shrunk round must not burn draft steps it cannot
            # verify
            k_spec = max(v for m, v in plan.values() if m == "spec")
            with self._span("draft", slots=len(spec_slots), width=k_spec):
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
        with self._span("dispatch", mode="extend", rows=n_active,
                        fed_tokens=int(sum(v for _, v in plan.values()))):
            fed_t, pos_t, valid_t = self._device_tensors(fed, self.pos,
                                                         valid)
            tables = (self._device_tensors(self.block_tables)[0]
                      if self.paged else None)
            greedy, logits = self._extend_fn(fed_t, pos_t, valid_t, tables,
                                             need_logits=need_logits)
        self._fence("sync")
        greedy = greedy.cpu().numpy()                        # (B, K)
        logits = logits.cpu().numpy() if need_logits else None

        def sample(s, row, temp, top_k):
            if temp <= 0:
                return int(greedy[s, row])
            return sample_from_logits(logits[s, row], temp, top_k,
                                      self._rng)

        any_spec = False
        with self._span("retire"):
            for s in range(B):
                if s not in plan or not self.active[s]:
                    continue
                mode, v = plan[s]
                req = self.slot_req[s]
                temp, top_k = float(self.temps[s]), int(self.topks[s])
                if mode == "catch":
                    self._revent(req, "prefill_chunk", slot=s, n=v)
                    self.pos[s] += v
                    rest = self.pending[s][v - 1:]
                    if rest.size:
                        self.tokens[s, 0] = int(rest[0])
                        self.pending[s] = rest[1:]
                        if int(self.pos[s]) >= self.scfg.max_len - 1:
                            self._finish(s, req)
                        continue
                    self._revent(req, "prompt_done", slot=s)
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
                self._revent(req, "spec_round", slot=s, proposed=v - 1,
                             accepted=n_acc)
                # budget / EOS truncation (both finish the request)
                emit = emitted[:req.max_new_tokens - len(req.generated)]
                if eos >= 0 and eos in emit:
                    emit = emit[:emit.index(eos) + 1]
                req.generated.extend(emit)
                self.spec_emitted += len(emit)
                self._rtokens(req, s, len(emit))
                # frontier: every emitted token but a final
                # correction/bonus was fed (and written) this wave
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
        with self._span("publish"):
            self._publish_frontiers()
        self.steps += 1
        self.extend_waves += 1
        return n_active

    def _publish_frontiers(self) -> None:
        """In-flight sharing: after every committed wave, publish each
        live slot's full pages below its frontier (``pos`` rounded down
        to a page) into the radix tree.  The cache takes its own
        reference (duplicates of the slot's earlier publications come
        back and are released), so a later request can hit a chain that
        is still decoding: readers pin pages strictly below the
        frontier, the writer only writes at or above ``pos``, and
        rollback frees only pages above ``pos``."""
        if self.prefix_cache is None:
            return
        bs = self.block_size
        for s in range(self.scfg.max_slots):
            if not self.active[s] or self.slot_req[s] is None:
                continue
            frontier = (int(self.pos[s]) // bs) * bs
            if frontier <= self.slot_published[s]:
                continue
            req = self.slot_req[s]
            key = self._key_tokens(req)
            n_blk = frontier // bs
            if len(key) < frontier or len(self.slot_blocks[s]) < n_blk:
                continue                      # reclaim-rebuilt slot mid-fold
            blocks = self.slot_blocks[s][:n_blk]
            self.pool.share(blocks)
            dups = self.prefix_cache.insert(key[:frontier], blocks,
                                            namespace=self._key_ns(req))
            self.pool.free(dups)
            self.slot_published[s] = frontier
            self.published_frontiers += 1

    def _retire_chain(self, req: Request, blocks: list[int],
                      n_valid: int) -> None:
        """Return a finished request's pages: index the chain (its first
        ``n_valid`` positions hold valid K/V, a partial tail page
        included) in the radix cache, which adopts the engine's
        references, and free duplicates of an indexed prefix and pages
        past the valid span.  Without the cache everything is freed."""
        if not self.sharable or not blocks:
            self.pool.free(blocks)
            return
        key = self._key_tokens(req)[:n_valid]
        nb = blocks_for_tokens(n_valid, self.block_size)
        leftovers = self.prefix_cache.insert(key, blocks[:nb],
                                             namespace=self._key_ns(req))
        self.pool.free(list(leftovers) + list(blocks[nb:]))

    def _finish(self, slot: int, req: Request) -> None:
        self._revent(req, "finish", slot=slot,
                     n_generated=len(req.generated))
        req.done = True
        self.completed.append(req)
        self._release_slot(slot)

    def _release_slot(self, slot: int) -> None:
        """Free a slot.  Its pages hold valid K/V for [0, pos) —
        everything prefill, catch-up and decode waves wrote (the last
        sampled token was never fed back) — and retire as a chain into
        the radix cache (``_retire_chain``; freed without it)."""
        req = self.slot_req[slot]
        self._slot_end(slot)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.pending[slot] = None
        self.slot_published[slot] = 0
        if self.paged:
            self._retire_chain(req, self.slot_blocks[slot],
                               int(self.pos[slot]))
            self._set_table(slot, [])

    # ------------------------------------------------------------------
    # prefix-store persistence (warm TTFT across engine restarts)
    # ------------------------------------------------------------------
    def _pool_leaves(self) -> list:
        return [lv for lv, ax in zip(_leaves(self.cache), _leaves(self.axes))
                if ax < 0]

    def _persist_meta(self) -> dict:
        """Prefix-store header: page geometry, a config digest and a
        params fingerprint (every leaf's shape, its torch dtype as
        ``str(dtype)`` gives it, and its first 64 values).  ``load_store`` refuses a store whose
        header differs: page bytes are only valid for the exact config,
        weights and page layout that produced them — and for this
        framework, whose dtype names the fingerprint hashes."""
        cfg_digest = hashlib.sha1(repr(self.cfg).encode()).hexdigest()
        fp = hashlib.sha1()
        for lv in _leaves(self.params):
            fp.update(str((tuple(lv.shape), str(lv.dtype))).encode())
            fp.update(_to_host(lv.reshape(-1)[:64]).tobytes())
        sig = [[[lv.shape[0], *lv.shape[2:]], _dtype_name(lv)]
               for lv in self._pool_leaves()]
        return {"version": PERSIST_VERSION, "config": cfg_digest,
                "params": fp.hexdigest(), "block_size": self.block_size,
                # pins the pool layout legibly in a rejection reason
                "quant_kv": self.scfg.quant_kv if self.quant else None,
                "leaves": sig}

    def _chain_pages_host(self, blocks) -> list[np.ndarray]:
        """One chain's page bytes on the host: one ``(stack,
        n_chain_blocks, block_size, kv...)`` array per pool leaf."""
        ids = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=self.device)
        return [_to_host(lv[:, ids]) for lv in self._pool_leaves()]

    def _spill_chain(self, ns: int, key, n_leaf: int, blocks) -> None:
        """``RadixPrefixCache.on_evict`` hook (persist mode only): take
        an evicted chain's pages to the host before the pool reclaims
        them, so chains evicted under pressure reach the close()-time
        store; capped at one pool's worth of pages."""
        held = sum(blocks_for_tokens(len(k), self.block_size)
                   for _, k, _ in self._spilled)
        if held + len(blocks) > self.pool.num_blocks:
            return
        self._spilled.append((ns, np.asarray(key, np.int64),
                              self._chain_pages_host(blocks)))

    def close(self) -> dict:
        """Write the radix cache's refcount-free chains (plus the
        spilled ones) to ``ServeConfig.prefix_persist_path`` so the next
        engine with this path starts warm.  A no-op without a path or
        without the cache; returns a save summary."""
        path = self.scfg.prefix_persist_path
        if not path or not self.sharable:
            return {"persist_saved_chains": 0, "persist_saved_blocks": 0}
        cand = [(ns, key, ("blocks", blocks))
                for ns, key, blocks in
                dump_chains(self.prefix_cache,
                            max_blocks=self.pool.num_blocks)]
        cand += [(ns, key, ("pages", pages))
                 for ns, key, pages in self._spilled]
        # a chain that is a prefix of another stored chain (or an exact
        # twin, of which the first, hottest, stays) is covered by it:
        # the same tokens give the same K/V bytes.  Dedup before the
        # device pages are gathered.
        chains = []
        for i, (ns, key, payload) in enumerate(cand):
            covered = False
            for j, (n2, k2, _) in enumerate(cand):
                if j == i or n2 != ns or len(key) > len(k2):
                    continue
                if len(key) == len(k2) and j > i:
                    continue                   # equal twins: first wins
                if np.array_equal(key, k2[:len(key)]):
                    covered = True
                    break
            if not covered:
                kind, data = payload
                pages = (self._chain_pages_host(data) if kind == "blocks"
                         else data)
                chains.append((ns, key, pages))
        info = save_store(path, self._persist_meta(), chains)
        return {"persist_saved_chains": info["chains"],
                "persist_saved_blocks": info["blocks"]}

    def _load_prefix_store(self, path: str) -> None:
        """Rehydrate a persisted store at construction: allocate pool
        pages, write the stored bytes into them IN PLACE (one
        ``index_copy_`` per pool leaf; the pool tensors are never
        rebound) and index the chains.  A mismatched or corrupt store is
        rejected (reason in ``persist_rejected``) and the engine starts
        cold."""
        if not os.path.exists(path):
            return
        try:
            chains = load_store(path, self._persist_meta())
        except PrefixStoreError as e:
            self.persist_rejected = str(e)
            return
        pool_leaves = self._pool_leaves()
        # page id -> per-leaf page bytes; the LAST write wins: a page
        # freed mid-load (a dup, or a replaced partial tail) can be
        # re-allocated by a later chain, which then owns it
        pending: dict[int, list[np.ndarray]] = {}
        for ns, key, pages in chains:        # hot-first store order
            nb = blocks_for_tokens(len(key), self.block_size)
            if not self.pool.can_alloc(nb):
                continue
            ids = self.pool.alloc(nb)
            dups = self.prefix_cache.insert(key, ids, namespace=ns)
            nd = len(dups)       # dups are always a PREFIX of ids
            for k in range(nd, nb):
                pending[ids[k]] = [pg[:, k] for pg in pages]
            self.pool.free(dups)
            self.persist_loaded_chains += 1
            self.persist_loaded_blocks += nb - nd
        pending = {bid: v for bid, v in pending.items()
                   if self.pool.refcount(bid) > 0}
        if pending:
            order = list(pending)
            idx = torch.as_tensor(order, dtype=torch.long,
                                  device=self.device)
            for j, leaf in enumerate(pool_leaves):
                chunk = np.stack([pending[b][j] for b in order], axis=1)
                leaf.index_copy_(1, idx, _from_host(chunk, leaf))

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _register_metrics(self) -> dict:
        """Register the serving counters/gauges into the registry and
        return the ``stats()`` map ``{legacy_key: metric_name}`` — the
        JAX engine's keys for the same config (the prefix cache's under
        ``prefix_cache.*`` with the legacy ``prefix_*`` keys)."""
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
        view("cow_forks", "engine.cow_forks", lambda: self.cow_forks)
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
        if self.prefix_cache is not None:
            for k in self.prefix_cache.attach_metrics(m):
                legacy[f"prefix_{k}"] = f"prefix_cache.{k}"
            view("published_frontiers", "engine.published_frontiers",
                 lambda: self.published_frontiers)
            if self.scfg.prefix_persist_path:
                view("persist_loaded_chains", "persist.loaded_chains",
                     lambda: self.persist_loaded_chains)
                view("persist_loaded_blocks", "persist.loaded_blocks",
                     lambda: self.persist_loaded_blocks)
                view("persist_spilled_chains", "persist.spilled_chains",
                     lambda: len(self._spilled))
                view("persist_rejected", "persist.rejected",
                     lambda: self.persist_rejected)
        # wave kinds (registry only): decode waves launch the paged
        # decode read once per layer
        view(None, "engine.decode_waves", lambda: self.decode_waves)
        view(None, "engine.extend_waves", lambda: self.extend_waves)
        return legacy

    def stats(self) -> dict:
        """Pool and prefix-cache observability — a view over the metrics
        registry.  Every call re-checks the pool accounting invariant
        (with a pool)."""
        if self.paged:
            self.pool.assert_consistent()
        return {key: self.metrics.get(name)
                for key, name in self._legacy_stats.items()}

    def _span(self, name: str, **args):
        """Engine-phase span when tracing; a no-op context otherwise (the
        untraced step is the same code)."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, **args)

    def _fence(self, name: str) -> None:
        """Traced only: wait for the device's queued work in a span of
        its own, so a step's device time shows apart from its host
        dispatch and retire.  Value-neutral: the host copy right after
        waits for the same work.  Empty on a CPU engine."""
        if self.tracer is None:
            return
        with self.tracer.span(name):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _revent(self, req: Request, name: str, slot: Optional[int] = None,
                **args) -> None:
        """Per-request lifecycle event (no-op untraced), mirrored onto
        the slot's track when resident, the frontend track otherwise."""
        if self.tracer is not None:
            self.tracer.req_event(
                req.uid, name,
                tid=None if slot is None else SLOT_TID0 + slot, **args)

    def _rtokens(self, req: Request, slot: int, n: int) -> None:
        """Token-retirement stamps, after ``n`` tokens were appended to
        ``req.generated``: ``first_token`` closes the TTFT decomposition,
        ``tokens`` feeds the per-request inter-token series."""
        if self.tracer is None or n <= 0:
            return
        if len(req.generated) == n:
            self._revent(req, "first_token", slot=slot)
        self._revent(req, "tokens", slot=slot, n=n)

    def _slot_begin(self, req: Request, slot: int) -> None:
        """Open the slot-residency span on the slot's track."""
        if self.tracer is not None:
            tid = SLOT_TID0 + slot
            self.tracer.name_track(tid, f"slot{slot}")
            self.tracer.begin(f"u{req.uid}", tid, uid=req.uid)

    def _slot_end(self, slot: int) -> None:
        if self.tracer is not None:
            self.tracer.end(SLOT_TID0 + slot)

    def dump_chrome_trace(self, path: str) -> dict:
        """Write the tracer's Perfetto / chrome://tracing JSON to
        ``path`` (engine phases on one track, one track per slot, a
        ``request_summary`` instant per request with its TTFT
        decomposition).  Requires ``ServeConfig.trace=True``."""
        if self.tracer is None:
            raise ValueError(
                "tracing is off — construct the engine with "
                "ServeConfig(trace=True) to record a trace")
        return self.tracer.dump_chrome_trace(path)

    # ------------------------------------------------------------------

    def cancel(self, uid: int) -> bool:
        """Abort a request — queued, preempted-and-detached, mid-catch-up
        or decoding.  Returns True when it was found (marked
        ``cancelled`` + ``done``, moved to ``self.cancelled``).  A live
        slot's pages below ``pos`` hold a valid chain and retire into the
        radix cache like a finished one (published pages keep their
        cache reference, so in-flight readers are untouched); a queued
        request drops its pinned chain and detached pages.  A slot is
        freed between waves, so no token already delivered is rolled
        back."""
        for i, req in enumerate(self.queue):
            if req.uid != uid:
                continue
            self.queue.pop(i)
            if self.sharable:
                self._release_ctx(req)       # drop a pinned hit chain
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
        self._revent(req, "cancel", n_generated=len(req.generated))
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
        rows are its local rings; a cache without pages is all rows.  A
        speculative engine also saves a copy of the slot's draft row and
        frontier."""
        req = self.slot_req[slot]
        if req is None:
            return None
        self._revent(req, "preempt", slot=slot)
        self._slot_end(slot)
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
            req.saved_state["published"] = self.slot_published[slot]
            self._set_table(slot, [])
        self.active[slot] = False
        self.slot_req[slot] = None
        self.pending[slot] = None
        self.slot_published[slot] = 0
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
