"""Speculative decoding: draft/verify serving over the paged KV cache
(PyTorch port of ``repro.serving.spec_decode``).

A cheap DRAFT model proposes ``gamma - 1`` tokens per slot, the big
VERIFY model scores all of them in ONE paged forward
(``model.extend_paged``), and acceptance keeps the proposals the verify
model agrees with.  One round, per slot (the engine batches it across
slots), with ``t0`` the slot's pending token and ``pos`` its frontier:

1. **Propose.**  ``gamma`` batched draft ``decode_step``s against the
   draft's own dense cache: feed ``t0`` -> ``d_1``, feed ``d_1`` ->
   ``d_2``, ...; the last step's sample is discarded, it only leaves
   K/V for every token the verify feed contains.
2. **Verify.**  One ``extend_paged`` over ``[t0, d_1..d_{v-1}]``: row
   ``i - 1`` judges ``d_i`` and row ``v - 1`` yields the bonus token.
3. **Accept** (``accept_proposals``): greedy keeps ``d_i`` while it
   equals the verify argmax (tokens bit-identical to vanilla greedy
   decode); at temperature > 0 the standard rejection-sampling rule,
   whose emitted distribution equals vanilla sampling from the verify
   model.  Always ``n_accepted + 1`` tokens.
4. **Roll back.**  Rejected writes sit above the new frontier, where
   every later read masks them: rollback is bookkeeping (the engine's
   ``_truncate_slot``; the draft's ``advance``).

The draft's fidelity moves only the acceptance rate, never the emitted
tokens: correctness is the verify model's alone.  Self-draft mode
(``make_self_draft``) is the verify model's own first layers under an
early-exit head, sharing its embeddings and stacked trunk by reference.

Differences from the JAX module: the draft cache is updated in place,
and ``SpecDecoder`` routes its forward calls through ``_prefill`` and
``_decode`` (a caller may wrap them to count them).  Only token-only
dense drafts are ported: the engine refuses requests with extras.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device, tensor_device
from repro_torch.models import model as M

Params = dict


# ---------------------------------------------------------------------------
# host-side sampling / acceptance (shared with the engine)
# ---------------------------------------------------------------------------

def processed_dist(logits: np.ndarray, temp: float, top_k: int) -> np.ndarray:
    """The serving sampling distribution: top-k filter, then temperature
    softmax, in float64."""
    lg = np.asarray(logits, np.float64)
    if top_k and top_k > 0:
        thresh = np.sort(lg)[::-1][min(top_k, lg.size) - 1]
        lg = np.where(lg < thresh, -np.inf, lg)
    lg = lg / max(temp, 1e-6)
    lg -= lg.max()
    p = np.exp(lg)
    return p / p.sum()


def sample_from_logits(logits: np.ndarray, temp: float, top_k: int,
                       rng) -> int:
    """Greedy argmax at temp<=0, else a draw from ``processed_dist``."""
    if temp <= 0:
        return int(np.argmax(logits))
    p = processed_dist(logits, temp, top_k)
    return int(rng.choice(p.size, p=p))


def accept_greedy(proposals, argmax_row):
    """Greedy acceptance from per-row verify argmax ids alone.
    argmax_row: (>= len(proposals) + 1,) ids.  Returns ``(n_accepted,
    emitted)`` with ``len(emitted) == n_accepted + 1``."""
    emitted: list[int] = []
    for i, d in enumerate(proposals):
        if int(argmax_row[i]) != int(d):
            emitted.append(int(argmax_row[i]))
            return i, emitted
        emitted.append(int(d))
    emitted.append(int(argmax_row[len(proposals)]))
    return len(proposals), emitted


def accept_proposals(proposals, draft_dists, verify_logits: np.ndarray,
                     temp: float, top_k: int, rng):
    """Judge draft proposals against the verify logits of one round.

    proposals: ``v-1`` draft tokens; draft_dists: their sampling
    distributions (None entries in greedy mode); verify_logits: (v, V),
    row ``i-1`` judges ``d_i`` and row ``v-1`` yields the bonus after a
    clean sweep.  Greedy (temp<=0): accept while ``d_i == argmax``.
    Sampling: accept ``d_i`` with probability ``min(1, q/p)``, else emit
    a draw from ``normalize(max(q - p, 0))`` and stop.  Returns
    ``(n_accepted, emitted)`` with ``len(emitted) == n_accepted + 1``.
    """
    if temp <= 0:
        return accept_greedy(proposals, np.argmax(verify_logits, axis=-1))
    emitted: list[int] = []
    n_acc = 0
    for i, d in enumerate(proposals):
        q = processed_dist(verify_logits[i], temp, top_k)
        p = draft_dists[i]
        if rng.random() < min(1.0, float(q[d]) / max(float(p[d]), 1e-300)):
            emitted.append(int(d))
            n_acc += 1
            continue
        res = np.clip(q - p, 0.0, None)
        s = res.sum()
        probs = res / s if s > 0 else q
        emitted.append(int(rng.choice(probs.size, p=probs)))
        return n_acc, emitted
    # clean sweep: the last verify row is a free token
    emitted.append(sample_from_logits(verify_logits[len(proposals)],
                                      temp, top_k, rng))
    return n_acc, emitted


# ---------------------------------------------------------------------------
# draft construction / validation
# ---------------------------------------------------------------------------

def make_self_draft(cfg: ModelConfig, params: Params, exit_layers: int = 0):
    """Self-draft: the verify model's first ``exit_layers`` layers (default
    half) under an early-exit head (``core.earlyexit.init_exit_heads``).
    The draft params reference the verify model's embedding tables AND
    its full stacked trunk (the same tensors, no copy); the draft
    config's smaller ``num_layers`` makes the trunk loop stop early, so
    only the exit head's norm is new memory.  Uniform dense stacks only
    (``pattern_period <= 1``).  Returns ``(draft_cfg, draft_params)``.
    """
    from repro_torch.core.earlyexit import init_exit_heads
    if cfg.family not in ("dense", "vlm") or cfg.pattern_period > 1:
        raise ValueError(
            f"self-draft targets uniform dense/vlm stacks, not "
            f"{cfg.name} (family={cfg.family}, "
            f"pattern_period={cfg.pattern_period}); pass an explicit "
            "draft or a registry draft_arch instead")
    e = exit_layers or max(1, cfg.num_layers // 2)
    if not 1 <= e < cfg.num_layers:
        raise ValueError(f"exit_layers {e} outside [1, {cfg.num_layers})")
    heads = init_exit_heads(cfg, [e - 1], device=tensor_device(params))
    draft_params = dict(params)
    draft_params["trunk"] = params["trunk"]     # full stack, BY REFERENCE
    draft_params["final_norm"] = heads["exits"][0]["ln"]
    return cfg.replace(name=f"{cfg.name}-selfdraft@{e}", num_layers=e), \
        draft_params


def validate_spec(cfg: ModelConfig, draft_cfg: ModelConfig, gamma: int,
                  max_len: int) -> list[str]:
    """Draft/verify compatibility findings (empty list = compatible):
    vocab match, same-family extras, verify-side ``spec_decodable``,
    gamma bounds."""
    problems = []
    if draft_cfg.vocab_size != cfg.vocab_size:
        problems.append(
            f"vocab mismatch: draft {draft_cfg.name} has "
            f"{draft_cfg.vocab_size}, verify {cfg.name} has "
            f"{cfg.vocab_size} — proposals would index a different "
            "token space")
    if (draft_cfg.family in ("vlm", "encdec")
            and draft_cfg.family != cfg.family):
        problems.append(
            f"draft {draft_cfg.name} (family={draft_cfg.family}) "
            "prefills from non-token extras "
            f"({'image' if draft_cfg.family == 'vlm' else 'audio'} "
            "embeds) that requests for a "
            f"{cfg.family} verify model do not carry — only a "
            "same-family draft can reuse them")
    if not M.spec_decodable(cfg):
        problems.append(
            f"verify model {cfg.name} (family={cfg.family}, "
            f"pattern_period={cfg.pattern_period}) is not spec_decodable:"
            " its decode state cannot roll back a rejected speculation")
    lo, hi = 2, max(2, max_len // 4)
    if not lo <= gamma <= hi:
        problems.append(
            f"spec_gamma {gamma} outside [{lo}, {hi}] (needs >=1 real "
            f"proposal per round and <= max_len/4 = {hi} so a round "
            "cannot span a quarter of the context)")
    return problems


# ---------------------------------------------------------------------------
# the draft runtime
# ---------------------------------------------------------------------------

class SpecDecoder:
    """Draft-model runtime for one engine: a dense decode cache with one
    row per engine slot (updated in place), batched admission prefill
    over FULL prompts, and the per-round proposal loop.

    ``draft_pos[slot]`` counts the cache positions holding committed
    context (prompt plus emitted tokens; the engine's pending
    ``tokens[slot]`` is not yet written on either side).  One round
    writes the whole verify feed; ``advance(slot, n_acc + 1)`` moves the
    frontier past the fed tokens that became context, and rejected
    writes stay above it, masked.
    """

    def __init__(self, draft_cfg: ModelConfig, draft_params: Params,
                 max_slots: int, max_len: int, device: DeviceLike = None):
        from repro_torch.serving.engine import cache_batch_axes
        self.cfg = draft_cfg
        self.params = draft_params
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = M.init_cache(draft_cfg, max_slots, max_len,
                                  device=self.device)
        self.axes = cache_batch_axes(draft_cfg, max_len)
        self.draft_pos = np.zeros((max_slots,), np.int32)

    @property
    def prefix(self) -> int:
        """Positions before the prompt in the draft's cache: the image
        tokens of a vlm draft, which the port does not serve yet (A.9.2),
        so 0."""
        return 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode(self, tokens, pos, need_logits: bool = False):
        """One draft step (the draft cache updated in place).  Greedy
        rounds bring only the (B,) argmax ids to the host; the (B, V)
        logits come too when some drafting slot samples."""
        logits, self.cache = M.decode_step(self.cfg, self.params, self.cache,
                                           tokens, pos)
        logits = logits[:, -1].float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return (greedy.cpu().numpy(),
                logits.cpu().numpy() if need_logits else None)

    def _prefill(self, tokens, true_len):
        """Draft prefill of ``m`` right-padded prompt rows: a dense
        m-row cache sized ``max_len``."""
        _, rows = M.prefill(self.cfg, self.params, {"tokens": tokens},
                            self.max_len, true_len=true_len)
        return rows

    # -- admission ------------------------------------------------------
    def admit_group(self, reqs, slots) -> None:
        """Batched draft prefill of the FULL prompts of one admission
        group, inserted row-wise at ``slots``.  Prompts are padded (with
        their last token) to a shared power-of-two bucket; ``true_len``
        keeps the padding out of the cache."""
        from repro_torch.serving.engine import extract_slot, insert_slot
        m = len(reqs)
        n_max = max(len(r.prompt) for r in reqs)
        bucket = 1 << (n_max - 1).bit_length() if n_max > 1 else 1
        bucket = min(bucket, self.max_len)     # prompts are < max_len
        prompts = np.zeros((m, bucket), np.int32)
        true_len = np.zeros((m,), np.int32)
        for i, r in enumerate(reqs):
            p = np.asarray(r.prompt, np.int32)
            prompts[i, :len(p)] = p
            prompts[i, len(p):] = p[-1]
            true_len[i] = len(p)
        rows = self._prefill(self._tensor(prompts), self._tensor(true_len))
        for i, slot in enumerate(slots):
            insert_slot(self.cache, extract_slot(rows, i, self.axes), slot,
                        self.axes)
            self.draft_pos[slot] = int(true_len[i])

    # -- proposals ------------------------------------------------------
    def propose(self, spec_slots, seeds, temps, topks, gamma: int, rng):
        """``gamma`` batched draft steps.  spec_slots: slot ids drafting
        this round; the other slots ride along writing token 0 at their
        own frontier (clipped to ``max_len - 1``), which the next real
        token overwrites before any read.  Returns ``(proposals,
        dists)``: per spec slot, ``gamma - 1`` proposal tokens and their
        sampling distributions (None in greedy mode)."""
        B = self.max_slots
        spec = np.zeros((B,), bool)
        spec[list(spec_slots)] = True
        fed = np.zeros((B, 1), np.int32)
        proposals = {s: [] for s in spec_slots}
        dists = {s: [] for s in spec_slots}
        for s in spec_slots:
            fed[s, 0] = seeds[s]
        need_logits = bool(any(temps[s] > 0 for s in spec_slots))
        for step in range(gamma):
            pos = np.where(spec, self.draft_pos + step, self.draft_pos)
            pos = np.minimum(pos, self.max_len - 1).astype(np.int32)
            greedy, logits = self._decode(self._tensor(fed),
                                          self._tensor(pos),
                                          need_logits=need_logits)
            for s in spec_slots:
                if step == gamma - 1:
                    continue          # last step only writes K/V
                temp, top_k = float(temps[s]), int(topks[s])
                if temp <= 0:
                    tok = int(greedy[s])
                    dists[s].append(None)
                else:
                    p = processed_dist(logits[s], temp, top_k)
                    tok = int(rng.choice(p.size, p=p))
                    dists[s].append(p)
                proposals[s].append(tok)
                fed[s, 0] = tok
        return proposals, dists

    def advance(self, slot: int, n_committed: int) -> None:
        """Move the slot's frontier past the round's committed writes
        (``n_accepted + 1`` fed tokens became context)."""
        self.draft_pos[slot] = min(self.draft_pos[slot] + n_committed,
                                   self.max_len - 1)

    # -- preemption -----------------------------------------------------
    def extract(self, slot: int) -> dict:
        """Detach the slot's draft state (a copy) for
        ``Request.saved_state``."""
        from repro_torch.serving.engine import extract_slot
        return {"cache": extract_slot(self.cache, slot, self.axes),
                "pos": int(self.draft_pos[slot])}

    def insert(self, slot: int, state: Optional[dict]) -> None:
        """Restore a preempted slot's draft state; with ``None`` the row
        keeps its stale content and the frontier resets to 0 —
        proposals degrade, emitted tokens do not."""
        from repro_torch.serving.engine import insert_slot
        if state is None:
            self.draft_pos[slot] = 0
            return
        insert_slot(self.cache, state["cache"], slot, self.axes)
        self.draft_pos[slot] = state["pos"]
