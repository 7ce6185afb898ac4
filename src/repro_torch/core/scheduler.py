"""Admission ordering and wave planning (PyTorch port's copy of the
pure-Python helpers in ``repro.core.scheduler``).

``admission_rank`` is the one QoE policy definition (fifo | priority |
edf) the serving engine ranks its queue by; ``plan_wave`` budgets the
per-wave token widths of a mixed admit/decode frontier;
``quantile_higher`` is the ceil-based tail quantile reports use.  The
discrete-event ``EdgeScheduler`` of the hub is a later slice.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.unported import not_ported

HUB_ITEM = "A.10 (core)"


def quantile_higher(values, q: float) -> float:
    """Ceil-based sample quantile: ``sorted(values)[ceil(q*(n-1))]`` —
    identical to ``np.percentile(values, 100*q, method="higher")``.

    The previous p99 used ``int(0.99*n) - 1``, which is biased LOW for
    small samples (n=2 reported the *minimum* latency as "p99"); a tail
    quantile must round up, never down.
    """
    if not values:
        raise ValueError("quantile of empty sample")
    s = sorted(values)
    return s[min(len(s) - 1, math.ceil(q * (len(s) - 1)))]


def admission_rank(policy: str, *, priority: int = 0, arrival: float = 0.0,
                   deadline: Optional[float] = None, uid: int = 0):
    """QoE ordering key (lower sorts first) — the ONE policy definition
    shared by this discrete-event scheduler and the serving engine's
    admission queue (serving.engine), so simulated schedules and the
    real continuous-batching runtime agree on who goes next.
    """
    if policy == "fifo":
        return (arrival, uid)
    if policy == "priority":
        return (-priority, arrival, uid)
    if policy == "edf":
        dl = deadline if deadline is not None else math.inf
        return (dl, -priority, uid)
    raise ValueError(policy)


def plan_wave(policy: str, entries, budget: Optional[int] = None,
              metrics=None) -> dict:
    """Per-wave token widths for a live mixed admit/decode frontier.

    ``entries``: dicts with ``id`` (slot), ``want`` (the width the slot
    would naturally take this wave: 1 for a plain decode, up to the
    chunk width for prompt catch-up, up to gamma for a speculative
    round) plus the ``admission_rank`` QoE fields (``priority`` /
    ``arrival`` / ``deadline`` / ``uid``).

    Allocation under ``budget`` (total tokens this wave may score):
    every entry is granted width 1 first — an admitted slot always
    advances, so a saturated wave degrades to plain continuous batching
    instead of starving anyone — then the remaining budget is granted
    best-rank-first up to each entry's ``want``.  ``budget=None``
    disables the cap (every slot takes its natural width).  Returns
    ``{id: width}``.

    ``metrics``: optional ``serving.telemetry.MetricsRegistry`` —
    budgeted plans record the wave's budget utilization (granted /
    budget, ``sched.budget_utilization`` histogram) and count demoted
    slots (granted < wanted, ``sched.demotions``) so QoE pressure is
    visible without sampling ``engine.last_plan``.

    Width is deliberately the only lever: shrinking a catch-up or
    speculative span never changes the tokens a request emits (chunked
    teacher-forcing and speculative acceptance are both
    schedule-invariant), so QoE shaping here cannot cause token drift.
    """
    if budget is None:
        return {e["id"]: max(1, int(e["want"])) for e in entries}
    order = sorted(entries, key=lambda e: admission_rank(
        policy, priority=e.get("priority", 0),
        arrival=e.get("arrival", 0.0), deadline=e.get("deadline"),
        uid=e.get("uid", 0)))
    widths = {e["id"]: 1 for e in order}
    left = max(0, int(budget) - len(order))
    for e in order:
        if left <= 0:
            break
        extra = min(max(1, int(e["want"])) - 1, left)
        widths[e["id"]] += extra
        left -= extra
    if metrics is not None and entries:
        metrics.histogram("sched.budget_utilization",
                          (0.25, 0.5, 0.75, 0.9, 1.0)).observe(
            sum(widths.values()) / max(int(budget), 1))
        demoted = sum(1 for e in entries
                      if widths[e["id"]] < max(1, int(e["want"])))
        if demoted:
            metrics.counter("sched.demotions").inc(demoted)
    return widths


# the hub's discrete-event scheduler (A.10)
AITask = not_ported("repro.core.scheduler.AITask", HUB_ITEM)
EdgeScheduler = not_ported("repro.core.scheduler.EdgeScheduler", HUB_ITEM)
Estimate = not_ported("repro.core.scheduler.Estimate", HUB_ITEM)
TaskCost = not_ported("repro.core.scheduler.TaskCost", HUB_ITEM)
