"""Preemptive multi-tenant task scheduler (discrete-event) and the
admission helpers the serving engine ranks by (the port's copy of
``repro.core.scheduler``: pure Python).

Implements the hub scheduler of Fig. 5a: per-device queues, task
priorities, deadlines with preemption ("the upscaling of live streaming
video ... higher priority than the classification of newly acquired
gallery photos").  Policies: fifo | priority | edf.  ``admission_rank``
is the one QoE policy definition, shared with the serving engine's
queue; ``plan_wave`` budgets the per-wave token widths of a mixed
admit/decode frontier; ``quantile_higher`` is the ceil-based tail
quantile reports use.

Deterministic discrete-event simulation: the same workload always
produces the same schedule, which the QoE benchmark and the property
tests rely on.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.perf_model import Estimate, TaskCost


@dataclass
class AITask:
    uid: int
    kind: str                        # "inference" | "training" | "stream"
    duration_s: float                # execution time on assigned device
    device: str
    priority: int = 0                # higher = more urgent
    deadline: Optional[float] = None  # absolute sim time
    arrival: float = 0.0
    preemptible: bool = True
    owner: str = "user"
    # bookkeeping
    remaining_s: float = field(default=None)
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0

    def __post_init__(self):
        if self.remaining_s is None:
            self.remaining_s = self.duration_s

    @property
    def missed_deadline(self) -> bool:
        return (self.deadline is not None and self.finish_time is not None
                and self.finish_time > self.deadline + 1e-9)


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


def _rank(policy: str, task: AITask, now: float):
    del now  # rank is currently time-invariant; kept for call-site compat
    return admission_rank(policy, priority=task.priority,
                          arrival=task.arrival, deadline=task.deadline,
                          uid=task.uid)


@dataclass
class _DeviceState:
    running: Optional[AITask] = None
    run_started: float = 0.0
    queue: list = field(default_factory=list)  # heap of (rank, uid, task)


class EdgeScheduler:
    """Event-driven preemptive scheduler across registered devices."""

    def __init__(self, policy: str = "priority"):
        self.policy = policy
        self._dev: dict[str, _DeviceState] = {}
        self._events: list = []      # (time, seq, kind, payload)
        self._seq = itertools.count()
        self.now = 0.0
        self.completed: list[AITask] = []
        self.trace: list[tuple] = []  # (time, event, task_uid, device)

    # ------------------------------------------------------------------
    def submit(self, task: AITask) -> None:
        heapq.heappush(self._events,
                       (task.arrival, next(self._seq), "arrive", task))

    def _dstate(self, device: str) -> _DeviceState:
        return self._dev.setdefault(device, _DeviceState())

    def _start(self, device: str, task: AITask) -> None:
        ds = self._dstate(device)
        ds.running = task
        ds.run_started = self.now
        if task.start_time is None:
            task.start_time = self.now
        heapq.heappush(self._events,
                       (self.now + task.remaining_s, next(self._seq),
                        "finish", (device, task)))
        self.trace.append((self.now, "start", task.uid, device))

    def _enqueue(self, device: str, task: AITask) -> None:
        ds = self._dstate(device)
        heapq.heappush(ds.queue,
                       (_rank(self.policy, task, self.now), task.uid, task))

    def _maybe_preempt(self, device: str, incoming: AITask) -> bool:
        ds = self._dstate(device)
        cur = ds.running
        if cur is None or not cur.preemptible or self.policy == "fifo":
            return False
        if _rank(self.policy, incoming, self.now) >= \
                _rank(self.policy, cur, self.now):
            return False
        # stop the running task, bank its progress, requeue it
        done = self.now - ds.run_started
        cur.remaining_s = max(0.0, cur.remaining_s - done)
        cur.preemptions += 1
        ds.running = None
        self.trace.append((self.now, "preempt", cur.uid, device))
        self._enqueue(device, cur)
        self._start(device, incoming)
        return True

    def _dispatch(self, device: str) -> None:
        ds = self._dstate(device)
        if ds.running is None and ds.queue:
            _, _, task = heapq.heappop(ds.queue)
            self._start(device, task)

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf) -> list[AITask]:
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if t > until:
                break
            self.now = t
            if kind == "arrive":
                task: AITask = payload
                if not self._maybe_preempt(task.device, task):
                    self._enqueue(task.device, task)
                    self._dispatch(task.device)
            elif kind == "finish":
                device, task = payload
                ds = self._dstate(device)
                if ds.running is not task:
                    continue  # stale finish event (task was preempted)
                elapsed = self.now - ds.run_started
                if elapsed + 1e-12 < task.remaining_s:
                    continue  # stale (preempted + restarted)
                task.remaining_s = 0.0
                task.finish_time = self.now
                ds.running = None
                self.completed.append(task)
                self.trace.append((self.now, "finish", task.uid, device))
                self._dispatch(device)
        return self.completed

    # -- metrics ----------------------------------------------------------
    def qoe_report(self) -> dict:
        done = self.completed
        if not done:
            return {"completed": 0}
        waits = [t.start_time - t.arrival for t in done]
        lats = [t.finish_time - t.arrival for t in done]
        misses = [t for t in done if t.missed_deadline]
        return {
            "completed": len(done),
            "mean_wait_s": sum(waits) / len(done),
            "p99_latency_s": quantile_higher(lats, 0.99),
            "mean_latency_s": sum(lats) / len(done),
            "deadline_misses": len(misses),
            "miss_rate": len(misses) / len(done),
            "preemptions": sum(t.preemptions for t in done),
        }
