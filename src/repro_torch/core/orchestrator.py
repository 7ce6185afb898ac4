"""The Orchestrator (paper Fig. 5a): resource manager + scheduler +
performance controller + task controllers, composed (the port's copy of
``repro.core.orchestrator``: pure Python over the port's modules).

Responsibilities implemented here:
  * task placement — trust-zone filter, then latency-optimal device from
    the performance controller (analytical roofline + historical EWMA),
    network transfer priced through each device's multi-channel link;
  * QoE scheduling — priorities/deadlines/preemption via EdgeScheduler;
  * fault tolerance — tasks on a failed device are transparently
    re-placed and re-executed;
  * split offloading — inference can be cut between device and hub
    (core.split) when that beats either endpoint alone.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import split as split_mod
from repro_torch.core import trustzones as tz
from repro_torch.core.perf_model import (
    DeviceSpec,
    HistoricalEstimator,
    TaskCost,
    estimate,
    inference_cost,
    training_cost,
)
from repro_torch.core.resource import DeviceHandle, DeviceRegistry
from repro_torch.core.scheduler import AITask, EdgeScheduler


@dataclass
class TaskSpec:
    """What a user/app asks for (hardware-independent)."""
    kind: str                          # "inference" | "training" | "stream"
    model: ModelConfig
    batch: int = 1
    seq: int = 128
    priority: int = 0
    deadline_rel: Optional[float] = None   # seconds after arrival
    arrival: float = 0.0
    data: Optional[tz.DataItem] = None
    source_device: Optional[str] = None    # where the input lives
    allow_split: bool = False
    weight_bits: int = 16


@dataclass
class Placement:
    device: str
    latency_s: float
    energy_j: float
    transfer_s: float
    split: Optional[split_mod.SplitDecision] = None


class Orchestrator:
    def __init__(self, registry: DeviceRegistry, hub_device: str,
                 policy: str = "priority",
                 zone_policy: Optional[tz.ZonePolicy] = None):
        self.registry = registry
        self.hub_device = hub_device
        self.scheduler = EdgeScheduler(policy=policy)
        self.history = HistoricalEstimator()
        self.zone_policy = zone_policy or tz.ZonePolicy()
        self._uids = itertools.count()
        self._task_meta: dict[int, tuple[TaskSpec, Placement]] = {}

    # ------------------------------------------------------------------
    def _candidates(self, spec: TaskSpec) -> list[str]:
        train = True if spec.kind == "training" else None
        names = self.registry.available(train_capable=train)
        if spec.data is not None:
            allowed = []
            for n in names:
                h = self.registry.get(n)
                if tz.allowed(spec.data, n, h.zone, h.owner,
                              self.zone_policy):
                    allowed.append(n)
            names = allowed
        return names

    def _cost(self, spec: TaskSpec) -> TaskCost:
        if spec.kind == "training":
            return training_cost(spec.model, spec.batch, spec.seq)
        return inference_cost(spec.model, spec.batch, spec.seq,
                              weight_bits=spec.weight_bits)

    def place(self, spec: TaskSpec) -> Placement:
        """Performance-controller placement: min-latency feasible device."""
        cost = self._cost(spec)
        best: Optional[Placement] = None
        for name in self._candidates(spec):
            h = self.registry.get(name)
            hist = self.history.predict(self._task_kind(spec), name)
            est = estimate(cost, h.spec)
            if not est.fits_memory:
                continue
            compute_s = hist if hist is not None else est.latency_s
            # queueing delay proxy: deeper queues wait longer
            compute_s *= (1.0 + 0.25 * h.queue_depth)
            transfer_s = 0.0
            if spec.source_device and spec.source_device != name:
                transfer_s = h.link.send(cost.transfer_bytes).latency_s
            total = compute_s + transfer_s
            cand = Placement(name, total, est.energy_j, transfer_s)
            if best is None or cand.latency_s < best.latency_s:
                best = cand

        # consider split execution device<->hub for inference
        if (spec.allow_split and spec.source_device
                and spec.kind == "inference"
                and spec.model.pattern_period <= 1
                and spec.source_device in self.registry
                and self.hub_device in self.registry):
            dev = self.registry.get(spec.source_device)
            hub = self.registry.get(self.hub_device)
            dec = split_mod.choose_split(spec.model, dev.spec, hub.spec,
                                         dev.link, spec.batch, spec.seq)
            if best is None or dec.total_s < best.latency_s:
                best = Placement(self.hub_device, dec.total_s, 0.0,
                                 dec.transfer_s, split=dec)
        if best is None:
            raise RuntimeError(
                f"no feasible device for task {spec.kind} "
                f"(zone={getattr(spec.data, 'zone', None)})")
        return best

    @staticmethod
    def _task_kind(spec: TaskSpec) -> str:
        return f"{spec.kind}:{spec.model.name}:{spec.batch}x{spec.seq}"

    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> int:
        placement = self.place(spec)
        uid = next(self._uids)
        deadline = (spec.arrival + spec.deadline_rel
                    if spec.deadline_rel is not None else None)
        task = AITask(uid=uid, kind=spec.kind,
                      duration_s=placement.latency_s,
                      device=placement.device, priority=spec.priority,
                      deadline=deadline, arrival=spec.arrival)
        self.registry.get(placement.device).queue_depth += 1
        self.scheduler.submit(task)
        self._task_meta[uid] = (spec, placement)
        return uid

    def run(self, until: float = math.inf) -> dict:
        done = self.scheduler.run(until)
        for t in done:
            spec, placement = self._task_meta[t.uid]
            self.registry.get(placement.device).queue_depth = max(
                0, self.registry.get(placement.device).queue_depth - 1)
            self.history.observe(self._task_kind(spec), placement.device,
                                 t.finish_time - t.start_time)
        return self.scheduler.qoe_report()

    # -- fault tolerance --------------------------------------------------
    def fail_device(self, name: str) -> list[int]:
        """Device dropped out: re-place its unfinished tasks elsewhere.

        Returns the uids of re-placed tasks.
        """
        self.registry.get(name).available = False
        moved = []
        finished = {t.uid for t in self.scheduler.completed}
        for uid, (spec, placement) in list(self._task_meta.items()):
            if placement.device != name or uid in finished:
                continue
            respec = TaskSpec(**{**spec.__dict__,
                                 "arrival": self.scheduler.now})
            new_uid = self.submit(respec)
            moved.append(new_uid)
        return moved
