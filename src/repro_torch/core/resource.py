"""Resource manager: device registry with capabilities + dynamic load
(the port's copy of ``repro.core.resource``: pure Python).

Devices *subscribe* to the hub (paper: "subscription and management of
resources in the local edge"), advertise their ``DeviceSpec`` and
channels, heartbeat their availability and report instantaneous load.
The scheduler reads this to match tasks to resources.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.network import Channel, MultiChannelLink
from repro_torch.core.perf_model import DeviceSpec


@dataclass
class DeviceHandle:
    spec: DeviceSpec
    link: MultiChannelLink
    owner: str = "household"
    zone: str = "household"            # trust zone (core.trustzones)
    available: bool = True
    load: float = 0.0                  # 0..1 instantaneous utilisation
    battery: Optional[float] = None    # 0..1, None = mains-powered
    last_heartbeat: float = 0.0
    queue_depth: int = 0

    @property
    def effective_flops(self) -> float:
        return self.spec.peak_flops * max(0.0, 1.0 - self.load)


class DeviceRegistry:
    """The hub's view of every device at this consumer edge."""

    def __init__(self, heartbeat_timeout: float = 30.0):
        self._devices: dict[str, DeviceHandle] = {}
        self.heartbeat_timeout = heartbeat_timeout

    # -- subscription ---------------------------------------------------
    def register(self, name: str, handle: DeviceHandle) -> None:
        self._devices[name] = handle

    def unregister(self, name: str) -> None:
        self._devices.pop(name, None)

    def heartbeat(self, name: str, now: float, *, load: float = None,
                  battery: float = None) -> None:
        h = self._devices[name]
        h.last_heartbeat = now
        h.available = True
        if load is not None:
            h.load = load
        if battery is not None:
            h.battery = battery

    def sweep(self, now: float) -> list[str]:
        """Mark devices that missed heartbeats unavailable; return them."""
        lost = []
        for name, h in self._devices.items():
            if h.available and now - h.last_heartbeat > self.heartbeat_timeout:
                h.available = False
                lost.append(name)
        return lost

    # -- queries ----------------------------------------------------------
    def get(self, name: str) -> DeviceHandle:
        return self._devices[name]

    def __contains__(self, name: str) -> bool:
        return name in self._devices

    def names(self) -> list[str]:
        return list(self._devices)

    def available(self, *, zone: Optional[str] = None,
                  train_capable: Optional[bool] = None,
                  min_memory: float = 0.0) -> list[str]:
        out = []
        for name, h in self._devices.items():
            if not h.available:
                continue
            if zone is not None and h.zone != zone:
                continue
            if train_capable is not None and \
                    h.spec.train_capable != train_capable:
                continue
            if h.spec.memory_bytes < min_memory:
                continue
            out.append(name)
        return out

    def least_loaded(self, candidates: Optional[list[str]] = None) -> str:
        names = candidates if candidates is not None else self.available()
        if not names:
            raise RuntimeError("no available devices")
        return min(names, key=lambda n: self._devices[n].load)
