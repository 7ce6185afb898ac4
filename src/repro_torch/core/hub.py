"""EdgeAIHub facade: one object wiring the paper's whole stack together
(PyTorch port of ``repro.core.hub``).

registry (resource manager) + orchestrator (scheduler/controllers) +
serving engine(s) + federated coordinator + shared-context space.
Examples and integration tests drive this.  The engines it deploys run
on the card unless the caller passes another ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trustzones as tz
from repro_torch.core.network import CHANNEL_CATALOGUE, MultiChannelLink
from repro_torch.core.orchestrator import Orchestrator, TaskSpec
from repro_torch.core.perf_model import DEVICE_CATALOGUE
from repro_torch.core.resource import DeviceHandle, DeviceRegistry
from repro_torch.devices import DeviceLike
from repro_torch.serving.engine import EdgeServingEngine, Request, ServeConfig
from repro_torch.training import federated as fed


def default_home(hub_name: str = "hub") -> DeviceRegistry:
    """A representative smart home: hub + phones + TV + wearable + IoT."""
    reg = DeviceRegistry()
    wifi = [CHANNEL_CATALOGUE["wifi6"]]
    multi = [CHANNEL_CATALOGUE["wifi6"], CHANNEL_CATALOGUE["uwb"]]
    ble = [CHANNEL_CATALOGUE["ble"]]
    zig = [CHANNEL_CATALOGUE["zigbee"]]

    def dev(cat, link, zone="household", owner="alice"):
        return DeviceHandle(spec=DEVICE_CATALOGUE[cat],
                            link=MultiChannelLink(link),
                            zone=zone, owner=owner)

    reg.register(hub_name, dev("edgeai-hub", multi))
    reg.register("alice-phone", dev("flagship-phone", wifi,
                                    zone="personal", owner="alice"))
    reg.register("bob-phone", dev("mid-phone", wifi,
                                  zone="personal", owner="bob"))
    reg.register("living-room-tv", dev("smart-tv", wifi))
    reg.register("alice-watch", dev("wearable", ble,
                                    zone="personal", owner="alice"))
    reg.register("door-sensor", dev("iot-sensor", zig))
    reg.register("vacuum", dev("robot-vacuum", wifi))
    reg.register("bob-old-phone", dev("old-phone", wifi,
                                      zone="household", owner="bob"))
    return reg


@dataclass
class EdgeAIHub:
    registry: DeviceRegistry
    orchestrator: Orchestrator
    hub_device: str = "hub"
    engines: dict = field(default_factory=dict)

    @classmethod
    def create(cls, hub_name: str = "hub", policy: str = "priority"):
        reg = default_home(hub_name)
        orch = Orchestrator(reg, hub_device=hub_name, policy=policy)
        return cls(registry=reg, orchestrator=orch, hub_device=hub_name)

    # -- serving ----------------------------------------------------------
    def deploy_model(self, name: str, cfg: ModelConfig, params,
                     scfg: Optional[ServeConfig] = None,
                     device: DeviceLike = None) -> EdgeServingEngine:
        """An engine for ``params`` on ``device`` (default ``cuda``, where
        the params must lie), registered under ``name``."""
        eng = EdgeServingEngine(cfg, params, scfg or ServeConfig(),
                                device=device)
        self.engines[name] = eng
        return eng

    def serve(self, name: str, req: Request) -> None:
        self.engines[name].submit(req)

    # -- federated rounds (orchestrator picks eligible clients) -----------
    def federated_round(self, cfg: ModelConfig, fcfg: fed.FedConfig, params,
                        client_data: dict, data_item: tz.DataItem,
                        round_idx: int = 0):
        devices = {n: (self.registry.get(n).zone, self.registry.get(n).owner)
                   for n in self.registry.available()}
        eligible = tz.filter_devices(data_item, devices)
        chosen = {n: client_data[n] for n in sorted(client_data)
                  if n in eligible}
        if not chosen:
            raise tz.AccessError("no trust-zone-eligible clients")
        return fed.fed_round(cfg, fcfg, params,
                             {i: v for i, v in enumerate(chosen.values())},
                             round_idx)

    # -- task submission ----------------------------------------------------
    def submit(self, spec: TaskSpec) -> int:
        return self.orchestrator.submit(spec)

    def run(self, until: float = float("inf")) -> dict:
        return self.orchestrator.run(until)
