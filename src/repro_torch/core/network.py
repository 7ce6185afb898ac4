"""Multi-channel consumer-edge network model + load balancer
(the port's copy of ``repro.core.network``: pure Python).

The paper's networking pillar: the hub speaks many protocols at once
(Wi-Fi / BLE / Zigbee / UWB / 5G), load-balances transfers across
channels and slices bandwidth per-tenant for QoE.  Deterministic
analytical model — the discrete-event scheduler prices every transfer
through this.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class Channel:
    name: str
    bandwidth_bps: float     # usable application-layer throughput (bits/s)
    latency_s: float         # one-way propagation + stack latency
    loss_rate: float = 0.0   # retransmission overhead fraction
    energy_per_bit: float = 10e-9  # J/bit on the device side


CHANNEL_CATALOGUE = {
    "wifi6": Channel("wifi6", 600e6, 2e-3, 0.01, 5e-9),
    "wifi-legacy": Channel("wifi-legacy", 50e6, 5e-3, 0.03, 8e-9),
    "ble": Channel("ble", 1.4e6, 15e-3, 0.02, 2e-9),
    "zigbee": Channel("zigbee", 0.2e6, 20e-3, 0.02, 1.5e-9),
    "uwb": Channel("uwb", 27e6, 1e-3, 0.01, 4e-9),
    "5g-local": Channel("5g-local", 200e6, 8e-3, 0.01, 12e-9),
    "ethernet": Channel("ethernet", 1e9, 0.5e-3, 0.0, 3e-9),
}


@dataclass
class Transfer:
    bytes: float
    latency_s: float
    energy_j: float
    channels: tuple


def transfer_time(nbytes: float, ch: Channel) -> float:
    eff = ch.bandwidth_bps * (1.0 - ch.loss_rate)
    return ch.latency_s + nbytes * 8.0 / eff


class MultiChannelLink:
    """A device<->hub link over several physical channels.

    ``send`` stripes a payload across channels proportionally to their
    effective bandwidth (water-filling load balance); ``reserve`` slices
    off guaranteed bandwidth for a tenant (QoE isolation).
    """

    def __init__(self, channels: Sequence[Channel]):
        if not channels:
            raise ValueError("link needs at least one channel")
        self.channels = list(channels)
        self._reserved: dict[str, float] = {}  # tenant -> fraction

    @property
    def free_fraction(self) -> float:
        return max(0.0, 1.0 - sum(self._reserved.values()))

    def reserve(self, tenant: str, fraction: float) -> bool:
        if fraction <= 0 or fraction > self.free_fraction + 1e-12:
            return False
        self._reserved[tenant] = fraction
        return True

    def release(self, tenant: str) -> None:
        self._reserved.pop(tenant, None)

    def send(self, nbytes: float, *, tenant: Optional[str] = None) -> Transfer:
        """Stripe nbytes across channels; returns the completion time of
        the slowest stripe (all channels start together)."""
        frac = self._reserved.get(tenant, self.free_fraction if tenant is None
                                  else self.free_fraction)
        effs = [c.bandwidth_bps * (1 - c.loss_rate) * frac
                for c in self.channels]
        total = sum(effs)
        lat = 0.0
        energy = 0.0
        for c, eff in zip(self.channels, effs):
            share = nbytes * (eff / total)
            t = c.latency_s + share * 8.0 / max(eff, 1.0)
            lat = max(lat, t)
            energy += share * 8.0 * c.energy_per_bit
        return Transfer(nbytes, lat, energy,
                        tuple(c.name for c in self.channels))

    def best_single_channel(self, nbytes: float) -> tuple[Channel, float]:
        """Latency-optimal single channel for a payload (small payloads
        prefer low-latency channels, large ones high-bandwidth)."""
        best = min(self.channels, key=lambda c: transfer_time(nbytes, c))
        return best, transfer_time(nbytes, best)
