"""Performance controller: analytical roofline estimators per device.

The orchestrator's *performance controller* (paper Fig. 5a) assesses an
AI-task's runtime/energy on a candidate device "through analytical or
historical estimators".  We implement both:

* analytical — three-term roofline (compute / memory / link) from the
  task's FLOPs & bytes and the device's peak numbers;
* historical — an EWMA over observed runtimes, keyed by (task, device).

Device catalogue spans the consumer-edge tiers the paper describes, from
sensor-class MCUs to the EdgeAI-Hub itself.  This is the port's copy of
``repro.core.perf_model``: the hub is the card the port runs on, an
NVIDIA H100 SXM5 80GB, and carries that card's datasheet figures; every
other device is copied as it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig

# NVIDIA H100 SXM5 80GB (datasheet): the hub's card
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
HBM_BYTES = 80e9                # bytes of device memory
ICI_BW = 50e9                   # B/s per NVLink 4 link (the chip-to-chip link)
PEAK_POWER_W = 700.0            # W, the card's power limit
# W drawn by the idle card: nvidia-smi's power.draw before any work
# (chip_smoke.py's env phase; an H100 80GB HBM3 at its 700 W limit)
IDLE_POWER_W = 71.07


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    kind: str                   # hub | phone | tv | wearable | sensor | robot
    peak_flops: float           # FLOP/s (dense, best precision)
    mem_bw: float               # B/s
    memory_bytes: float
    idle_power: float           # W
    peak_power: float           # W
    train_capable: bool = False
    # DVFS: available frequency scaling states (fraction of peak)
    dvfs_states: tuple = (1.0,)

    def scaled(self, dvfs: float) -> "DeviceSpec":
        return replace(self, peak_flops=self.peak_flops * dvfs,
                       peak_power=self.peak_power * dvfs ** 2)


# Representative consumer-edge device catalogue (order-of-magnitude
# figures from public spec sheets; the EdgeAI-Hub is one H100).
DEVICE_CATALOGUE = {
    "edgeai-hub": DeviceSpec("edgeai-hub", "hub", PEAK_FLOPS_BF16, HBM_BW,
                             HBM_BYTES, IDLE_POWER_W, PEAK_POWER_W,
                             train_capable=True,
                             dvfs_states=(0.5, 0.75, 1.0)),
    "flagship-phone": DeviceSpec("flagship-phone", "phone", 30e12, 60e9,
                                 12e9, 0.5, 8.0,
                                 dvfs_states=(0.25, 0.5, 1.0)),
    "mid-phone": DeviceSpec("mid-phone", "phone", 6e12, 30e9, 6e9, 0.3, 5.0),
    "smart-tv": DeviceSpec("smart-tv", "tv", 8e12, 40e9, 4e9, 15.0, 60.0),
    "wearable": DeviceSpec("wearable", "wearable", 0.5e12, 8e9, 1e9,
                           0.05, 1.0),
    "iot-sensor": DeviceSpec("iot-sensor", "sensor", 0.01e12, 1e9, 0.25e9,
                             0.01, 0.3),
    "robot-vacuum": DeviceSpec("robot-vacuum", "robot", 2e12, 20e9, 2e9,
                               2.0, 15.0),
    "old-phone": DeviceSpec("old-phone", "phone", 1e12, 15e9, 3e9, 0.3, 4.0),
}


@dataclass(frozen=True)
class TaskCost:
    """Hardware-independent cost of one execution of an AI-task."""
    flops: float
    weight_bytes: float
    activation_bytes: float
    transfer_bytes: float = 0.0     # input/output payload over the network

    @property
    def mem_bytes(self) -> float:
        return self.weight_bytes + self.activation_bytes


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Decode FLOPs/token ~= 2 * active params (weight reuse ignored)."""
    return 2.0 * cfg.active_param_count()


def train_flops(cfg: ModelConfig, tokens: int) -> float:
    """6ND rule (fwd 2ND + bwd 4ND) on active params."""
    return 6.0 * cfg.active_param_count() * tokens


def inference_cost(cfg: ModelConfig, batch: int, seq: int,
                   weight_bits: int = 16) -> TaskCost:
    n_tok = batch * seq
    return TaskCost(
        flops=2.0 * cfg.active_param_count() * n_tok,
        weight_bytes=cfg.param_count() * weight_bits / 8,
        activation_bytes=2.0 * n_tok * cfg.d_model * 12,  # ~12 live tensors
        transfer_bytes=4.0 * n_tok,
    )


def training_cost(cfg: ModelConfig, batch: int, seq: int) -> TaskCost:
    n_tok = batch * seq
    return TaskCost(
        flops=6.0 * cfg.active_param_count() * n_tok,
        weight_bytes=cfg.param_count() * 16,  # w + grad + adam m,v (f32)
        activation_bytes=2.0 * n_tok * cfg.d_model * cfg.num_layers,
        transfer_bytes=cfg.param_count() * 2,  # update shipping (FL)
    )


@dataclass
class Estimate:
    compute_s: float
    memory_s: float
    latency_s: float
    energy_j: float
    fits_memory: bool

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


def estimate(task: TaskCost, dev: DeviceSpec, *, dvfs: float = 1.0,
             utilization: float = 0.4) -> Estimate:
    """Roofline latency + energy on one device (no network)."""
    d = dev.scaled(dvfs) if dvfs != 1.0 else dev
    compute_s = task.flops / (d.peak_flops * utilization)
    memory_s = task.mem_bytes / d.mem_bw
    latency = max(compute_s, memory_s)
    energy = latency * d.peak_power * 0.7 + latency * d.idle_power
    return Estimate(compute_s, memory_s, latency, energy,
                    fits_memory=task.mem_bytes <= d.memory_bytes)


class HistoricalEstimator:
    """EWMA of observed runtimes, keyed by (task_kind, device)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._table: dict[tuple, float] = {}

    def observe(self, task_kind: str, device: str, latency_s: float) -> None:
        key = (task_kind, device)
        prev = self._table.get(key)
        self._table[key] = (latency_s if prev is None
                            else (1 - self.alpha) * prev
                            + self.alpha * latency_s)

    def predict(self, task_kind: str, device: str) -> Optional[float]:
        return self._table.get((task_kind, device))
