"""Roofline terms of a traced step (PyTorch port of
``repro.launch.roofline``).

compute term    = FLOPs per chip / peak FLOP/s
memory term     = bytes per chip / HBM bandwidth
collective term = collective bytes per chip / NVLink bandwidth

The per-chip counts come from ``launch.hlo_analysis.Trace`` (the local
ops each rank runs on its shards).  The peaks are the NVIDIA H100 SXM5
80GB's, as ``core.perf_model`` states them for the hub's card.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.core.perf_model import HBM_BW
from repro_torch.core.perf_model import PEAK_FLOPS_BF16 as PEAK_FLOPS
from repro_torch.launch.hlo_analysis import Trace, analyze_hlo

# NVIDIA H100 SXM datasheet: NVLink 900 GB/s per GPU (both directions)
NVLINK_BW = 900e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # 6ND (train) / 2ND (serve) over the batch
    useful_ratio: float          # model_flops / (hlo_flops_per_chip * chips)
    bottleneck: str
    arg_bytes_per_chip: float = 0.0
    temp_bytes_per_chip: float = 0.0
    coll_counts: Optional[dict] = None

    def to_dict(self):
        return asdict(self)


def analyze(traced: Trace, *, arch: str, shape_name: str, mesh_name: str,
            chips: int, model_flops: float) -> Roofline:
    """Roofline terms from the trace of one step on one chip of
    ``chips``; ``traced.arg_bytes`` / ``peak_bytes`` become the per-chip
    argument and temporary bytes."""
    walked = analyze_hlo(traced)
    flops, nbytes = walked.flops, walked.bytes
    counts = {k: int(v) for k, v in walked.coll_counts.items()}
    coll = float(walked.coll_bytes)

    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = coll / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    total_hlo = flops * chips
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops=model_flops,
        useful_ratio=(model_flops / total_hlo) if total_hlo else 0.0,
        bottleneck=bottleneck, arg_bytes_per_chip=float(traced.arg_bytes),
        temp_bytes_per_chip=float(traced.peak_bytes), coll_counts=counts)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (decode: one token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
