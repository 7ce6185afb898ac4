"""What the kernels that split a reduction across thread blocks share:
the SM count of a device, and per-(device, stream) int32 arrival
counters.

A split launch (``quant_matmul``'s GEMV, the two paged reads) writes
float32 partials to a workspace, and the last block to arrive at a
counter sums them in a fixed order and sets the counter back to 0.
Calls on one stream run one after another, so every kernel on a stream
can use the stream's counters; two streams may run calls at once, so
each (device, stream) has its own.
"""
from __future__ import annotations

import torch

_counters: dict = {}
_sms: dict = {}


def sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def counters_for(device, stream: int, n: int):
    """At least ``n`` zero int32 counters on ``device`` for calls on
    ``stream`` (the kernels reset what they count)."""
    c = _counters.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[(device, stream)] = c
    return c
