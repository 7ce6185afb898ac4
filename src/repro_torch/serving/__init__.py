"""EdgeAI-Hub serving runtime, PyTorch port: continuous batching for one
model over a paged KV pool.  See ``serving.engine`` for the step
contract and what is not ported yet."""
from repro_torch.serving.engine import (
    EdgeServingEngine,
    Request,
    ServeConfig,
)
from repro_torch.serving.kv_pool import KVBlockPool, PoolExhausted, \
    blocks_for_tokens
from repro_torch.serving.telemetry import MetricsRegistry, default_clock

__all__ = ["EdgeServingEngine", "Request", "ServeConfig", "KVBlockPool",
           "PoolExhausted", "blocks_for_tokens", "MetricsRegistry",
           "default_clock"]
