"""EdgeAI-Hub serving runtime, PyTorch port: continuous batching for one
model over a paged KV pool with a radix prefix cache and speculative
decoding.  See ``serving.engine`` for the step contract and what is not
ported yet.  One carve-out from exactness: moe expert capacity comes from
a call's static (padded, batched) token count, so under capacity
pressure the tokens dropped depend on the batch (pads never take
capacity, but the bound is shape-derived); with ``capacity_factor`` high
enough that nothing drops, moe is exact like every other family."""
from repro_torch.serving.engine import (
    EdgeServingEngine,
    Request,
    ServeConfig,
    cache_batch_axes,
    extract_slot,
    insert_slot,
    paged_cache_axes,
)
from repro_torch.serving.kv_pool import KVBlockPool, PoolExhausted, \
    blocks_for_tokens
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.spec_decode import (SpecDecoder, accept_proposals,
                                             make_self_draft, validate_spec)
from repro_torch.serving.telemetry import (MetricsRegistry, Tracer,
                                           default_clock, summarize_trace,
                                           validate_chrome_trace)

__all__ = ["EdgeServingEngine", "Request", "ServeConfig", "KVBlockPool",
           "PoolExhausted", "blocks_for_tokens", "MetricsRegistry",
           "default_clock", "cache_batch_axes", "extract_slot",
           "insert_slot", "paged_cache_axes", "RadixPrefixCache",
           "SpecDecoder", "accept_proposals", "make_self_draft",
           "validate_spec", "Tracer", "summarize_trace",
           "validate_chrome_trace"]
