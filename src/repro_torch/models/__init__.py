"""Model families of the port (the dense transformer, ssm and hybrid
families) and the unified model API, re-exported from ``models.model``
as the JAX package's ``repro.models`` does."""
from repro_torch.models.model import (apply, batch_shapes, count_params,
                                      decode_step, init_cache, init_params,
                                      loss_fn, make_batch, prefill,
                                      specialize)

__all__ = ["apply", "batch_shapes", "count_params", "decode_step",
           "init_cache", "init_params", "loss_fn", "make_batch", "prefill",
           "specialize"]
