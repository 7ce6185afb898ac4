"""Per-architecture runtime presets for the production mesh (a copy of
``repro.launch.presets``).

``baseline()`` is the paper-faithful configuration (plain data+tensor
parallel sharding, f32 master weights, no grad accumulation).
``optimized()`` is the beyond-paper configuration found by the JAX
package's hillclimb on the TPU mesh; the port keeps its values as they
are.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunPreset:
    microbatches: int = 1
    fsdp: bool = False
    remat: str = "nothing_saveable"
    param_dtype: str = "float32"
    moments_dtype: str = "float32"
    accum_dtype: str = "float32"
    moe_rowwise: bool = False
    smart: bool = False   # §Perf sharding rules (attn-replicate on
                          # indivisible heads, time-sharded kv caches)


_BASE = RunPreset()

# memory-fitting presets per arch (train_4k); found in §Dry-run iteration
_OPTIMIZED = {
    "kimi-k2-1t-a32b": RunPreset(microbatches=16, fsdp=True,
                                 param_dtype="bfloat16",
                                 moments_dtype="int8",
                                 accum_dtype="bfloat16",
                                 moe_rowwise=True, smart=True),
    "granite-moe-1b-a400m": RunPreset(fsdp=True, moe_rowwise=True,
                                      smart=True),
    "internvl2-76b": RunPreset(microbatches=8, fsdp=True,
                               param_dtype="bfloat16",
                               moments_dtype="int8", smart=True),
    "gemma3-27b": RunPreset(microbatches=4, fsdp=True, smart=True),
    "gemma2-9b": RunPreset(microbatches=2, fsdp=True, smart=True),
    "phi3-medium-14b": RunPreset(microbatches=2, fsdp=True,
                                 param_dtype="bfloat16", smart=True),
    "zamba2-7b": RunPreset(microbatches=2, fsdp=True, smart=True),
}
_OPT_DEFAULT = RunPreset(smart=True, fsdp=True, moe_rowwise=True)


def baseline(arch: str) -> RunPreset:
    return _BASE


def optimized(arch: str) -> RunPreset:
    return _OPTIMIZED.get(arch, _OPT_DEFAULT)
