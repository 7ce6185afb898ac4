"""Model/architecture configuration for the EdgeAI-Hub framework
(PyTorch port).

Field for field the same dataclass as ``repro.configs.base``, so a
config reads the same in both packages; only the dtype properties
differ: ``activation_dtype`` / ``weight_dtype`` return ``torch.dtype``s.

Every assigned architecture gets a module in this package exporting
``CONFIG: ModelConfig`` (full size) and ``smoke_config()`` (reduced
variant that runs a real step on the CPU).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""       # citation for the config numbers

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention pattern: layers come in repeating "periods" of length
    # ``pattern_period``; the LAST layer of each period is global, the
    # rest are local (sliding window).  pattern_period=1 => all global.
    pattern_period: int = 1
    local_window: int = 1024
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None  # gemma3: 1M for globals
    use_qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sandwich_norms: bool = False  # gemma2/3 post-block norms
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # row-wise dispatch: route each sequence independently (vmap over
    # batch) so the expert buffers shard along batch/data instead of a
    # GLOBAL (E, c) buffer every chip must process — see EXPERIMENTS.md
    # §Perf (MoE dispatch).  False = paper-era global dispatch.
    moe_rowwise: bool = False

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): one shared-weight attention block applied
    # every ``hybrid_attn_period``-th block, mamba blocks elsewhere.
    hybrid_attn_period: int = 0

    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    encoder_seq: int = 0        # precomputed frame embeddings length
    encoder_width: int = 0      # frontend embedding dim (== d_model here)

    # VLM
    num_image_tokens: int = 0
    image_embed_dim: int = 0    # stub projector input dim

    # numerics / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    use_layernorm: bool = False  # whisper uses LN, everyone else RMSNorm
    use_abs_pos: bool = False    # whisper: sinusoidal/learned positions
    max_target_positions: int = 0  # enc-dec decoder position table size
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def activation_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode over >=512k context is sub-quadratic/windowed."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense archs qualify only via a local/global sliding-window stack
        return self.pattern_period > 1

    @property
    def supports_decode(self) -> bool:
        return True  # no encoder-only archs in the assignment

    # layer-pattern bookkeeping -----------------------------------------
    @property
    def num_superblocks(self) -> int:
        return self.pattern_blocks()[0]

    def pattern_blocks(self) -> tuple[int, int]:
        """(num_full_periods, remainder_local_layers) of the decoder trunk."""
        body = self.num_layers - self.first_dense_layers
        if self.pattern_period <= 1:
            return body, 0
        return body // self.pattern_period, body % self.pattern_period

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter counting (analytical; used by perf model & benchmarks) ---
    def param_count(self) -> int:
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        if not self.tie_embeddings:
            emb *= 2
        attn = d * self.num_heads * self.head_dim + d * self.head_dim * (
            2 * self.num_kv_heads) + self.num_heads * self.head_dim * d
        dense_mlp = 3 * d * self.d_ff
        if self.family == "ssm":
            per = self._ssm_block_params()
            return emb + L * per
        if self.family == "hybrid":
            n_attn = L // max(self.hybrid_attn_period, 1)
            per_m = self._ssm_block_params()
            shared_attn = attn + 3 * d * self.d_ff
            return emb + (L - n_attn) * per_m + shared_attn
        if self.family == "moe":
            moe_mlp = (self.num_experts + self.num_shared_experts) * 3 * d * self.moe_d_ff
            router = d * self.num_experts
            moe_layers = L - self.first_dense_layers
            return (emb + L * attn + self.first_dense_layers * dense_mlp
                    + moe_layers * (moe_mlp + router))
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 3 * d * self.d_ff)
            dec = L * (2 * attn + 3 * d * self.d_ff)  # self + cross
            return emb + enc + dec
        # dense / vlm
        return emb + L * (attn + dense_mlp)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        attn = d * self.num_heads * self.head_dim + d * self.head_dim * (
            2 * self.num_kv_heads) + self.num_heads * self.head_dim * d
        active_mlp = (self.num_experts_per_tok + self.num_shared_experts) * 3 * d * self.moe_d_ff
        dense_mlp = 3 * d * self.d_ff
        moe_layers = L - self.first_dense_layers
        return (emb + L * attn + self.first_dense_layers * dense_mlp
                + moe_layers * (active_mlp + d * self.num_experts))

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)
        conv = (di + 2 * n) * self.ssm_conv_width
        out = di * d
        return in_proj + conv + out + 2 * h  # + A, D, dt_bias etc.


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
