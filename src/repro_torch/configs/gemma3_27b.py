"""gemma3-27b [dense]: 5:1 local:global sliding-window stack, 128k-ready.

[hf:google/gemma-3-1b-pt family] 62 layers, d_model=5376, 32 heads
(GQA kv=16), head_dim=128, d_ff=21504, vocab=262144, window 1024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-27b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    pattern_period=6,
    local_window=1024,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    use_qk_norm=True,
    sandwich_norms=True,
    attn_scale=(5376 / 32) ** -0.5,  # gemma3 query_pre_attn_scalar
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=6, pattern_period=3, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        local_window=16, attn_scale=None,
    )
