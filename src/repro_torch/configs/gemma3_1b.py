"""gemma3-1b [dense]: 5:1 local:global sliding-window stack, 128k-ready.

[hf:google/gemma-3-1b-pt] 26 layers, d_model=1152, 4 heads (GQA kv=1),
head_dim=256, d_ff=6912 (gated), vocab=262144, local window 512,
global layers use rope_theta=1M.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern_period=6,        # 5 local : 1 global
    local_window=512,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    use_qk_norm=True,
    sandwich_norms=True,
    attn_scale=256 ** -0.5,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    # keep the 5:1 pattern visible: 1 superblock of 6 reduces too far;
    # use period 3 (2 local + 1 global) x 2 superblocks.
    return CONFIG.replace(
        num_layers=6, pattern_period=3, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        local_window=16,
    )
