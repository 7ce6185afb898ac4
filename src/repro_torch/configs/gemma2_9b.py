"""gemma2-9b [dense]: alternating local/global attention + logit softcaps.

[arXiv:2408.00118] Gemma 2. 42 layers, d_model=3584, 16 heads (GQA kv=8),
head_dim=256, d_ff=14336, vocab=256000, window 4096, attn softcap 50,
final logit softcap 30, sandwich norms.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    pattern_period=2,        # local, global, local, global ...
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norms=True,
    attn_scale=256 ** -0.5,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, local_window=16,
    )
