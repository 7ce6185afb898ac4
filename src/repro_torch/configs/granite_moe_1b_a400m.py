"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24 layers, d_model=1024,
16 heads (GQA kv=8), expert d_ff=512, 32 experts top-8, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    num_experts=32,
    num_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=64, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
    )
