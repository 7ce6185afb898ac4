"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2] Kimi K2 (paper-table entry). 61 layers (first layer
dense FFN), d_model=7168, 64 heads (GQA kv=8 per assignment), expert
d_ff=2048, 384 routed experts top-8 + 1 shared expert, vocab=163840.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # dense first-layer FFN width (K2 style)
    vocab_size=163_840,
    num_experts=384,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    first_dense_layers=1,
    rope_theta=50_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, first_dense_layers=1, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
        num_shared_experts=1,
    )
