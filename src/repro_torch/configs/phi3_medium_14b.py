"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA, full attention.

[arXiv:2404.14219] Phi-3. 40 layers, d_model=5120, 40 heads (GQA kv=10),
head_dim=128, d_ff=17920, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
    )
