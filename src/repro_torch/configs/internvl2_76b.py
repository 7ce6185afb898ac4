"""internvl2-76b [vlm]: InternViT(stub) + LLaMA3-70B-style language trunk.

[arXiv:2404.16821] InternVL2. Vision encoder + MLP projector are STUBS —
``input_specs`` provides precomputed patch embeddings; this config is the
language/decoder transformer that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    num_image_tokens=256,
    image_embed_dim=3200,  # InternViT-6B width (projector stub input)
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
        num_image_tokens=16, image_embed_dim=96,
    )
