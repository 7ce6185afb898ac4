"""mamba2-370m [ssm]: attention-free SSD (state-space duality).

[arXiv:2405.21060] Mamba-2. 48 layers, d_model=1024 (d_inner=2048,
headdim=64 -> 32 SSM heads), ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, ssm_state=16, ssm_head_dim=32,
        vocab_size=512,
    )
