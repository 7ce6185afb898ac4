"""zamba2-7b [hybrid]: Mamba2 trunk + shared-weight attention block.

[arXiv:2411.15242] Zamba2. 81 blocks, d_model=3584, attention 32 heads
(MHA, kv=32), d_ff=14336 in the shared block, ssm_state=64, vocab=32000.
We apply the shared attention(+MLP) block every 6th position (13
applications over 81 blocks; remainder 3 blocks are mamba), matching the
paper's periodic shared-block design.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_period=6,
    local_window=4096,       # shared attn block windows at long context
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=6, hybrid_attn_period=3, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, local_window=16,
    )
