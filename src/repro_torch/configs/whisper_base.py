"""whisper-base [audio]: enc-dec transformer backbone, conv frontend stubbed.

[arXiv:2212.04356] Radford et al., "Robust Speech Recognition via
Large-Scale Weak Supervision". 6 encoder + 6 decoder layers, d_model=512,
8 heads (MHA; the assignment's GQA kv=8 == MHA here), d_ff=2048,
vocab=51865, 1500 audio frames after the (stubbed) conv frontend.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,
    encoder_width=512,
    use_layernorm=True,
    use_abs_pos=True,
    max_target_positions=448,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder_seq=64, encoder_width=128, max_target_positions=64,
    )
