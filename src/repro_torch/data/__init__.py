from repro_torch.data.pipeline import DataConfig, data_iterator, synthetic_tokens

__all__ = ["DataConfig", "data_iterator", "synthetic_tokens"]
