"""repro_torch.models: the LM substrate, every family of the reference
(dense, MoE, RWKV6, hymba's hybrid, the encoder-decoder and the vision
model's cross-attention)."""
from .common import ModelConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
