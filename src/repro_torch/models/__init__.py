"""repro_torch.models: the LM substrate (the ``ssm`` family, RWKV6, and
the ``dense`` family, so far)."""
from .common import ModelConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
