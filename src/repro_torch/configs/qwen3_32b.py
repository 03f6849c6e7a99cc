"""qwen3-32b [dense] — qk_norm, GQA, decoupled head_dim.

Assigned: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
[hf:Qwen/Qwen3-8B; hf]

Qwen3 uses head_dim=128 independent of d_model (q-proj 5120 -> 8192) and
per-head RMS qk-norm.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    mlp="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
)
