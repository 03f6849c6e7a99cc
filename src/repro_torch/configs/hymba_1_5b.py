"""hymba-1.5b [hybrid] — parallel attention + Mamba heads, meta tokens.

Assigned: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. [arXiv:2411.13676; hf]

Every layer fuses attention and SSM branches in parallel (outputs normed +
averaged with learnable betas). Sliding-window (1024) attention everywhere
except 3 global layers {0, 15, 31}; 128 learnable meta tokens are always
visible through the window. SWA + O(1) SSM state bound the 512k decode
cell's memory.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp="swiglu",
    ssm_state=16,
    ssm_expand=2,
    conv_width=4,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    n_meta_tokens=128,
)
