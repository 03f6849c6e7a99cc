"""llama-3.2-vision-90b [vlm] — gated cross-attention image layers.

Assigned: 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

100 layers = 80 self-attention + 20 gated cross-attention (every 5th layer
attends to vision tokens, tanh-gated, zero-init). The vision tower is a
STUB: the batch's ``vision_embed`` holds projected patch
embeddings (B, vision_seq, d_model).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp="swiglu",
    cross_attn_every=5,
    vision_seq=1024,
    rope_theta=500_000.0,
)
