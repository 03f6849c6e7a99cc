"""dbrx-132b [moe] — 16-expert top-4 fine-grained MoE.

Assigned: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16e top-4. [hf:databricks/dbrx-base; unverified]

SwiGLU experts; ~132B total / ~36B active (router top-4 of 16).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    mlp="swiglu",
    n_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
)
