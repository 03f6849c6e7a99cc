"""olmoe-1b-7b [moe] — 64-expert top-8 fine-grained MoE (1B active / 7B total).

Assigned: 16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1024 (per expert!)
vocab=50304, MoE 64e top-8. [arXiv:2409.02060; hf]
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    mlp="swiglu",
    n_experts=64,
    experts_per_token=8,
    qk_norm=True,          # OLMoE uses QK-norm
)
