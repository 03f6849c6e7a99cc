"""granite-34b [dense] — code model, MQA.

Assigned: 88L d_model=6144 48H (GQA kv=1 = multi-query) d_ff=24576
vocab=49152. [arXiv:2405.04324; hf]

The 34B parameter count implies a NON-gated (GeLU) MLP (2·d·d_ff); a gated
SwiGLU at d_ff=24576 would be ≈47B (see DESIGN.md arithmetic). GPTBigCode
lineage; positions here via RoPE (adaptation note in DESIGN.md).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",
)
