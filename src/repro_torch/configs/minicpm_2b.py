"""minicpm-2b [dense] — WSD schedule, tied embeddings, llama-like.

Assigned: 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) schedule is the arch-level training hint —
wired through ``schedule='wsd'`` into repro.optim.schedules.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp="swiglu",
    tie_embeddings=True,
    schedule="wsd",
)
