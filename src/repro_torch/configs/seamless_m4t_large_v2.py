"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone.

Assigned: 24L d_model=1024 16H (GQA kv=16 = full MHA) d_ff=8192
vocab=256206. [arXiv:2308.11596; hf]

Interpretation: 24 encoder + 24 decoder layers (the hf config's 24/24; the
assignment's single "24L" is read per-stack). The audio frontend
(w2v-BERT conformer feature extractor) is a STUB: the batch's
``src_embed`` holds precomputed frame embeddings (B, S_src, 1024). MLP is non-gated GeLU
(transformer-vanilla, as in the released checkpoints); positions via RoPE
(simplification of the original sinusoidal embeddings — noted in DESIGN.md).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp="gelu",
    source_is_embeddings=True,
)
