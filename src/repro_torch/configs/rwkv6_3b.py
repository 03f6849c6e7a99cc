"""rwkv6-3b [ssm]: Finch, attention-free, data-dependent decay.

32 layers, d_model 2560, 40 WKV heads of 64, d_ff 8960, vocab 65,536
(arXiv:2404.05892), as ``repro/configs/rwkv6_3b.py``. bf16 parameters and
activations; the WKV state is f32.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # wkv heads (d_model / 64)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv_decay_lora=64,
)
