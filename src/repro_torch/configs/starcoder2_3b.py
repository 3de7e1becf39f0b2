"""StarCoder2 3B — dense GQA, RoPE.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
LayerNorm + biases, non-gated gelu MLP (classic FFN), rope_theta ~1e6.
Treated as full attention per the assignment bracket ("GQA, RoPE").
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    vocab_size=49_152,
    rope_theta=999_999.44,
    act="gelu",
    gated_mlp=False,
    use_bias=True,
    norm="layernorm",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-3b",
)
