"""StableLM-2 1.6B — dense MHA (kv=32 = full), partial rotary.

[hf:stabilityai/stablelm-2-1_6b; unverified]  24L d_model=2048 32H (kv=32)
d_ff=5632 vocab=100352. LayerNorm, 25% rotary, gated silu MLP.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    rope_theta=10_000.0,
    rope_pct=0.25,
    act="silu",
    gated_mlp=True,
    norm="layernorm",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
