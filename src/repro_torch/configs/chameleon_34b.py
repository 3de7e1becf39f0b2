"""Chameleon 34B — early-fusion VLM; VQ image tokens share the text vocab.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536. qk-norm (critical for chameleon stability), silu gated MLP.
The VQ-VAE image tokenizer FRONTEND IS A STUB per the assignment: inputs are
token ids already containing image tokens (early fusion = one sequence).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    optimizer="adafactor",
    source="arXiv:2405.09818; unverified",
)
