"""Gemma-2 9B — dense, local/global alternating, logit softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
head_dim=256, window 4096, attn softcap 50, final softcap 30, pre+post norms,
tied embeddings, gelu gated MLP.
"""
from .base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=0.0625,  # 1/sqrt(query_pre_attn_scalar=256)
    rope_theta=10_000.0,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)
