"""Gemma-3 1B — dense, 5:1 local:global attention, 128k-context design.

[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144. head_dim=256, sliding window 512, local rope base 10k vs global 1M,
qk-norm, tied embeddings, gelu gated MLP.
"""
from .base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
    window=512,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
