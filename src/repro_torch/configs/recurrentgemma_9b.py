"""RecurrentGemma 9B — Griffin hybrid: RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Pattern: (recurrent, recurrent, local-attention) repeating;
window 2048; lru_width=4096; tied embeddings; gelu gated MLP.
Sub-quadratic: runs long_500k (state is O(1) for LRU, O(window) for local attn).
"""
from .base import ATTN_LOCAL, RGLRU, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    rope_theta=10_000.0,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2402.19427; unverified",
)
