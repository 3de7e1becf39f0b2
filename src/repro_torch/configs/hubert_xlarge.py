"""HuBERT X-Large — audio encoder-only transformer backbone.

[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
(k-means cluster codebook). Encoder-only (bidirectional), conv positional
embedding, LayerNorm, non-gated gelu FFN. The modality FRONTEND IS A STUB per
the assignment: input_specs() supplies precomputed frame embeddings
(B, S, d_model) + cluster labels + mask; the CNN feature extractor is not
modeled. Loss = masked cluster prediction.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    positional="conv",
    act="gelu",
    gated_mlp=False,
    use_bias=True,
    norm="layernorm",
    source="arXiv:2106.07447; unverified",
)
