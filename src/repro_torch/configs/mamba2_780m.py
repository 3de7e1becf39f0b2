"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128. expand=2 (d_inner=3072), head_dim=64 (48 SSM heads), conv=4,
chunked SSD with chunk 256. Tied embeddings. No separate MLP per block
(mamba block is the whole layer). Sub-quadratic: runs long_500k.
"""
from .base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    pattern=(SSM,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    positional="none",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
