"""Kimi K2 — trillion-param MoE (384 experts, top-8, 1 shared, first layer dense).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840. head_dim=128 per the public config (64*128=8192 != d_model — q/k/v
projections are rectangular). Optimizer: adafactor (1T params — Adam state would
not fit 256 chips).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,  # expert hidden width (assigned)
    vocab_size=163_840,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_expert=2048,
        n_shared_experts=1,
        first_k_dense=1,
        dense_d_ff=18_432,
        capacity_factor=1.25,
    ),
    rope_theta=50_000.0,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    optimizer="adafactor",
    remat_policy="nothing",  # save nothing: 1T-param activations must recompute
    source="arXiv:2501.kimi2 (paper-table); unverified",
)
