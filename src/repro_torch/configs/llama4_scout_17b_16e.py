"""Llama-4 Scout 17B-active / 16-expert MoE, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert) vocab=202048, MoE 16e top-1 + 1 shared expert, every layer MoE.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # expert hidden width (assigned)
    vocab_size=202_048,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_expert=8192,
        n_shared_experts=1,
        capacity_factor=1.5,  # top-1 routing needs slack (Switch-style)
    ),
    rope_theta=500_000.0,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
