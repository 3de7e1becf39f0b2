"""Production parallelism presets (``src/repro/configs/presets.py``,
copied): each architecture's config overrides that won its roofline
iteration in the reference. Launchers apply these with ``--preset``; the
defaults (no preset) remain the paper-faithful baseline so both variants
stay reproducible."""
from __future__ import annotations

# arch -> (train-time overrides, rationale)
PRESETS: dict = {
    "kimi-k2-1t-a32b": (
        {"moe_impl": "shard_map", "seq_shard_resid": True},
        "explicit EP all_to_all (7.2x collective) + Megatron-SP residuals"),
    "llama4-scout-17b-a16e": (
        {"moe_impl": "shard_map", "seq_shard_resid": True},
        "EP + SP: frac 0.059 -> 0.163"),
    "chameleon-34b": (
        {"seq_shard_resid": True},
        "SP shards residual/cotangent f32 buffers 16x: HBM 148 -> 22 GiB"),
    "gemma2-9b": (
        {"seq_shard_resid": True},
        "SP: HBM 35 -> 26 GiB"),
    "recurrentgemma-9b": (
        {"seq_shard_resid": True},
        "SP: frac 0.13 -> 0.19"),
    "starcoder2-3b": (
        {"seq_shard_resid": True},
        "SP (marginal; heads don't divide tp=16 so SP attn already active)"),
    "gemma3-1b": (
        {"dp_over_model": True},
        "H=4 heads can't shard tp=16: full-DP, frac 0.081 -> 0.245"),
    "stablelm-1.6b": (
        {"dp_over_model": True},
        "small dense: full-DP, frac 0.034 -> 0.077"),
    "hubert-xlarge": (
        {"dp_over_model": True},
        "encoder: full-DP + grouped conv fix, HBM 128 -> 2 GiB"),
    "mamba2-780m": (
        {"dp_over_model": True},
        "attention-free small model: full-DP; SSD chunk 1024 for prefill"),
}


def preset_overrides(arch_id: str) -> dict:
    return dict(PRESETS.get(arch_id, ({}, ""))[0])
