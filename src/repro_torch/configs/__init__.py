"""Model configurations the port runs (copies of the JAX package's
framework-free config modules), selectable by architecture id: the ten
architectures of the JAX package — the attention families, dense and MoE,
the Mamba-2 SSM (mamba2-780m), the RG-LRU hybrid (recurrentgemma-9b) and
the encoder (hubert-xlarge)."""
from __future__ import annotations

from . import (chameleon_34b, gemma2_9b, gemma3_1b, hubert_xlarge,
               kimi_k2_1t_a32b, llama4_scout_17b_16e, mamba2_780m,
               recurrentgemma_9b, stablelm_1_6b, starcoder2_3b)
from .base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM, ModelConfig,
                   MoEConfig, Stage, build_stages, reduced)
from .shapes import SHAPES, ShapeSpec, applicable, cells

_MODULES = (kimi_k2_1t_a32b, llama4_scout_17b_16e, gemma3_1b, stablelm_1_6b,
            starcoder2_3b, gemma2_9b, chameleon_34b, mamba2_780m,
            recurrentgemma_9b, hubert_xlarge)

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG
                                   for m in _MODULES}
ARCH_IDS = tuple(sorted(CONFIGS))


def get_config(arch_id: str) -> ModelConfig:
    try:
        return CONFIGS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; the port has: {', '.join(ARCH_IDS)}"
        ) from None


__all__ = ["ATTN_GLOBAL", "ATTN_LOCAL", "ARCH_IDS", "CONFIGS", "RGLRU",
           "SHAPES", "SSM", "ModelConfig", "MoEConfig", "ShapeSpec", "Stage",
           "applicable", "build_stages", "cells", "get_config", "reduced"]
