"""Model configurations the port runs (copies of the JAX package's
framework-free config modules), selectable by architecture id."""
from __future__ import annotations

from . import gemma3_1b
from .base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM, ModelConfig, Stage,
                   build_stages, reduced)

_MODULES = (gemma3_1b,)

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
           "SSM", "ModelConfig", "Stage", "build_stages", "get_config",
           "reduced"]
