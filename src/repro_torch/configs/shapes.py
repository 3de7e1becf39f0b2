"""Assigned input shapes and the (arch × shape) applicability matrix
(``src/repro/configs/shapes.py``, copied)."""
from __future__ import annotations

from dataclasses import dataclass

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch × shape) cell is runnable, with a reason when not.

    Rules from the assignment:
      - encoder-only archs have no autoregressive decode step;
      - long_500k needs sub-quadratic attention (SSM / hybrid / mostly-local).
    """
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode excluded per assignment"
    return True, ""


def cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells, in deterministic order."""
    out = []
    for arch in sorted(configs):
        for shape in SHAPES.values():
            ok, _ = applicable(configs[arch], shape)
            if ok:
                out.append((arch, shape.name))
    return out
