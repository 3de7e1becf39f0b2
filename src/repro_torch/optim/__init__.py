"""Optimizers (``src/repro/optim`` on PyTorch): AdamW, Adafactor, the
learning-rate schedule and ``make_optimizer``; ``compress`` holds the int8
error-feedback gradient codec."""
from .adafactor import Adafactor
from .adamw import AdamW, clip_by_global_norm, global_norm

__all__ = ["Adafactor", "AdamW", "clip_by_global_norm", "global_norm",
           "lr_schedule", "make_optimizer"]


def make_optimizer(cfg):
    if cfg.optimizer == "adafactor":
        return Adafactor()
    return AdamW()


def lr_schedule(step, *, peak=3e-4, warmup=100, total=10_000, floor=0.1):
    """Linear warmup + cosine decay to floor*peak, in f32 on `step`'s
    device (a Python int gives a CPU tensor)."""
    import math

    import torch
    step = step.float() if isinstance(step, torch.Tensor) \
        else torch.tensor(float(step))
    warm = peak * (step + 1) / warmup
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
