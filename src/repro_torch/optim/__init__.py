"""Optimizers (``src/repro/optim`` on PyTorch): AdamW, the learning-rate
schedule and ``make_optimizer``. Adafactor and the int8 gradient codec
(``compress``) come with a later slice."""
from .adamw import AdamW, clip_by_global_norm, global_norm

__all__ = ["Adafactor", "AdamW", "clip_by_global_norm", "global_norm",
           "lr_schedule", "make_optimizer"]


class Adafactor:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Adafactor is not ported yet: it comes with the slice of the "
            "MoE families that train with it (ROADMAP.md); gemma3-1b and "
            "the dense families train with AdamW")


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
