"""Device resolution for the port's entry points.

Every entry point (``CheckpointManager``, ``GearScanner``,
``state.train_state``, ``convert.from_jax_state``) runs on the CUDA card
unless the caller asks for the CPU: ``None`` means ``"cuda"``, and a CUDA
request on a machine without a card raises instead of carrying on on the
CPU."""
from __future__ import annotations


def resolve_device(device=None):
    """``None`` → ``cuda``; returns a ``torch.device``. Raises
    ``RuntimeError`` for a CUDA device when no card is usable."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
