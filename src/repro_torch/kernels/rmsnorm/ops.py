"""Fused RMSNorm (K7) — the gemma ``(1 + scale)`` convention, math in f32.

  rmsnorm_fused  the wrapper of the hand-written CUDA kernel
                 ``csrc/rmsnorm.cu`` (replaces the Pallas ``rmsnorm_rows``,
                 ``src/repro/kernels/rmsnorm/kernel.py``). A CUDA tensor
                 launches the kernel (or raises); a CPU tensor takes the
                 plain version — the only reason it ever does;
  rmsnorm_plain  the plain PyTorch version: ``models/layers.py::rmsnorm``'s
                 math. The CPU tests hold it against the JAX package's
                 Pallas kernel in interpret mode, and ``chip_smoke.py``
                 holds the kernel against it on the card.

The kernel is bound by memory: it reads every input byte once and writes
every output byte once, ``(2·N·D + D)·itemsize`` bytes in all.
"""
from __future__ import annotations

import threading

from .. import build

EPS = 1e-6

launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()


def rmsnorm_plain(x, scale, *, eps: float = EPS):
    """x: (..., D); scale: (D,). y = x·rsqrt(mean(x²) + eps)·(1 + scale),
    in f32, rounded once to x's dtype."""
    import torch
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_fused(x, scale, *, eps: float = EPS):
    """RMSNorm over the last axis of `x` (any leading shape). CUDA tensor →
    the K7 kernel on the current stream; CPU tensor → ``rmsnorm_plain``."""
    import torch
    if not x.is_cuda:
        return rmsnorm_plain(x, scale, eps=eps)
    kinds = (torch.bfloat16, torch.float32)
    if x.dtype not in kinds or scale.dtype not in kinds:
        raise TypeError(f"rmsnorm kernel takes bf16/f32, got x {x.dtype}, "
                        f"scale {scale.dtype}")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    build.launch("rmsnorm", x, x.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), rows, d, float(eps),
                 int(x.dtype == torch.bfloat16),
                 int(scale.dtype == torch.bfloat16))
    global launches
    with _count_lock:
        launches += 1
    return out
