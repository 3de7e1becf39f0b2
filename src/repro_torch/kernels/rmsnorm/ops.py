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

  rmsnorm        the differentiable norm the model calls: a
                 ``torch.autograd.Function`` whose forward is
                 ``rmsnorm_fused`` and whose backward is
                 ``rmsnorm_backward``, written out in PyTorch ops (the JAX
                 package differentiates its XLA ``layers.rmsnorm``; it has
                 no backward Pallas kernel, so neither has the port yet).

The kernel is bound by memory: it reads every input byte once and writes
every output byte once, ``(2·N·D + D)·itemsize`` bytes in all.
"""
from __future__ import annotations

import functools
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


def rmsnorm_backward(x, scale, dy, *, eps: float = EPS):
    """(dx, dscale) of ``rmsnorm_plain`` at (x, scale) for the cotangent
    `dy`, in f32 and rounded once to each input's dtype. With
    ``r = rsqrt(mean(x²) + eps)``, ``w = 1 + scale`` and ``g = dy·w``:
    ``dx = r·g − x·r³·mean(g·x)`` and ``dscale = Σ_rows dy·x·r``."""
    import torch
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyf = dy.float()
    g = dyf * (1.0 + scale.float())
    dx = r * g - xf * r.pow(3) * (g * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@functools.cache
def _autograd_fn():
    import torch

    class RMSNorm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale, eps):
            ctx.save_for_backward(x, scale)
            ctx.eps = eps
            return rmsnorm_fused(x, scale, eps=eps)

        @staticmethod
        def backward(ctx, dy):
            x, scale = ctx.saved_tensors
            dx, dscale = rmsnorm_backward(x, scale, dy, eps=ctx.eps)
            return dx, dscale, None

    return RMSNorm


def rmsnorm(x, scale, *, eps: float = EPS):
    """Differentiable RMSNorm: K7 forward (plain version on the CPU),
    ``rmsnorm_backward`` as its gradient."""
    return _autograd_fn().apply(x, scale, eps)
