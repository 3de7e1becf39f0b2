"""Griffin/RecurrentGemma recurrent block: conv + RG-LRU with diagonal
gates (``src/repro/models/rglru.py`` on PyTorch), as plain functions over
the JAX package's parameter dict.

Training and prefill solve the diagonal linear recurrence
``h_t = a_t · h_{t−1} + b_t`` with a log-depth scan over S: the
reference's ``jax.lax.associative_scan`` has no eager PyTorch
counterpart, so ``_scan`` runs ⌈log2 S⌉ doubling passes over (B, S, W)
f32 with the reference's ``combine`` (12 passes at S 4,096). Its
association order differs from the reference's, so the values agree
within rounding, not bit for bit. Decode is the O(1) update.

Every width dim is a channel, and every size here comes from the leaves:
on a mesh (``models.parallel``) a TP rank calls the same functions on its
shards, its W/tp channels, and ``wo``'s rows give it a partial sum.
"""
from __future__ import annotations

from .layers import causal_conv1d

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def init_lam(shape, g, dev):
    """λ = log(expm1(−log(a0) / c)), a0 ~ U[0.9, 0.999]: a decay of a0 at
    r = 1 (the reference's init of ``lam``)."""
    import torch
    a0 = torch.rand(shape, generator=g, device=dev) * (0.999 - 0.9) + 0.9
    return torch.log(torch.expm1(-torch.log(a0) / _C))


def _gates(params, u):
    """u: (B, S, W) → (a, b) in f32: the decay a = exp(−c·softplus(λ)·r)
    and the input b = sqrt(1 − a²)·(i · u)."""
    import torch
    import torch.nn.functional as F
    uf = u.float()
    r = torch.sigmoid(uf * params["gate_a_w"] + params["gate_a_b"])
    i = torch.sigmoid(uf * params["gate_x_w"] + params["gate_x_b"])
    log_a = -_C * F.softplus(params["lam"]) * r             # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * uf)
    return a, b


def _scan(a, b):
    """The inclusive scan of ``combine(l, r) = (al·ar, ar·bl + br)`` over
    axis 1: h_t = a_t·h_{t−1} + b_t from h_{−1} = 0. Hillis–Steele
    doubling: pass d folds in the element d positions back."""
    import torch
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(params, x, cfg, *, state=None, return_state=False):
    """x: (B, S, D) → (B, S, D) [, new_state]. state = {"conv", "h" (B, W)
    f32} or None."""
    import torch
    import torch.nn.functional as F
    gate = F.gelu(x @ params["wg"], approximate="tanh")
    u = x @ params["wx"]
    conv_state = None if state is None else state["conv"]
    u, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                state=conv_state)
    a, b = _gates(params, u)                                 # (B, S, W) f32
    if state is not None:
        # fold the carried hidden state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None], b[:, 1:]],
                      dim=1)
    h = _scan(a, b)
    y = (gate.float() * h).to(x.dtype)
    out = y @ params["wo"]
    if return_state:
        return out, {"conv": new_conv, "h": h[:, -1].float()}
    return out


def rglru_decode_step(params, x, cfg, state):
    """x: (B, 1, D) → (y, new_state): new tensors, the caller's state is
    not written."""
    import torch.nn.functional as F
    gate = F.gelu(x @ params["wg"], approximate="tanh")
    u = x @ params["wx"]
    u, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                state=state["conv"])
    a, b = _gates(params, u)                                 # (B, 1, W)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = (gate[:, 0].float() * h).to(x.dtype)
    out = (y @ params["wo"])[:, None]
    return out, {"conv": new_conv, "h": h}


def init_rglru_state(cfg, batch, *, device=None):
    """Zero decode state: conv history in the params' dtype, h in f32."""
    import torch
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, r.conv_width - 1, w),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
