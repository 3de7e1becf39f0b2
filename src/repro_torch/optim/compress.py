"""Gradient compression with error feedback (``src/repro/optim/
compress.py`` on PyTorch).

int8 block-quantizes gradients before a data-parallel reduction (4×/2×
less traffic than f32/bf16) and carries the quantization residual into the
next step (error feedback, which restores the convergence that plain
quantization loses). As in the JAX package, no trainer calls it: it is the
transform a data-parallel loop applies at the gradient boundary.

The quantizer is the reference's own PyTorch-op twin — ``amax / 127`` and
``x / scale`` as true f32 divisions, round half to even, clip to ±127 —
not the checkpoint codec's K5/K6 kernels, which follow the host oracle's
bytes.
"""
from __future__ import annotations

from ..core.split_state import leaf_paths, map_leaves, tree_unflatten

BLOCK = 256


def _quant_dequant(x):
    """Symmetric per-block int8 quantize → dequantize, in f32, of a tensor
    of any shape and float dtype; returns f32 of `x`'s shape."""
    import torch
    import torch.nn.functional as F
    shape = x.shape
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    xb = flat.reshape(-1, BLOCK)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    y = (q * scale[:, None]).reshape(-1)[:n]
    return y.reshape(shape)


class GradCompression:
    """Error-feedback int8 gradient compression."""

    def __init__(self, enabled: bool = True, min_size: int = 4096):
        self.enabled = enabled
        self.min_size = min_size    # tiny leaves (norms, biases) stay exact

    def init(self, params):
        import torch
        return {"error": map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
            if p.numel() >= self.min_size else None, params)}

    def apply(self, grads, state):
        """Returns (compressed-equivalent grads, new state): new tensors,
        the inputs are left as they were."""
        if not self.enabled:
            return grads, state

        def leaf(g, e):
            if e is None:
                return g, None
            corrected = g.float() + e
            g_hat = _quant_dequant(corrected)
            return g_hat.to(g.dtype), corrected - g_hat

        out = [leaf(g, e) for (_, g), (_, e) in
               zip(leaf_paths(grads), leaf_paths(state["error"]))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                {"error": tree_unflatten(grads, [o[1] for o in out])})

    @staticmethod
    def wire_bytes(params) -> tuple:
        """(compressed, raw-f32) bytes per DP reduction."""
        comp = raw = 0
        for _, p in leaf_paths(params):
            n = p.numel()
            raw += n * 4
            comp += n + (n // BLOCK + 1) * 4
        return comp, raw
