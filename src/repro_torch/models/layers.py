"""Shared layers of the model families, as plain functions over the JAX
package's parameter dicts (``src/repro/models/layers.py``): norms, rope,
MLPs, attention, and the two convolutions (the causal depthwise conv of
the SSM and RG-LRU blocks, the encoder's conv positional embedding).

Two of them run the port's hand-written kernels on a CUDA tensor:
``rmsnorm`` is K7 (``kernels.rmsnorm``) and the sequence attentions
``attention_full``/``attention_local`` are K8 (``kernels.flash_attention``),
which computes what the JAX package's Pallas kernel computes for them (q
scaled in f32; the XLA path scales q in its own dtype). Both are
differentiable: their backward passes are PyTorch ops beside the kernels. Decode attention
(one query per step) is not a Pallas kernel in the JAX package and stays
PyTorch ops here. Rounding follows the JAX functions: f32 math where they
upcast, one rounding to the activation dtype where they cast back, and f32
outputs where they ask for ``preferred_element_type=float32``.
"""
from __future__ import annotations

import math

from ..kernels.flash_attention import attention
from ..kernels.rmsnorm import rmsnorm as rmsnorm_fn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, *, eps=1e-6):
    """The gemma (1 + scale) RMSNorm: the K7 kernel on a CUDA tensor."""
    return rmsnorm_fn(x, scale, eps=eps)


def layernorm(x, scale, bias, *, eps=1e-5):
    import torch
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(params, x, cfg):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params.get("bias"))


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope_table(positions, head_dim, theta, rope_pct=1.0):
    """positions: (...,) ints → (cos, sin, rot_dim), cos/sin (..., rot/2)
    f32."""
    import torch
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    freqs = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                          device=positions.device)
                             / rot_dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang), rot_dim


def apply_rope(x, cos, sin, rot_dim):
    """x: (..., S, H, D); cos/sin: (S, rot/2) broadcast over batch and heads.
    Rotate-half (not interleaved), in f32: ``[y1, y2, pass]``."""
    import torch
    if rot_dim == 0:
        return x
    dt = x.dtype
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1.to(dt), y2.to(dt), xp], dim=-1)


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

def _act(name):
    import torch.nn.functional as F
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp_apply(params, x, cfg):
    act = _act(cfg.act)
    if cfg.gated_mlp:
        h = act(x @ params["wg"]) * (x @ params["wu"])
    else:
        h = x @ params["wi"]
        if "bi" in params:
            h = h + params["bi"]
        h = act(h)
    y = h @ params["wd"]
    if "bd" in params:
        y = y + params["bd"]
    return y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _softcap(s, cap):
    import torch
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


def attention_full(q, k, v, *, causal, softcap=0.0, scale=None,
                   q_offset=0):
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D), H % K == 0 → (B, Sq, H, D):
    the K8 kernel with no window. q's rows sit at positions `q_offset`..
    of k's (sequence-parallel attention; 0 and Sq == Sk otherwise)."""
    return attention(q, k, v, causal=causal, window=0, softcap=softcap,
                     scale=scale, q_offset=q_offset)


def attention_local(q, k, v, *, window, softcap=0.0, scale=None,
                    causal=True):
    """Sliding-window attention over aligned q/k positions: the K8 kernel
    with the window (both sides when not causal)."""
    return attention(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)


def attention_decode(q, k, v, *, kv_len, softcap=0.0, scale=None, lo=0,
                     groups=()):
    """One query per sequence over a (possibly ring-buffered) KV cache.
    q: (B, 1, H, D); k, v: (B, Smax, K, D) hold slots ``[lo, lo + Smax)``
    of the cache; slots below `kv_len` are valid. q is scaled in its own
    dtype; scores and the PV product accumulate in f32
    (``preferred_element_type``), p is rounded to V's dtype first.

    `groups` (process groups) split the cache's slots over their ranks:
    the softmax's max and sum and the weighted values are all-reduced over
    them, and p is normalised before it is rounded, as the one-device
    softmax is. No groups is one device."""
    import torch
    B, _, H, D = q.shape
    Smax, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale or 1.0 / math.sqrt(D)
    qf = (q.reshape(B, K, G, D) * scale).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    s = _softcap(s, softcap)
    valid = torch.arange(lo, lo + Smax, device=q.device) < int(kv_len)
    s = torch.where(valid, s, NEG_INF)
    if groups:
        from ..sharding import collectives as C
        m = s.amax(dim=-1, keepdim=True)
        for g in groups:
            m = C.all_reduce_max(m, g)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True)
        for g in groups:
            den = C.all_reduce(den, g)
        p = e / den
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    for g in groups:
        o = C.all_reduce(o, g)
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# conv positional embedding (HuBERT) and causal conv1d (mamba/rglru)
# ---------------------------------------------------------------------------

def conv_pos_embed(params, x):
    """Depthwise same-padded conv positional embedding (w2v2/HuBERT):
    ``x + gelu_tanh(conv(x))`` with the weight laid out (width, d), a
    cross-correlation in f32 over x padded by width // 2 on the left and
    width − 1 − width // 2 on the right (64 and 63 at width 128).

    Written as `width` f32 multiply-adds over views of one padded tensor:
    autograd keeps the padded tensor and the weight, not a width× stack of
    shifted copies, and every step is an elementwise op — deterministic,
    and full f32 on the card (cuDNN would run an f32 convolution in TF32
    by default). The sum runs over the taps in order."""
    import torch
    import torch.nn.functional as F
    w = params["w"]
    width, d = w.shape
    S = x.shape[1]
    left = width // 2
    xp = F.pad(x.float(), (0, 0, left, width - 1 - left))
    wf = w.float()
    pos = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        pos = pos + xp[:, i:i + S] * wf[i]
    return x + F.gelu(pos, approximate="tanh").to(x.dtype)


def causal_conv1d(x, w, b=None, *, state=None):
    """Causal depthwise conv. x: (B, S, C); w: (width, C) → (out in x's
    dtype, the new (B, width − 1, C) history). `state` (B, width − 1, C)
    is the history to prepend (decode, segmented prefill); None is a zero
    history. Accumulates in f32 tap by tap, in the JAX function's order."""
    import torch
    width = w.shape[0]
    B, S, C = x.shape
    if state is None:
        hist = x.new_zeros((B, width - 1, C))
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + S].float() * w[i].float()
    if b is not None:
        out = out + b.float()
    new_state = xp[:, S:] if width > 1 else hist
    return out.to(x.dtype), new_state
