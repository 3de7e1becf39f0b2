"""Mamba-2 SSD (state-space duality) block (``src/repro/models/ssm.py`` on
PyTorch), as plain functions over the JAX package's parameter dict.

Training and prefill run the chunked SSD algorithm: the reference's
``lax.scan`` over chunks is a Python loop here, carrying the (B, nh, hd, N)
f32 state from chunk to chunk; decode is the O(1) recurrent update. The
einsums run in f32 where the reference upcasts, and the gated
``rmsnorm(y * silu(z), out_norm)`` at width d_inner goes through
``layers.rmsnorm`` (the K7 kernel on a CUDA tensor).

One divergence by design: the intra-chunk decay block is
``exp(where(mask, seg, −inf))``, masked before the ``exp``. The reference
(``ssm.py:104-107``) writes ``where(mask, exp(seg), 0)``: its upper
triangle holds ``seg ≥ 0``, which passes f32's ``exp`` range after ~55
steps of ``dA`` near −1.6, and its backward then multiplies 0 by inf — a
NaN gradient at the real chunk size 256. The forward values are the
same (``exp(−inf) = 0`` where the reference writes 0).

Memory: autograd keeps three (B, nh, L, L) f32 blocks a chunk —
``exp``'s output, ``C·Bᵀ`` and their product, 50 MB each at B 4, 48 heads,
L 256 — beside the chunk's f32 (B, L, nh, N) head copies of B and C and
the conv taps' f32 inputs: ~2 GB a layer at 4 × 1,024 tokens. A training
forward runs each layer under ``cfg.remat_policy`` (``models.model``;
mamba2-780m's is ``nothing``, as the reference's), so only one layer's
blocks are held at a time, in its recompute: the 48-layer step fits the
card (``chip_smoke.py``'s remat phase).

On a mesh (``models.parallel``) a TP rank runs the same functions on its
own heads: ``take_heads`` cuts the packed ``in_proj`` and conv leaves to
the rank's z/x/dt columns and the B/C groups its heads read, every size
here comes from the leaves (``_sizes``), and ``norm`` takes the place of
the gated norm, which normalises whole d_inner rows.
"""
from __future__ import annotations

from .layers import causal_conv1d, rmsnorm


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nh, conv_dim


def _sizes(params, cfg):
    """(d_inner, nh, n_groups) of the heads `params` hold: all of them, or
    a rank's (``take_heads``)."""
    s = cfg.ssm
    nh = params["A_log"].shape[-1]
    d_inner = nh * s.head_dim
    return d_inner, nh, (params["conv_w"].shape[-1] - d_inner) // (
        2 * s.d_state)


def head_groups(cfg, h0: int, n: int) -> tuple:
    """The B/C groups [g0, g1) that heads [h0, h0 + n) read."""
    _, nh, _ = dims(cfg)
    rep = nh // cfg.ssm.n_groups
    return h0 // rep, (h0 + n - 1) // rep + 1


def take_heads(params, cfg, h0: int, n: int):
    """`params` (whole ``in_proj``, ``conv_w``, ``conv_b``) with those
    packed leaves cut to heads [h0, h0 + n): ``in_proj``'s columns
    ``[z | x | B | C | dt]`` and the conv's channels ``[x | B | C]`` of
    the heads and of the B/C groups they read (``head_groups``). The
    other leaves are left as given (a rank passes its own shards)."""
    d_inner, _, _ = dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    conv = conv_spans(cfg, h0, n)
    out = dict(params)
    out["in_proj"] = cut(params["in_proj"], [conv[0]] + [
        (a + d_inner, b + d_inner) for a, b in conv] + [
        (2 * d_inner + 2 * gn + h0, 2 * d_inner + 2 * gn + h0 + n)])
    out["conv_w"] = cut(params["conv_w"], conv)
    out["conv_b"] = cut(params["conv_b"], conv)
    return out


def conv_spans(cfg, h0: int, n: int) -> list:
    """The conv channels ``[x | B | C]`` of heads [h0, h0 + n) and of the
    B/C groups they read, as (start, stop) spans of the whole channels."""
    s = cfg.ssm
    d_inner, _, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    g0, g1 = head_groups(cfg, h0, n)
    return [(h0 * s.head_dim, (h0 + n) * s.head_dim)] + [
        (d_inner + o + g0 * s.d_state, d_inner + o + g1 * s.d_state)
        for o in (0, gn)]


def cut(t, spans):
    """`t`'s last dim cut to `spans` ((start, stop) pairs), concatenated."""
    import torch
    return torch.cat([t[..., a:b] for a, b in spans], dim=-1)


def _split_proj(zxbcdt, d_inner: int, gn: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: 2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xBC, dt


def _to_heads(t, rep: int):
    """(..., G, N) → (..., G·rep, N), each group repeated over its heads
    (``jnp.repeat`` on the group axis; the backward is a sum)."""
    *lead, G, N = t.shape
    return t[..., None, :].expand(*lead, G, rep, N).reshape(*lead, G * rep,
                                                              N)


def _chunk(h, xk, Bk, Ck, dtk, A, rep: int):
    """One chunk of L positions: (h carried out, y (B, L, nh, hd) f32).
    h: (B, nh, hd, N) f32; xk (B, L, nh, hd); Bk/Ck (B, L, G, N); dtk
    (B, L, nh) f32; A (nh,) f32 ≤ 0."""
    import torch
    L = xk.shape[1]
    dA = dtk * A                                    # (B, L, nh) <= 0
    cum = torch.cumsum(dA, dim=1)
    Bh = _to_heads(Bk, rep).float()                 # (B, L, nh, N)
    Ch = _to_heads(Ck, rep).float()
    xdt = xk.float() * dtk[..., None]               # (B, L, nh, hd)
    # intra-chunk (quadratic within the chunk)
    cb = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
    seg = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)
    mask = torch.ones((L, L), dtype=torch.bool, device=xk.device).tril()
    M = torch.exp(torch.where(mask, seg, float("-inf")))
    y = torch.einsum("bhij,bjhp->bihp", cb * M, xdt)
    # inter-chunk contribution of the carried state
    y = y + torch.einsum("bihn,bhpn->bihp", Ch * torch.exp(cum)[..., None], h)
    # state update
    w = torch.exp(cum[:, -1:, :] - cum)             # (B, L, nh)
    s_c = torch.einsum("bjhn,bjhp->bhpn", Bh * w[..., None], xdt)
    h = torch.exp(cum[:, -1])[..., None, None] * h + s_c
    return h, y


def ssd_forward(params, x, cfg, *, state=None, return_state=False,
                norm=None):
    """x: (B, S, D) → y (B, S, D) [, new_state].

    state = {"conv": (B, w−1, conv_dim), "h": (B, nh, hd, N) f32} or None.
    S must be a multiple of min(chunk_size, S), as in the reference.
    `norm(g, out_norm)` (default ``layers.rmsnorm``) normalises the gated
    ``g = y · silu(z)``. On a rank's heads (``take_heads``, its rows of
    ``out_proj``) the output is the rank's partial sum."""
    import torch
    import torch.nn.functional as F
    s = cfg.ssm
    B, S, D = x.shape
    d_inner, nh, G = _sizes(params, cfg)
    N, hd, L = s.d_state, s.head_dim, s.chunk_size
    L = min(L, S)
    assert S % L == 0, (S, L)
    nc = S // L

    zxbcdt = x @ params["in_proj"]
    z, xBC, dtr = _split_proj(zxbcdt, d_inner, G * N)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = causal_conv1d(xBC, params["conv_w"], params["conv_b"],
                                  state=conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :d_inner].reshape(B, S, nh, hd)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dtr.float() + params["dt_bias"])        # (B, S, nh)
    A = -torch.exp(params["A_log"])                          # (nh,)

    h = torch.zeros((B, nh, hd, N), dtype=torch.float32, device=x.device) \
        if state is None else state["h"].float()
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        h, yc = _chunk(h, xs[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl], A,
                       nh // G)
        ys.append(yc)
    y = torch.cat(ys, dim=1)                                 # (B, S, nh, hd)
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = (norm or rmsnorm)(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"]
    if return_state:
        return out, {"conv": new_conv, "h": h}
    return out


def ssd_decode_step(params, x, cfg, state, *, norm=None):
    """x: (B, 1, D); state {"conv", "h"} → (y (B, 1, D), new_state): new
    tensors, the caller's state is not written. `norm` as
    ``ssd_forward``'s."""
    import torch
    import torch.nn.functional as F
    s = cfg.ssm
    B = x.shape[0]
    d_inner, nh, G = _sizes(params, cfg)
    N, hd = s.d_state, s.head_dim

    zxbcdt = x @ params["in_proj"]
    z, xBC, dtr = _split_proj(zxbcdt, d_inner, G * N)
    xBC, new_conv = causal_conv1d(xBC, params["conv_w"], params["conv_b"],
                                  state=state["conv"])
    xBC = F.silu(xBC)
    xs = xBC[:, 0, :d_inner].reshape(B, nh, hd)
    Bm = xBC[:, 0, d_inner:d_inner + G * N].reshape(B, G, N)
    Cm = xBC[:, 0, d_inner + G * N:].reshape(B, G, N)
    dt = F.softplus(dtr[:, 0].float() + params["dt_bias"])  # (B, nh)
    A = -torch.exp(params["A_log"])
    rep = nh // G
    Bh = _to_heads(Bm, rep).float()                          # (B, nh, N)
    Ch = _to_heads(Cm, rep).float()
    dA = torch.exp(dt * A)
    xdt = xs.float() * dt[..., None]                         # (B, nh, hd)
    h = dA[..., None, None] * state["h"] + \
        torch.einsum("bhn,bhp->bhpn", Bh, xdt)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = (norm or rmsnorm)(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"]
    return out, {"conv": new_conv, "h": h}


def init_ssm_state(cfg, batch, *, device=None):
    """Zero decode state: conv history in the params' dtype, h in f32."""
    import torch
    s = cfg.ssm
    d_inner, nh, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "h": torch.zeros((batch, nh, s.head_dim, s.d_state),
                         dtype=torch.float32, device=device),
    }
