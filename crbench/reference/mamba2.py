"""Mamba-2 (arXiv:2405.21060) as a plain float32 language model: the
parameter tree of a training state and the next-token loss.

Each layer is one Mamba-2 block, pre-normed and residual::

    h = rmsnorm(x) · (1 + norm_in)                      (eps 1e-6)
    z | xBC | dt = h @ in_proj
    xBC = silu(causal depthwise conv(xBC) + conv_b)     (width d_conv)
    x, B, C = xBC;  dt = softplus(dt + dt_bias);  A = −exp(A_log)
    y = SSD(x·dt, A·dt, B, C) + D·x                     (per head)
    y = rmsnorm(y · silu(z)) · (1 + out_norm)           (eps 1e-6)
    x = x + y @ out_proj

and the model is ``embed → layers → rmsnorm · (1 + final_norm) → @
embedᵀ`` (tied), with the mean cross-entropy of each position's next
token. SSD is the chunked state-space dual of the paper's listing
("ssd_minimal"): within a chunk the quadratic form masked by the decay
segment sums, between chunks a recurrence over the chunk states. The
leaves keep the names and the stacked layout (a leading layer axis) of
the state that the benchmark hands the program, so that one set of
weights feeds both."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sizes(c: dict) -> dict:
    s = c["ssm"]
    d_inner = s["expand"] * c["d_model"]
    nh = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return {"d_inner": d_inner, "nh": nh, "gn": gn,
            "conv": d_inner + 2 * gn, "proj": 2 * d_inner + 2 * gn + nh}


def param_specs(c: dict) -> dict:
    """{leaf name: (shape, init, dtype)}; init is a normal's scale,
    "zeros", "ones", "a_log" or "dt_bias" (the Mamba-2 initialisation:
    A from 1 to 16 over the heads, dt log-uniform in [1e-3, 1e-1])."""
    d, L, V, dt = c["d_model"], c["n_layers"], c["vocab_size"], c["dtype"]
    z = sizes(c)
    k = c["ssm"]["d_conv"]
    blk = "stage_0/b0/"
    return {
        "embed": ((V, d), 0.02, dt),
        "final_norm/scale": ((d,), "zeros", dt),
        blk + "norm_in/scale": ((L, d), "zeros", dt),
        blk + "ssm/A_log": ((L, z["nh"]), "a_log", "float32"),
        blk + "ssm/D": ((L, z["nh"]), "ones", "float32"),
        blk + "ssm/conv_b": ((L, z["conv"]), "zeros", dt),
        blk + "ssm/conv_w": ((L, k, z["conv"]), 1 / math.sqrt(k), dt),
        blk + "ssm/dt_bias": ((L, z["nh"]), "dt_bias", "float32"),
        blk + "ssm/in_proj": ((L, d, z["proj"]), 1 / math.sqrt(d), dt),
        blk + "ssm/out_norm": ((L, z["d_inner"]), "zeros", dt),
        blk + "ssm/out_proj": ((L, z["d_inner"], d),
                               1 / math.sqrt(z["d_inner"]), dt),
    }


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1 + scale)


def segsum(a):
    """a: (..., T) → (..., T, T): entry (i, j) the sum of a[j+1..i] for
    j ≤ i, −inf above the diagonal."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    s = torch.cumsum(a.masked_fill(~below, 0), dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, chunk):
    """X (b, l, h, p), A (b, l, h), B and C (b, l, h, n) → Y (b, l, h, p):
    y_i = Σ_{j ≤ i} C_i·B_j · exp(A_{j+1} + … + A_i) · X_j."""
    b, l, h, p = X.shape
    c = l // chunk
    X = X.reshape(b, c, chunk, h, p)
    B = B.reshape(b, c, chunk, h, -1)
    C = C.reshape(b, c, chunk, h, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)       # (b, h, c, l)
    cum = torch.cumsum(A, dim=-1)
    Ldec = torch.exp(segsum(A))                             # (b, h, c, l, s)
    cb = torch.einsum("bclhn,bcshn->bhcls", C, B)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb * Ldec, X)
    decay = torch.exp(cum[..., -1:] - cum)                  # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, l, h, p)


def block(p, x, c, mm):
    s, z = c["ssm"], sizes(c)
    b, l, _ = x.shape
    di, gn, nh, hd = z["d_inner"], z["gn"], z["nh"], s["head_dim"]
    h = rmsnorm(x, p["norm_in/scale"])
    zxbcdt = mm(h, p["ssm/in_proj"])
    gate, xbc, dt = zxbcdt.split([di, di + 2 * gn, nh], dim=-1)
    k = s["d_conv"]
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                   p["ssm/conv_w"].t()[:, None, :], p["ssm/conv_b"],
                   groups=z["conv"]).transpose(1, 2)
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc.split([di, gn, gn], dim=-1)
    xs = xs.reshape(b, l, nh, hd)
    rep = nh // s["n_groups"]
    Bm = Bm.reshape(b, l, s["n_groups"], 1, -1).expand(
        -1, -1, -1, rep, -1).reshape(b, l, nh, -1)
    Cm = Cm.reshape(b, l, s["n_groups"], 1, -1).expand(
        -1, -1, -1, rep, -1).reshape(b, l, nh, -1)
    dt = F.softplus(dt + p["ssm/dt_bias"])
    A = -torch.exp(p["ssm/A_log"])
    y = ssd(xs * dt[..., None], dt * A, Bm, Cm, min(s["chunk_size"], l))
    y = (y + p["ssm/D"][:, None] * xs).reshape(b, l, di)
    y = rmsnorm(y * F.silu(gate), p["ssm/out_norm"])
    return x + mm(y, p["ssm/out_proj"])


def loss(params: dict, batch: dict, c: dict, mm=torch.matmul):
    """Mean next-token cross-entropy over positions 0..S−2 (float32
    throughout; `mm` computes every weight product)."""
    tokens = batch["tokens"].long()
    x = params["embed"][tokens]
    pre = "stage_0/b0/"
    layer_keys = [k for k in params if k.startswith(pre)]
    for i in range(c["n_layers"]):
        x = block({k[len(pre):]: params[k][i] for k in layer_keys}, x, c,
                  mm)
    x = rmsnorm(x, params["final_norm/scale"])
    logits = mm(x[:, :-1], params["embed"].t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
