"""HuBERT (arXiv:2106.07447) X-Large's transformer encoder as a plain
float32 model with its masked cluster-prediction loss.

The CNN front end is outside the model here, as in the program: the input
is the front end's frame embeddings (B, S, d). Then::

    x = x + gelu(depthwise conv(x))      (width 128, padded 64 left, 63
                                          right; tanh gelu)
    per layer (pre-norm, biased):
      h = LayerNorm(x);  x = x + MHA(h)  (non-causal, heads of head_dim,
                                          scale 1/sqrt(head_dim))
      h = LayerNorm(x);  x = x + gelu(h @ wi + bi) @ wd + bd
    logits = LayerNorm(x) @ lm_head

and the loss is the mean cross-entropy of the cluster labels over the
masked frames. LayerNorm's eps is 1e-5. The token embedding ``embed`` is a
leaf of the state that this model never reads. Leaves are named and
stacked (a leading layer axis) as in the state the benchmark hands the
program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_specs(c: dict) -> dict:
    d, L, V, dt = c["d_model"], c["n_layers"], c["vocab_size"], c["dtype"]
    H, hd, ff = c["n_heads"], c["head_dim"], c["d_ff"]
    s = 1 / math.sqrt(d)
    blk = "stage_0/b0/"
    spec = {
        "embed": ((V, d), 0.02, dt),
        "final_norm/bias": ((d,), "zeros", dt),
        "final_norm/scale": ((d,), "ones", dt),
        "lm_head": ((d, V), s, dt),
        "pos_conv/w": ((128, d), 0.02, dt),
    }
    for n in ("norm_in", "norm_mlp"):
        spec[blk + n + "/bias"] = ((L, d), "zeros", dt)
        spec[blk + n + "/scale"] = ((L, d), "ones", dt)
    spec.update({
        blk + "k": ((L, d, H, hd), s, dt), blk + "k_b": ((L, H, hd), "zeros", dt),
        blk + "mlp/bd": ((L, d), "zeros", dt),
        blk + "mlp/bi": ((L, ff), "zeros", dt),
        blk + "mlp/wd": ((L, ff, d), 1 / math.sqrt(ff), dt),
        blk + "mlp/wi": ((L, d, ff), s, dt),
        blk + "o": ((L, H, hd, d), 1 / math.sqrt(H * hd), dt),
        blk + "o_b": ((L, d), "zeros", dt),
        blk + "q": ((L, d, H, hd), s, dt), blk + "q_b": ((L, H, hd), "zeros", dt),
        blk + "v": ((L, d, H, hd), s, dt), blk + "v_b": ((L, H, hd), "zeros", dt),
    })
    return spec


def gelu(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(x, scale, bias):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-5)


def block(p, x, c, mm):
    b, s, d = x.shape
    H, hd = c["n_heads"], c["head_dim"]
    h = layer_norm(x, p["norm_in/scale"], p["norm_in/bias"])
    q, k, v = (mm(h, p[n].reshape(d, H * hd)).reshape(b, s, H, hd)
               + p[n + "_b"] for n in "qkv")
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    x = x + mm(o.reshape(b, s, H * hd), p["o"].reshape(H * hd, d)) + p["o_b"]
    h = layer_norm(x, p["norm_mlp/scale"], p["norm_mlp/bias"])
    y = gelu(mm(h, p["mlp/wi"]) + p["mlp/bi"])
    return x + mm(y, p["mlp/wd"]) + p["mlp/bd"]


def loss(params: dict, batch: dict, c: dict, mm=torch.matmul):
    """Mean cross-entropy of ``labels`` over the frames where ``mask`` is
    set (float32 throughout; `mm` computes every weight product)."""
    x = batch["features"].float()
    w = params["pos_conv/w"]
    width = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (width // 2, width - 1 - width // 2))
    pos = F.conv1d(xp, w.t()[:, None, :], groups=x.shape[-1])
    x = x + gelu(pos.transpose(1, 2))
    pre = "stage_0/b0/"
    layer_keys = [k for k in params if k.startswith(pre)]
    for i in range(c["n_layers"]):
        x = block({k[len(pre):]: params[k][i] for k in layer_keys}, x, c,
                  mm)
    x = layer_norm(x, params["final_norm/scale"], params["final_norm/bias"])
    logits = mm(x, params["lm_head"])
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    m = batch["mask"].float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)
