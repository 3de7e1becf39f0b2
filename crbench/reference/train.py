"""The plain reference of a training step: the model's loss and
gradients in float32 (autograd over ``reference.<model>.loss``), the
gradients clipped by their global norm, and AdamW with decoupled weight
decay on matrices, each parameter rounded to the dtype it is stored in.
The recipe (betas, eps, decay, clip, learning-rate schedule) is the
configuration's ``recipe``.

``mm`` is the weight product: ``torch.matmul`` in float32 with TF32 off
for the reference; ``fp8_matmul`` (both operands rounded to float8 e4m3
with one scale each) for the control, the next precision below the
configuration's bfloat16."""
from __future__ import annotations

import math

import torch


def _fp8(t, dtype=torch.float8_e4m3fn):
    """`t` rounded to float8 with one scale for the tensor."""
    top = torch.finfo(dtype).max
    s = t.abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).to(torch.float32) * s


class _Fp8MatMul(torch.autograd.Function):
    """a (..., k) @ b (k, n) with every product of the forward and the
    backward taken over float8 operands: e4m3 for activations and
    weights, e5m2 for gradients (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = qg @ qb.t()
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8MatMul.apply(a, b)


def lr_at(recipe: dict, step: int) -> float:
    """Linear warm-up from peak/warmup, then cosine to floor·peak."""
    peak, warm = recipe["lr_peak"], recipe["warmup"]
    if step < warm:
        return peak * (step + 1) / warm
    frac = min(max((step - warm) / max(recipe["total"] - warm, 1), 0.0), 1.0)
    fl = recipe["lr_floor"]
    return peak * (fl + (1 - fl) * 0.5 * (1 + math.cos(math.pi * frac)))


def loss_and_grads(model, params: dict, batch: dict, c: dict, mm):
    live = {n: p.detach().requires_grad_() for n, p in params.items()}
    loss = model.loss(live, batch, c, mm)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(live.items(), grads)}


def train(model, c: dict, weights: dict, batches, mm=torch.matmul) -> dict:
    """Run ``len(batches)`` steps from `weights` ({name: tensor in its
    stored dtype}, a fresh optimizer state). Returns the loss of each
    step, each leaf's norm of the first clipped gradient (``grad``) and
    of its change over all the steps (``change``)."""
    r = c["recipe"]
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dtypes = {n: w.dtype for n, w in weights.items()}
        p = {n: w.float() for n, w in weights.items()}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        out = {"loss": []}
        for i, batch in enumerate(batches):
            loss, g = loss_and_grads(model, p, batch, c, mm)
            out["loss"].append(float(loss))
            norm = torch.sqrt(sum(t.square().sum() for t in g.values()))
            scale = torch.clamp(r["clip_norm"] / norm.clamp(min=1e-9),
                                max=1.0)
            g = {n: t * scale for n, t in g.items()}
            if i == 0:
                out["grad"] = {n: float(t.norm()) for n, t in g.items()}
            lr = lr_at(r, i)
            bc1, bc2 = 1 - r["b1"] ** (i + 1), 1 - r["b2"] ** (i + 1)
            with torch.no_grad():
                for n in p:
                    m[n].mul_(r["b1"]).add_((1 - r["b1"]) * g[n])
                    v[n].mul_(r["b2"]).add_((1 - r["b2"]) * g[n].square())
                    upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + r["eps"])
                    if p[n].dim() >= 2:
                        upd = upd + r["weight_decay"] * p[n]
                    p[n] = (p[n] - lr * upd).to(dtypes[n]).float()
            del g
        out["change"] = {n: float((p[n] - weights[n].float()).norm())
                         for n in p}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
