"""The training state a model configuration implies, built on the device.

``train_state`` returns the nested dict ``{"opt", "params", "rng",
"step"}`` with exactly the leaf names, shapes and dtypes of the JAX
package's ``init_train_state(Model(cfg), make_optimizer(cfg), key)``: the
parameter tree of ``Model.init`` (stages from ``configs.base.build_stages``,
stacked along a leading repeat axis; a MoE block's router in float32 among
the ``cfg.dtype`` leaves), the optimizer's state (AdamW's float32 ``m``/``v``
and int32 ``count``; Adafactor's float32 ``f/**/{v_row, v_col}`` or ``v``
and its ``count``), an int32 ``step`` and the two-word uint32 ``rng``.

Values come from a seeded ``torch.Generator`` on the device: parameters at
their init scales (normal × the JAX init's scale, norms at their init
value; the SSM's ``A_log``/``dt_bias`` and the RG-LRU's ``lam`` from the
JAX inits' own formulas, ``INITS``), and the optimizer's moments filled
with noise of a trained run's magnitude — zeros would let the codec
compress them to nothing: this is the state a trained run holds, at full
width, without training it (``core.split_state.init_train_state`` gives a
fresh run's state, zero moments, for the trainer).
"""
from __future__ import annotations

import math

from .configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM, ModelConfig,
                           build_stages)
from .core.split_state import map_leaves
from .devices import resolve_device
from .models.rglru import init_lam

M_SCALE = 1e-3          # |m| of a trained AdamW run, roughly
V_SCALE = 2e-3          # v ~ (V_SCALE · N(0,1))²


def _a_log(shape, g, dev):
    """``log(linspace(1, 16, nh))``: the SSM heads' decay rates, computed
    in f64 and rounded once (the same on every device; the JAX init's f32
    ``linspace`` and ``log`` land within 2 ulp of it)."""
    import torch
    a = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float64,
                       device=dev).log().float()
    return a.expand(shape).contiguous()


def _dt_bias(shape, g, dev):
    """The inverse softplus of dt = exp(U[log 1e-3, log 1e-1])."""
    import torch
    u = torch.rand(shape, generator=g, device=dev) * \
        (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
    dt0 = torch.exp(u)
    return dt0 + torch.log(-torch.expm1(-dt0))


# named inits of ``param_specs`` beside a normal's scale, "zeros", "ones":
# fn(shape, generator, device) → f32 tensor
INITS = {"a_log": _a_log, "dt_bias": _dt_bias, "lam": init_lam}


def _norm(cfg: ModelConfig, d: int) -> dict:
    dt = cfg.dtype
    if cfg.norm == "rmsnorm":
        return {"scale": ((d,), "zeros", dt)}       # (1+s) convention
    p = {"scale": ((d,), "ones", dt)}
    if cfg.use_bias:
        p["bias"] = ((d,), "zeros", dt)
    return p


def _mlp(cfg: ModelConfig, d: int, ff: int) -> dict:
    dt = cfg.dtype
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    if cfg.gated_mlp:
        p = {"wg": ((d, ff), s_in, dt), "wu": ((d, ff), s_in, dt),
             "wd": ((ff, d), s_out, dt)}
    else:
        p = {"wi": ((d, ff), s_in, dt), "wd": ((ff, d), s_out, dt)}
        if cfg.use_bias:
            p["bi"] = ((ff,), "zeros", dt)
    if cfg.use_bias:
        p["bd"] = ((d,), "zeros", dt)
    return p


def _moe(cfg: ModelConfig, d: int) -> dict:
    """``repro/models/moe.py::init_moe``: the router is float32 whatever
    ``cfg.dtype`` is; the expert stacks are (E, d, f) and (E, f, d)."""
    m, dt = cfg.moe, cfg.dtype
    E, f = m.n_experts, m.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": ((d, E), s_in, "float32"),
         "wg": ((E, d, f), s_in, dt), "wu": ((E, d, f), s_in, dt),
         "wd": ((E, f, d), s_out, dt)}
    if m.n_shared_experts:
        p["shared"] = _mlp(cfg, d, f * m.n_shared_experts)
    return p


def _ssm(cfg: ModelConfig) -> dict:
    """``repro/models/ssm.py::init_ssm``: A_log, D and dt_bias in f32."""
    c, d, dt = cfg.ssm, cfg.d_model, cfg.dtype
    d_inner = c.expand * d
    nh = d_inner // c.head_dim
    gn = c.n_groups * c.d_state
    conv_dim = d_inner + 2 * gn
    return {"in_proj": ((d, 2 * d_inner + 2 * gn + nh), 1.0 / math.sqrt(d),
                        dt),
            "conv_w": ((c.d_conv, conv_dim), 1.0 / math.sqrt(c.d_conv), dt),
            "conv_b": ((conv_dim,), "zeros", dt),
            "A_log": ((nh,), "a_log", "float32"),
            "D": ((nh,), "ones", "float32"),
            "dt_bias": ((nh,), "dt_bias", "float32"),
            "out_norm": ((d_inner,), "zeros", dt),
            "out_proj": ((d_inner, d), 1.0 / math.sqrt(d_inner), dt)}


def _rglru(cfg: ModelConfig) -> dict:
    """``repro/models/rglru.py::init_rglru``: lam and the four gate
    vectors in f32."""
    r, d, dt = cfg.rglru, cfg.d_model, cfg.dtype
    w = r.lru_width or d
    p = {"wx": ((d, w), 1.0 / math.sqrt(d), dt),
         "wg": ((d, w), 1.0 / math.sqrt(d), dt),
         "wo": ((w, d), 1.0 / math.sqrt(w), dt),
         "conv_w": ((r.conv_width, w), 1.0 / math.sqrt(r.conv_width), dt),
         "conv_b": ((w,), "zeros", dt),
         "lam": ((w,), "lam", "float32")}
    for g in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        p[g] = ((w,), "zeros", "float32")
    return p


def _block(cfg: ModelConfig, kind: str, moe: bool) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    p = {"norm_in": _norm(cfg, d)}
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        s = 1.0 / math.sqrt(d)
        p.update(q=((d, H, hd), s, dt), k=((d, K, hd), s, dt),
                 v=((d, K, hd), s, dt),
                 o=((H, hd, d), 1.0 / math.sqrt(H * hd), dt))
        if cfg.use_bias:
            p.update(q_b=((H, hd), "zeros", dt), k_b=((K, hd), "zeros", dt),
                     v_b=((K, hd), "zeros", dt), o_b=((d,), "zeros", dt))
        if cfg.qk_norm:
            p["q_norm"] = _norm(cfg, hd)
            p["k_norm"] = _norm(cfg, hd)
    elif kind == RGLRU:
        p["rglru"] = _rglru(cfg)
    else:
        p["ssm"] = _ssm(cfg)
    if kind != SSM:         # a mamba2 block has no MLP of its own
        p["norm_mlp"] = _norm(cfg, d)
        if moe:
            p["moe"] = _moe(cfg, d)
        else:
            # the dense-first layers of a MoE config (kimi-k2) take
            # dense_d_ff
            ff = cfg.d_ff if cfg.moe is None else \
                (cfg.moe.dense_d_ff or cfg.d_ff)
            p["mlp"] = _mlp(cfg, d, ff)
    if cfg.post_norm:
        p["norm_post"] = _norm(cfg, d)
        if kind != SSM:
            p["norm_post_mlp"] = _norm(cfg, d)
    return p


def _stack(tree: dict, repeat: int) -> dict:
    return {k: _stack(v, repeat) if isinstance(v, dict)
            else ((repeat,) + v[0],) + v[1:] for k, v in tree.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """Nested dict of (shape, init, dtype) per parameter leaf, where init
    is a normal's scale, ``"zeros"``, ``"ones"`` or a key of ``INITS``, and
    dtype a torch dtype name — ``Model.init``'s tree."""
    dt = cfg.dtype
    p = {"embed": ((cfg.vocab_size, cfg.d_model), 0.02, dt),
         "final_norm": _norm(cfg, cfg.d_model)}
    if cfg.positional == "conv":
        p["pos_conv"] = {"w": ((128, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab_size),
                        1.0 / math.sqrt(cfg.d_model), dt)
    for si, stage in enumerate(build_stages(cfg)):
        pattern = {f"b{j}": _block(cfg, kind, stage.moe)
                   for j, kind in enumerate(stage.kinds)}
        p[f"stage_{si}"] = _stack(pattern, stage.repeat)
    return p


def _generator(dev, generator, seed: int):
    import torch
    if generator is not None:
        return generator
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def init_params(cfg: ModelConfig, device=None, generator=None, *,
                seed: int = 0) -> dict:
    """``Model.init``'s parameter tree for `cfg` on `device` (``None`` →
    CUDA), drawn from `generator` (seeded with `seed` when None): normal ×
    the JAX init's scale in f32 (or an ``INITS`` formula), then cast to the
    leaf's dtype."""
    import torch
    dev = resolve_device(device)
    g = _generator(dev, generator, seed)

    def init(spec):
        shape, how, dt = spec
        pdt = getattr(torch, dt)
        if how == "zeros":
            return torch.zeros(shape, dtype=pdt, device=dev)
        if how == "ones":
            return torch.ones(shape, dtype=pdt, device=dev)
        if isinstance(how, str):
            return INITS[how](shape, g, dev).to(pdt)
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).mul_(how).to(pdt)

    return map_leaves(init, param_specs(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    import torch
    return map_leaves(lambda spec: torch.empty(spec[0], dtype=getattr(
        torch, spec[2]), device="meta"), param_specs(cfg))


def train_state(cfg: ModelConfig, device=None, generator=None, *,
                seed: int = 0, step: int = 0) -> dict:
    """The full training state of `cfg` on `device` (``None`` → CUDA),
    from `generator` (a ``torch.Generator`` on that device; seeded with
    `seed` when None), with the state tree of ``optim.make_optimizer(cfg)``:
    its ``count`` is `step`, its float leaves noise — AdamW's ``m`` signed,
    every second moment squared."""
    import torch

    from .optim import make_optimizer
    dev = resolve_device(device)
    g = _generator(dev, generator, seed)
    params = init_params(cfg, dev, g)

    def fill(tree, first):
        out = {}
        for k, t in tree.items():       # the optimizer's insertion order
            if isinstance(t, dict):
                out[k] = fill(t, first or k == "m")
            elif k == "count":
                out[k] = torch.tensor(step, dtype=torch.int32, device=dev)
            else:
                r = torch.randn(t.shape, generator=g, device=dev,
                                dtype=torch.float32)
                out[k] = r.mul_(M_SCALE) if first or k == "m" \
                    else r.mul_(V_SCALE).square_()
        return out

    return {
        "params": params,
        "opt": fill(make_optimizer(cfg).init(abstract_params(cfg)), False),
        "step": torch.tensor(step, dtype=torch.int32, device=dev),
        # uint32 has few kernels: build the zeros as int32 and reinterpret
        "rng": torch.zeros(2, dtype=torch.int32, device=dev)
        .view(torch.uint32),
    }
