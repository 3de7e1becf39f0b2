"""The training state a model configuration implies, built on the device.

``train_state`` returns the nested dict ``{"opt": {"count", "m", "v"},
"params", "rng", "step"}`` with exactly the leaf names, shapes and dtypes of
the JAX package's ``init_train_state(Model(cfg), AdamW(), key)``: the
parameter tree of ``Model.init`` (stages from ``configs.base.build_stages``,
stacked along a leading repeat axis), AdamW's float32 ``m``/``v`` moments
and int32 ``count``, an int32 ``step`` and the two-word uint32 ``rng``.

Values come from a seeded ``torch.Generator`` on the device: parameters at
their init scales (normal × the JAX init's scale, norms at their init
value), and the moments filled with noise of a trained run's magnitude —
zeros would let the codec compress them to nothing: this is the state a
trained run holds, at full width, without training it
(``core.split_state.init_train_state`` gives a fresh run's state, zero
moments, for the trainer).
"""
from __future__ import annotations

import math

from .configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig, build_stages
from .devices import resolve_device

M_SCALE = 1e-3          # |m| of a trained AdamW run, roughly
V_SCALE = 2e-3          # v ~ (V_SCALE · N(0,1))²


def _norm(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": ((d,), "zeros")}       # (1+s) convention
    p = {"scale": ((d,), "ones")}
    if cfg.use_bias:
        p["bias"] = ((d,), "zeros")
    return p


def _mlp(cfg: ModelConfig, d: int, ff: int) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    if cfg.gated_mlp:
        p = {"wg": ((d, ff), s_in), "wu": ((d, ff), s_in),
             "wd": ((ff, d), s_out)}
    else:
        p = {"wi": ((d, ff), s_in), "wd": ((ff, d), s_out)}
        if cfg.use_bias:
            p["bi"] = ((ff,), "zeros")
    if cfg.use_bias:
        p["bd"] = ((d,), "zeros")
    return p


def _block(cfg: ModelConfig, kind: str) -> dict:
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL) or cfg.moe is not None:
        raise NotImplementedError(f"block kind {kind!r} (moe="
                                  f"{cfg.moe is not None}) is not ported")
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {"norm_in": _norm(cfg, d),
         "q": ((d, H, hd), s), "k": ((d, K, hd), s), "v": ((d, K, hd), s),
         "o": ((H, hd, d), 1.0 / math.sqrt(H * hd))}
    if cfg.use_bias:
        p.update(q_b=((H, hd), "zeros"), k_b=((K, hd), "zeros"),
                 v_b=((K, hd), "zeros"), o_b=((d,), "zeros"))
    if cfg.qk_norm:
        p["q_norm"] = _norm(cfg, hd)
        p["k_norm"] = _norm(cfg, hd)
    p["norm_mlp"] = _norm(cfg, d)
    p["mlp"] = _mlp(cfg, d, cfg.d_ff)
    if cfg.post_norm:
        p["norm_post"] = _norm(cfg, d)
        p["norm_post_mlp"] = _norm(cfg, d)
    return p


def _stack(tree: dict, repeat: int) -> dict:
    return {k: _stack(v, repeat) if isinstance(v, dict)
            else ((repeat,) + v[0], v[1]) for k, v in tree.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """Nested dict of (shape, init) per parameter leaf, where init is a
    normal's scale, ``"zeros"`` or ``"ones"`` — ``Model.init``'s tree."""
    p = {"embed": ((cfg.vocab_size, cfg.d_model), 0.02),
         "final_norm": _norm(cfg, cfg.d_model)}
    if cfg.positional == "conv":
        p["pos_conv"] = {"w": ((128, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab_size),
                        1.0 / math.sqrt(cfg.d_model))
    for si, stage in enumerate(build_stages(cfg)):
        pattern = {f"b{j}": _block(cfg, kind)
                   for j, kind in enumerate(stage.kinds)}
        p[f"stage_{si}"] = _stack(pattern, stage.repeat)
    return p


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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
    the JAX init's scale in f32, then cast to ``cfg.dtype``."""
    import torch
    dev = resolve_device(device)
    g = _generator(dev, generator, seed)
    pdt = getattr(torch, cfg.dtype)

    def init(spec):
        shape, how = spec
        if how == "zeros":
            return torch.zeros(shape, dtype=pdt, device=dev)
        if how == "ones":
            return torch.ones(shape, dtype=pdt, device=dev)
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).mul_(how).to(pdt)

    return _map(init, param_specs(cfg))


def train_state(cfg: ModelConfig, device=None, generator=None, *,
                seed: int = 0, step: int = 0) -> dict:
    """The full training state of `cfg` on `device` (``None`` → CUDA),
    from `generator` (a ``torch.Generator`` on that device; seeded with
    `seed` when None)."""
    import torch
    dev = resolve_device(device)
    g = _generator(dev, generator, seed)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32)

    specs = param_specs(cfg)
    params = init_params(cfg, dev, g)
    m = _map(lambda s: randn(s[0]).mul_(M_SCALE), specs)
    v = _map(lambda s: randn(s[0]).mul_(V_SCALE).square_(), specs)
    return {
        "params": params,
        "opt": {"m": m, "v": v,
                "count": torch.tensor(step, dtype=torch.int32, device=dev)},
        "step": torch.tensor(step, dtype=torch.int32, device=dev),
        # uint32 has few kernels: build the zeros as int32 and reinterpret
        "rng": torch.zeros(2, dtype=torch.int32, device=dev)
        .view(torch.uint32),
    }
