"""The model zoo (``src/repro/models/model.py``) — the attention families,
dense and MoE, the Mamba-2 SSM, the RG-LRU hybrid and the encoder — as
plain functions over the JAX package's nested parameter dict.

    model = Model(cfg)
    params              = model.init(seed=0, device=None)
    last_logits, cache  = model.prefill(params, tokens, cache_len=...)
    logits, cache       = model.decode_step(params, cache, tokens)
    cache               = model.init_cache(batch, cache_len)
    logits              = model.encode(params, features)      (encoder)

Parameters keep the JAX layout — ``stage_{i}`` subtrees whose leaves are
stacked along a leading repeat axis — and the decode cache keeps the JAX
cache tree (``pos`` plus ``stage_{i}/b{j}/{k,v}`` for attention blocks and
``stage_{i}/b{j}/{conv,h}`` for SSM and RG-LRU blocks, stacked the same
way), so a serving checkpoint's leaf names, shapes and dtypes are the JAX
package's one for one and either package resumes the other's. ``lax.scan``
over a stage's repeats becomes a Python loop over the leading axis.

    loss, metrics       = model.loss(params, {"tokens": tokens})
    loss, metrics       = model.loss(params, {"features", "labels", "mask"})

MoE stages route their MLP through ``models.moe.moe_apply``: a prefill or
training forward groups its B·S tokens in groups of up to 4,096, a decode
step groups the batch, so the capacities differ as in JAX. ``loss`` adds
``aux_loss_weight · load_balance_loss + 1e-4 · router_z_loss`` and reports
the three aux values, each summed over the MoE layers.

On a mesh, as in the reference, ``set_constrainer(act_constrainer(cfg,
mesh))`` installs the activation layout (the ``Trainer`` does) and
``set_exec_mesh(mesh)`` the mesh of the explicit expert-parallel MoE
(``moe_impl="shard_map"``; the ``Trainer`` never sets it, as the
reference's does not). With a layout installed, ``loss`` takes each rank's
local parameter shards and computes the training forward with that layout
(``models.parallel``): the same function, no rank holding the whole
parameter tree.

Deviations, each named where it happens: ``decode_step`` writes the new
key/value, and an SSM or RG-LRU block's new conv history and state, into
the cache tensors in place and returns the same tree (the JAX version
returns new arrays); ``init`` draws from a ``torch.Generator``
(other values than ``jax.random`` from the same seed — move weights across
with ``convert.params_from_jax``); the SSD chunk masks its decay block
before the ``exp`` (``models/ssm.py``: the reference's gradient is NaN at
chunk 256).

Rematerialisation follows ``cfg.remat_policy`` as the reference's
``jax.checkpoint`` over each scan step does: the unit is one repeat of a
stage (every block of ``stage.kinds``: six for gemma3-1b, three for
recurrentgemma-9b), run by ``_resolve_policy(name)``:

* ``nothing`` — ``torch.utils.checkpoint`` (non-reentrant): autograd keeps
  the unit's input, and the backward runs the unit again;
* ``dots`` — the same with selective checkpointing: the outputs of the
  products with no batch dims (``mm``, ``addmm``, a ``bmm``/``baddbmm``
  of batch 1) that the recompute reaches are kept, everything else is
  recomputed, as ``dots_with_no_batch_dims_saveable``;
* ``full`` — no wrapper: every activation is kept;
* ``offload_resid`` — nothing kept on the device: the unit's input is
  copied to (pinned) host memory, the unit is checkpointed on that copy,
  and the backward copies it back before it recomputes.

``loss`` and ``encode`` apply it while grad is enabled (serving's
``encode``, ``prefill`` and ``decode_step`` never recompute); the layout
step (``models.parallel``) takes its per-layer wrapper from the same
function.
"""
from __future__ import annotations

import math

from ..configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM, ModelConfig,
                            build_stages)
from ..devices import resolve_device
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import (_softcap, apply_norm, apply_rope, attention_decode,
                     attention_full, attention_local, conv_pos_embed,
                     mlp_apply, rmsnorm, rope_table)
from .moe import moe_apply

ATTN = (ATTN_GLOBAL, ATTN_LOCAL)

# the activation layout of a mesh (``sharding.partition.ActLayout``),
# installed by the Trainer; None keeps the model mesh-free
_constrain = None

# the mesh of the explicit expert-parallel MoE (``moe_shard_map``); None
# routes every MoE layer through ``moe_apply``
_exec = {"mesh": None, "ax": None}


def set_constrainer(layout):
    global _constrain
    _constrain = layout


def set_exec_mesh(mesh):
    if mesh is None:
        _exec["mesh"] = _exec["ax"] = None
    else:
        from ..sharding.partition import mesh_axes
        _exec["mesh"] = mesh
        _exec["ax"] = mesh_axes(mesh)


# ---------------------------------------------------------------------------
# rematerialisation (``src/repro/models/model.py::REMAT_POLICIES``)
# ---------------------------------------------------------------------------

def _full(fn, x, *args):
    return fn(x, *args)


def _nothing(fn, x, *args):
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, x, *args, use_reentrant=False)


def dots_saveable(func, args) -> bool:
    """Whether ``dots`` keeps the output of operator `func` on `args`: a
    product with no batch dims. A projection ``x @ w`` dispatches as
    ``mm``, an einsum against a 2-D weight as a ``bmm`` of batch 1; the MoE
    expert GEMMs and the SSD einsums are ``bmm``s over real batch dims,
    and JAX keeps none of those (``dots_with_no_batch_dims_saveable``)."""
    import torch
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default):
        return True
    if func is aten.bmm.default:
        return args[0].shape[0] == 1
    if func is aten.baddbmm.default:
        return args[1].shape[0] == 1
    return False


def _dots_contexts():
    """The (forward, recompute) contexts of ``dots``'s checkpoint: the
    selective checkpointing of ``create_selective_checkpoint_contexts``
    with ``dots_saveable`` as its policy, and one difference. The
    non-reentrant recompute stops at the last tensor the backward saves
    (early stop), so a product after it — a unit's last projection, whose
    output only joins the residual — is never replayed; the forward counts
    autograd's saves through a hook over the checkpoint's own and drops
    the outputs past the last one, which JAX's partial evaluation never
    keeps either. A kept output replays the product in the recompute; a
    dropped one, or any other operator, runs again."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    store, seen = {}, {"ops": 0, "cut": 0}

    def key(counts, func):
        i = counts.get(func, 0)
        counts[func] = i + 1
        return func, i

    class Save(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen["ops"] += 1
            if dots_saveable(func, args):
                t = out.detach()
                store[key(self.counts, func)] = (seen["ops"], t, t._version)
            return out

    class Replay(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if dots_saveable(func, args):
                hit = store.pop(key(self.counts, func), None)
                if hit is not None:
                    if hit[1]._version != hit[2]:
                        raise RuntimeError(
                            f"dots: the saved output of {func} was changed "
                            "in place after the forward")
                    return hit[1]
            return func(*args, **(kwargs or {}))

    class Forward:
        def __enter__(self):
            top = torch._C._autograd._top_saved_tensors_default_hooks(False)
            pack, unpack = top

            def counted(t):
                seen["cut"] = seen["ops"]
                return pack(t)

            self.hooks = torch.autograd.graph.saved_tensors_hooks(counted,
                                                                 unpack)
            self.mode = Save()
            self.hooks.__enter__()
            self.mode.__enter__()

        def __exit__(self, *exc):
            self.mode.__exit__(*exc)
            self.hooks.__exit__(*exc)
            for k in [k for k, v in store.items() if v[0] > seen["cut"]]:
                del store[k]

    return Forward(), Replay()


def _dots(fn, x, *args):
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, x, *args, use_reentrant=False,
                      context_fn=_dots_contexts)


def _offload_resid(fn, x, *args):
    """Checkpoint the unit on a host copy of its input (pinned when `x`
    lies on the card): autograd keeps only that copy, whose gradient flows
    back to `x` through the copy; the parameters stay where they are."""
    import torch
    from torch.utils.checkpoint import checkpoint
    host = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                       pin_memory=x.is_cuda)
    host.copy_(x, non_blocking=x.is_cuda)
    dev = x.device

    def unit(h, *a):
        return fn(h.to(dev, non_blocking=True), *a)

    return checkpoint(unit, host, *args, use_reentrant=False)


REMAT_POLICIES = {
    "nothing": _nothing,
    "dots": _dots,
    "full": _full,
    "offload_resid": _offload_resid,
}


def _resolve_policy(name):
    """`name` → ``run(fn, x, *args)``, which returns ``fn(x, *args)`` and
    keeps for the backward what the policy keeps (an unknown name raises
    ``KeyError``, as the reference's lookup does)."""
    return REMAT_POLICIES[name]


def remat(cfg):
    """The unit runner of a training forward: ``cfg.remat_policy``'s
    while grad is enabled, else none (serving never recomputes)."""
    import torch
    run = _resolve_policy(cfg.remat_policy)
    return run if torch.is_grad_enabled() else _full


def _unstack(tree, repeat: int) -> list:
    """A stage subtree stacked along its leading axis → one subtree per
    layer (``unbind`` views: the gradient of each stacked leaf is one
    ``stack`` of its layers' gradients)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, repeat) for k, v in tree.items()}
        return [{k: subs[k][r] for k in subs} for r in range(repeat)]
    return tree.unbind(0)


def _index(tree, r: int):
    """Layer `r` of a stage subtree stacked along its leading axis
    (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.stages = build_stages(cfg)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, generator=None, *, seed: int = 0, device=None):
        """The parameter tree of the JAX ``Model.init`` (names, shapes,
        dtypes and init scales) on `device` (``None`` → CUDA)."""
        from ..state import init_params
        return init_params(self.cfg, device, generator, seed=seed)

    def abstract_params(self):
        """The parameter tree as meta tensors (shapes and dtypes only), for
        a restore target."""
        from ..state import abstract_params
        return abstract_params(self.cfg)

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _ropes(self, positions):
        """Rope tables per attention kind, once per forward."""
        cfg = self.cfg
        out = {}
        if cfg.positional != "rope":
            return out
        kinds = set(cfg.layer_kinds)
        if ATTN_GLOBAL in kinds:
            out[ATTN_GLOBAL] = rope_table(positions, cfg.head_dim,
                                          cfg.rope_theta, cfg.rope_pct)
        if ATTN_LOCAL in kinds:
            theta = cfg.rope_theta_local or cfg.rope_theta
            out[ATTN_LOCAL] = rope_table(positions, cfg.head_dim, theta,
                                         cfg.rope_pct)
        return out

    def _qkv(self, p, x, kind, ropes):
        return tuple(self._proj(p, x, n, kind, ropes) for n in "qkv")

    def _proj(self, p, x, name, kind, ropes):
        """One of q, k, v: einsum("bsd,dhk->bshk") with its bias, norm (q
        and k) and rope (q and k; the tables' rows are x's positions)."""
        cfg = self.cfg
        B, S, d = x.shape
        w = p[name]
        t = (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])
        if cfg.use_bias and f"{name}_b" in p:
            t = t + p[f"{name}_b"]
        if name == "v":
            return t
        if cfg.qk_norm:
            t = rmsnorm(t, p[f"{name}_norm"]["scale"])
        rope = ropes.get(kind)
        if rope is not None:
            t = apply_rope(t, *rope)
        return t

    def _out(self, p, o):
        """einsum("bshk,hkd->bsd") plus the output bias."""
        B, S, H, hd = o.shape
        out = o.reshape(B, S, H * hd) @ p["o"].reshape(H * hd, -1)
        if self.cfg.use_bias and "o_b" in p:
            out = out + p["o_b"]
        return out

    def _attn_sequence(self, p, x, kind, ropes):
        """Full-sequence attention (prefill): (out, (k, v))."""
        cfg = self.cfg
        q, k, v = self._qkv(p, x, kind, ropes)
        common = dict(softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
        if kind == ATTN_LOCAL:
            o = attention_local(q, k, v, window=cfg.window, causal=cfg.causal,
                                **common)
        else:
            o = attention_full(q, k, v, causal=cfg.causal, **common)
        return self._out(p, o), (k, v)

    def _mlp_part(self, p, x, moe):
        """The block's MLP half: (y, aux); aux is the MoE's three values,
        or empty for a dense MLP."""
        cfg = self.cfg
        h = apply_norm(p["norm_mlp"], x, cfg)
        if moe:
            y, aux = moe_apply(p["moe"], h, cfg)
        else:
            y, aux = mlp_apply(p["mlp"], h, cfg), {}
        if cfg.post_norm:
            y = apply_norm(p["norm_post_mlp"], y, cfg)
        return y, aux

    def _block_sequence(self, p, x, kind, moe, ropes, cache_len):
        """One block over a full sequence: (x, aux, this block's cache;
        None when `cache_len` is None, as in training). An SSM block has no
        MLP half."""
        cfg = self.cfg
        h = apply_norm(p["norm_in"], x, cfg)
        want = cache_len is not None
        new_cache = None
        if kind in ATTN:
            o, (k, v) = self._attn_sequence(p, h, kind, ropes)
            if want:
                new_cache = self._build_attn_cache(kind, k, v, cache_len)
        else:
            key, fwd = ("rglru", rglru_mod.rglru_forward) if kind == RGLRU \
                else ("ssm", ssm_mod.ssd_forward)
            o = fwd(p[key], h, cfg, return_state=want)
            if want:
                o, new_cache = o
        if cfg.post_norm:
            o = apply_norm(p["norm_post"], o, cfg)
        x = x + o
        if kind == SSM:
            return x, {}, new_cache
        y, aux = self._mlp_part(p, x, moe)
        return x + y, aux, new_cache

    def _build_attn_cache(self, kind, k, v, cache_len):
        """Prefill K/V → a decode cache of capacity cache_len: a ring
        buffer of W = min(window, cache_len) slots for local attention,
        positions S-n..S-1 at slots (S-n..S-1) % W."""
        import torch
        B, S, K, hd = k.shape
        if kind == ATTN_LOCAL:
            W = min(self.cfg.window, cache_len)
            n = min(S, W)
            slots = torch.arange(S - n, S, device=k.device) % W
            out = {}
            for name, t in (("k", k), ("v", v)):
                c = torch.zeros((B, W, K, hd), dtype=t.dtype, device=t.device)
                c[:, slots] = t[:, S - n:]
                out[name] = c
            return out
        out = {}
        for name, t in (("k", k), ("v", v)):
            c = torch.zeros((B, cache_len, K, hd), dtype=t.dtype,
                            device=t.device)
            n = min(S, cache_len)
            c[:, :n] = t[:, :n]
            out[name] = c
        return out

    def _block_decode(self, p, x, kind, moe, cache, pos, ropes):
        """One block for a single token; writes the new key/value (or the
        new conv history and state) into `cache` (this layer's views) in
        place. A MoE block's group is the batch (its capacity is the decode
        step's own, as in JAX)."""
        cfg = self.cfg
        h = apply_norm(p["norm_in"], x, cfg)
        if kind in ATTN:
            o = self._attn_decode(p, h, kind, cache, pos, ropes)
        else:
            key, step = ("rglru", rglru_mod.rglru_decode_step) \
                if kind == RGLRU else ("ssm", ssm_mod.ssd_decode_step)
            o, new = step(p[key], h, cfg, cache)
            for name, t in new.items():
                cache[name].copy_(t)
        if cfg.post_norm:
            o = apply_norm(p["norm_post"], o, cfg)
        x = x + o
        if kind == SSM:
            return x
        return x + self._mlp_part(p, x, moe)[0]

    def _attn_decode(self, p, h, kind, cache, pos, ropes):
        cfg = self.cfg
        q, k, v = self._qkv(p, h, kind, ropes)
        cap = cache["k"].shape[1]
        if kind == ATTN_LOCAL:
            slot, kv_len = pos % cap, min(pos + 1, cap)
        else:
            # dynamic_update_slice clamps a start past the end
            slot, kv_len = min(pos, cap - 1), pos + 1
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = attention_decode(q, cache["k"], cache["v"], kv_len=kv_len,
                             softcap=cfg.attn_softcap,
                             scale=cfg.attn_scale or None)
        return self._out(p, o)

    # ------------------------------------------------------------------
    # stages (the JAX scan over stacked layers → a loop over the axis)
    # ------------------------------------------------------------------
    def _run_stages_sequence(self, params, x, positions, cache_len):
        import torch
        ropes = self._ropes(positions)
        caches = {}
        for si, stage in enumerate(self.stages):
            sp = params[f"stage_{si}"]
            per_layer = []
            for r in range(stage.repeat):
                layer_p = _index(sp, r)
                new_c = {}
                for j, kind in enumerate(stage.kinds):
                    x, _, new_c[f"b{j}"] = self._block_sequence(
                        layer_p[f"b{j}"], x, kind, stage.moe, ropes,
                        cache_len)
                per_layer.append(new_c)
            caches[f"stage_{si}"] = {
                f"b{j}": {n: torch.stack([c[f"b{j}"][n] for c in per_layer])
                          for n in per_layer[0][f"b{j}"]}
                for j in range(len(stage.kinds))}
        return x, caches

    def _run_stages_train(self, params, x, positions):
        """(x, aux): each repeat of a stage is one unit under ``remat``
        (the JAX scan step under ``jax.checkpoint``); aux sums each MoE
        value over a unit's blocks, then over the units, as the JAX scan's
        per-stage sums do."""
        ropes = self._ropes(positions)
        run = remat(self.cfg)
        aux_tot = {}
        for si, stage in enumerate(self.stages):
            def unit(x, layer_p, _stage=stage):
                auxs = {}
                for j, kind in enumerate(_stage.kinds):
                    x, aux, _ = self._block_sequence(
                        layer_p[f"b{j}"], x, kind, _stage.moe, ropes, None)
                    for k, v in aux.items():
                        auxs[k] = auxs[k] + v if k in auxs else v
                return x, auxs

            for layer_p in _unstack(params[f"stage_{si}"], stage.repeat):
                x, aux = run(unit, x, layer_p)
                for k, v in aux.items():
                    aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
        return x, aux_tot

    def _run_stages_decode(self, params, cache, x, pos: int):
        import torch
        ropes = self._ropes(torch.tensor([pos], device=x.device))
        for si, stage in enumerate(self.stages):
            sp, sc = params[f"stage_{si}"], cache[f"stage_{si}"]
            for r in range(stage.repeat):
                layer_p, layer_c = _index(sp, r), _index(sc, r)
                for j, kind in enumerate(stage.kinds):
                    x = self._block_decode(layer_p[f"b{j}"], x, kind,
                                           stage.moe, layer_c[f"b{j}"], pos,
                                           ropes)
        return x

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        import torch
        import torch.nn.functional as F

        # the gather's backward sums rows in a fixed order on the card
        # (sorted indices), unlike an index_put_ with accumulation
        x = F.embedding(tokens.long(), params["embed"])
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _head_weights(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits_last(self, params, x_last):
        """x_last: (B, d) → (B, V) f32 logits: the product of the bf16 (or
        f32) inputs accumulated and returned in f32, as
        ``preferred_element_type=float32`` asks (a bf16 matmul would round
        its output to bf16)."""
        w = self._head_weights(params)
        return _softcap(x_last.float() @ w.float(), self.cfg.final_softcap)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def prefill(self, params, tokens, *, cache_len=0):
        """tokens: (B, S) ints → (last_logits (B, V) f32, cache)."""
        import torch
        B, S = tokens.shape
        cache_len = cache_len or S
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        x, caches = self._run_stages_sequence(params, x, positions, cache_len)
        x = apply_norm(params["final_norm"], x, self.cfg)
        logits = self._logits_last(params, x[:, -1])
        caches["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return logits, caches

    def decode_step(self, params, cache, tokens):
        """tokens: (B,) ints; cache from prefill/init_cache (updated in
        place: its k/v tensors take the new entries, ``pos`` is replaced)
        → (logits (B, V) f32, cache)."""
        pos = int(cache["pos"])
        x = self._embed(params, tokens[:, None])
        x = self._run_stages_decode(params, cache, x, pos)
        x = apply_norm(params["final_norm"], x, self.cfg)
        logits = self._logits_last(params, x[:, 0])
        cache["pos"] = cache["pos"] + 1
        return logits, cache

    def init_cache(self, batch, cache_len, *, device=None):
        """Zero cache of the prefill's tree (``device="meta"`` gives a
        restore target without allocating)."""
        import torch
        cfg = self.cfg
        dev = device if device == "meta" else resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        caches = {"pos": torch.tensor(0, dtype=torch.int32, device=dev)}
        for si, stage in enumerate(self.stages):
            sc = {}
            R = stage.repeat
            for j, kind in enumerate(stage.kinds):
                if kind in ATTN:
                    n = min(cfg.window, cache_len) \
                        if kind == ATTN_LOCAL else cache_len
                    shp = (R, batch, n, cfg.n_kv_heads, cfg.head_dim)
                    sc[f"b{j}"] = {
                        "k": torch.zeros(shp, dtype=dt, device=dev),
                        "v": torch.zeros(shp, dtype=dt, device=dev)}
                    continue
                st = (rglru_mod.init_rglru_state if kind == RGLRU
                      else ssm_mod.init_ssm_state)(cfg, batch, device="meta")
                sc[f"b{j}"] = {n: torch.zeros((R,) + tuple(t.shape),
                                              dtype=t.dtype, device=dev)
                               for n, t in st.items()}
            caches[f"stage_{si}"] = sc
        return caches

    def loss(self, params, batch):
        """batch: {"tokens": (B, S) ints} → (loss, metrics): the mean
        next-token NLL over the first S−1 positions, through
        ``chunked_xent`` in 512-token chunks, plus a MoE model's weighted
        aux losses. Metrics: ``nll``, ``loss`` and, with MoE stages, the
        three aux values. With a layout installed (``set_constrainer``),
        `params` are this rank's local shards and the result is the loss of
        its batch rows (``train.steps._layout_step`` sums the ranks'
        shares)."""
        import torch
        cfg = self.cfg
        if _constrain is not None:
            from . import parallel
            return parallel.loss(self, params, batch, _constrain, _exec)
        if cfg.family == "encoder":
            return self._encoder_loss(params, batch)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        x, aux = self._run_stages_train(params, x, positions)
        x = apply_norm(params["final_norm"], x, cfg)
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
        mask = torch.cat([torch.ones((B, S - 1), device=x.device),
                          torch.zeros((B, 1), device=x.device)], dim=1)
        xent_chunk = S if cfg.seq_shard_resid else 512
        nll = chunked_xent(x, self._head_weights(params), targets, mask,
                           softcap=cfg.final_softcap, chunk=xent_chunk)
        loss = nll
        if cfg.moe is not None and "load_balance_loss" in aux:
            loss = loss + cfg.moe.aux_loss_weight * aux["load_balance_loss"] \
                + 1e-4 * aux["router_z_loss"]
        metrics = {"nll": nll.detach(),
                   **{k: v.detach() for k, v in aux.items()},
                   "loss": loss.detach()}
        return loss, metrics

    def _encoder_loss(self, params, batch):
        """Masked cluster prediction: the mean NLL of `labels` over the
        frames where `mask` is set."""
        import torch
        logits = self.encode(params, batch["features"])
        lse = logits.logsumexp(dim=-1)
        correct = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        m = batch["mask"].float()
        nll = ((lse - correct) * m).sum() / torch.clamp(m.sum(), min=1.0)
        return nll, {"loss": nll.detach(), "nll": nll.detach()}

    def encode(self, params, feats):
        """Encoder-only forward. feats: (B, S, d_model) precomputed frame
        embeddings (the modality frontend is a stub, as in JAX) → (B, S, V)
        f32 logits, the product accumulated and returned in f32."""
        import torch
        cfg = self.cfg
        x = feats.to(getattr(torch, cfg.dtype))
        if cfg.positional == "conv":
            x = conv_pos_embed(params["pos_conv"], x)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_stages_train(params, x, positions)
        x = apply_norm(params["final_norm"], x, cfg)
        return x.float() @ self._head_weights(params).float()


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materializes (B, S, V) logits)
# ---------------------------------------------------------------------------

def _xent_chunk(xb, wf, tb, mb, softcap):
    """One chunk: (Σ masked NLL, Σ masked lse²) in f32. The (B, chunk, V)
    logits are the product of the inputs accumulated in f32, as
    ``preferred_element_type=float32`` asks."""
    logits = _softcap(xb.float() @ wf, softcap)
    lse = logits.logsumexp(dim=-1)
    correct = logits.gather(-1, tb.long()[..., None])[..., 0]
    return ((lse - correct) * mb).sum(), (lse.square() * mb).sum()


def chunked_xent(x, w, targets, mask, *, softcap=0.0, chunk=512,
                 z_loss=0.0):
    """Mean masked next-token NLL over sequence chunks
    (``src/repro/models/model.py::chunked_xent``). x: (B, S, d); w: (d, V);
    targets/mask: (B, S). Each chunk runs under ``torch.utils.checkpoint``:
    its (B, chunk, V) f32 logits are recomputed in the backward pass and
    never saved, as the JAX ``nothing_saveable`` remat does. The f32 copy
    of `w` is made once for all chunks."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    wf = w.float()
    nll = zacc = torch.zeros((), device=x.device)
    for c in range(0, S + pad, chunk):
        n, z = checkpoint(_xent_chunk, x[:, c:c + chunk], wf,
                          targets[:, c:c + chunk], mask[:, c:c + chunk],
                          softcap, use_reentrant=False)
        nll = nll + n
        zacc = zacc + z
    denom = torch.clamp(mask.sum(), min=1.0)
    out = nll / denom
    if z_loss:
        out = out + z_loss * zacc / denom
    return out
