"""The training forward and serving on a mesh: ``Model.loss`` with an
activation layout installed (``model.set_constrainer(act_constrainer(cfg,
mesh))``). The reference annotates seven activations
(``src/repro/models/model.py:204-206, :220, :242, :270, :287``) and GSPMD
inserts the collectives; here the forward computes that layout with the
differentiable collectives of ``sharding.collectives``.

Parameters are each rank's local shards (``DTensor.to_local()``). A layer
gathers its own leaves just before it uses them (``_param``): every dim
sharded over ``"data"`` (FSDP) is all-gathered, a dim sharded over the TP
axis (``"model"``) stays local, and the leaf passes ``copy_to`` over every
axis that replicates it. Everything computes replicated over ``"model"``
under ``dp_over_model``, which makes ``"model"`` a batch axis. Each layer (one
repeat of its stage, with its gathers) runs under ``cfg.remat_policy``'s
wrapper (``model.remat``): under ``nothing`` (the default) autograd keeps
the layer's input, not its gathered weights, and the backward gathers them
again, so a rank holds one layer's gathered weights at a time; ``dots``
and ``offload_resid`` keep the gathers inside the recomputed unit too;
``full`` keeps every layer's gathered weights, as the reference's
``everything_saveable`` does.

The layout at each site (``tp`` the size of the TP axis):

* residual: the batch rows of this rank, all S positions, or S/tp of them
  under ``seq_shard_resid`` (``seq_resid``); RMSNorm (K7) runs on those
  rows;
* attention, heads divisible by tp: q/k/v column-parallel on this rank's
  H/tp heads over all S rows (an all-gather of the sequence shards under
  ``seq_resid``); k/v where the kv heads do not divide take the heads the
  rank's q group needs; ``o`` row-parallel: its partial sum is all-reduced,
  or reduce-scattered onto the sequence shards;
* attention, heads not divisible, global, ``seq_shard_attn``: every head
  for this rank's S/tp query rows against the whole key sequence (K8 with
  ``q_offset``); local attention, or no ``seq_shard_attn``: replicated;
* dense MLP: ``wg``/``wu``/``wi`` column-parallel, ``wd`` row-parallel;
* RG-LRU: every width dim is a channel, so the rank's shards are its W/tp
  channels: ``wx``/``wg`` column-parallel, the depthwise conv, ``lam`` and
  the gates on those channels, the scan over them, ``wo`` row-parallel;
* SSM (heads divisible by tp): this rank's nh/tp heads. ``A_log``, ``D``,
  ``dt_bias`` and ``out_proj``'s rows are its shards; the packed
  ``in_proj`` (``[z | x | B | C | dt]``) and conv (``[x | B | C]``) are
  gathered over ``"model"`` and cut to the heads' columns and the B/C
  groups they read (``ssm.take_heads``); the gated norm normalises whole
  d_inner rows, so ``y · silu(z)`` is all-gathered over ``"model"``, K7
  runs on the whole rows with ``out_norm`` gathered, and the rank keeps
  its columns for the row-parallel ``out_proj``. Where the heads do not
  divide tp or a rank's heads would straddle a B/C group, the SSM's
  leaves are gathered over every axis and it runs replicated;
* MoE: experts split over ``"model"``, every rank routing the same groups
  (``_moe``), or the explicit all-to-all schedule of ``moe_shard_map`` when
  an exec mesh is set;
* embedding: vocab-parallel (a masked local lookup, summed over the TP
  axis); the cross-entropy: vocab-parallel (the max and the sum of the
  softmax and the target logit reduced over the TP axis).

Every site where a tile of the vocab, heads, hidden or experts does not
divide tp falls back to the replicated layout of the partition rules (the
leaf is then whole on every rank).

The loss and metrics come back as the loss of this rank's batch rows,
equal on every rank of the TP axis; the step weighs each rank's share and
sums the shares over the mesh (``train.steps``). Gradients of the local
shards come out of the collectives' backward: each sum over ranks is the
adjoint of a forward collective.

Serving on the layout (``serve_layout``, ``prefill``, ``decode_step``,
``encode``; ``train.steps.make_serve_fns(model, mesh=...)``) runs the same
blocks without remat, on the rows of the batch that the decode cache's
layout (``partition.cache_specs``) gives the rank, and keeps the rank's
blocks of that cache: its kv heads where they divide the TP axis, else
its slots of the positions (or, where the batch does not divide the DP
axes, its slots over every axis). A decode step's attention over split
positions takes every head's query and combines the ranks' partial
softmax (the max and the sum reduced over the axes that split the
positions, then the weighted values). A split mixer reads and writes
its recurrent state's heads or channels in the cache's block of them
with no gather; the cache keeps the conv history's channels whole on
every rank, so the rank computes its channels' new history and
all-gathers it over ``"model"``. A replicated mixer gathers a state split
over ``"model"`` and writes back the rank's block. Logits are gathered
over the vocabulary where the head is split, so next tokens come from
the whole distribution.
"""
from __future__ import annotations

import functools
import math

from ..configs.base import ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSM
from ..sharding import collectives as C
from ..sharding.partition import entry_axes
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import (_softcap, apply_norm, attention_decode, attention_full,
                     attention_local, conv_pos_embed, mlp_apply, rmsnorm)

ATTN = (ATTN_GLOBAL, ATTN_LOCAL)
# an SSM's leaves that hold a split rank's own heads (the others are
# gathered over every axis)
HEADS = ("A_log", "D", "dt_bias", "out_proj")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(lay, name, t, *, full=False, layer=False):
    """Leaf `name` (its local shard `t`; `layer`: one layer of a stacked
    leaf) as the layer computes with it → (tensor, whether a dim stays
    split over the TP axis)."""
    spec = lay.param_spec(name)[1 if layer else 0:]
    names = tuple(lay.mesh.mesh_dim_names)
    gathers, used, split = [], set(), False
    for d, e in enumerate(spec):
        for a in reversed(entry_axes(e)):          # minor axis first
            used.add(a)
            if a == lay.tp_axis and not full:
                split = True
            else:
                gathers.append((lay.group(a), d))
    replicated = [lay.group(a) for a in names if a not in used]
    return C.gather_param(t, gathers, replicated), split


def _ssm_split(lay, a_log: str) -> bool:
    """Whether an SSM block runs on this rank's heads: its heads' leaves
    split over the TP axis (the spec of ``A_log``, leaf `a_log`), and each
    rank's heads read whole B/C groups or lie in one."""
    if lay.tp_axis is None or not any(
            lay.tp_axis in entry_axes(e) for e in lay.param_spec(a_log)):
        return False
    _, nh, _ = ssm_mod.dims(lay.cfg)
    n, rep = nh // lay.tp, nh // lay.cfg.ssm.n_groups
    return n % rep == 0 or rep % n == 0


def _gather(lay, prefix, names, leaves):
    """The layer's nested parameter dict from its ``/``-joined leaf
    `names` under `prefix` → (dict, set of the names split over TP)."""
    tree, split = {}, set()
    for name, t in zip(names, leaves):
        parts = name.split("/")
        full = "ssm" in parts and not (parts[-1] in HEADS and _ssm_split(
            lay, f"{prefix}/{'/'.join(parts[:-1])}/A_log"))
        g, s = _param(lay, f"{prefix}/{name}", t, layer=True, full=full)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = g
        if s:
            split.add(name)
    return tree, split


# ---------------------------------------------------------------------------
# the sequence layout of the residual stream
# ---------------------------------------------------------------------------

def _tp(lay):
    return lay.group(lay.tp_axis)


def _full(lay, x):
    """Residual rows → all S rows (an all-gather under ``seq_resid``)."""
    return C.all_gather(x, _tp(lay), 1) if lay.seq_resid else x


def _rows(lay, x):
    """All S rows, the same on every TP rank → this rank's residual
    rows."""
    if not lay.seq_resid:
        return x
    n = x.shape[1] // lay.tp
    return x[:, lay.coord(lay.tp_axis) * n:][:, :n]


def _reduce(lay, x):
    """A partial sum over the TP ranks, all S rows → the residual rows of
    the sum (reduce-scatter under ``seq_resid``, else all-reduce)."""
    if lay.seq_resid:
        return C.reduce_scatter(x, _tp(lay), 1)
    return C.all_reduce(x, _tp(lay))


def _row_ropes(ropes, lo, n):
    return {k: (cos[lo:lo + n], sin[lo:lo + n], rot)
            for k, (cos, sin, rot) in ropes.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attention(model, lay, p, split, h, kind, ropes, kv=None):
    """The attention half on residual rows `h`. With `kv` (a list) a
    prefill also appends the layer's keys and values over all S rows
    (``(k, v, split over TP)``: this rank's kv heads, or all of them)."""
    cfg = model.cfg
    B, _, d = h.shape
    common = dict(softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
    local = kind == ATTN_LOCAL
    if "q" in split:
        # column-parallel q/k/v on this rank's heads, row-parallel o
        x = _full(lay, h)
        S = x.shape[1]
        Hl = p["q"].shape[1]
        h0 = lay.coord(lay.tp_axis) * Hl
        pl = dict(p)
        if cfg.use_bias and "q_b" in p:
            pl["q_b"] = p["q_b"][h0:h0 + Hl]
        if "k" in split:
            # this rank's kv heads are its q heads' groups
            Kl = p["k"].shape[1]
            k0 = lay.coord(lay.tp_axis) * Kl
            for n in ("k", "v"):
                if cfg.use_bias and f"{n}_b" in p:
                    pl[f"{n}_b"] = p[f"{n}_b"][k0:k0 + Kl]
        else:
            # kv heads replicated: the ones this rank's q heads read
            G = cfg.n_heads // cfg.n_kv_heads
            k0, k1 = h0 // G, (h0 + Hl - 1) // G + 1
            if k1 - k0 == 1 or (Hl % G == 0 and h0 % G == 0):
                sel = slice(k0, k1)
            else:
                import torch
                sel = torch.arange(h0, h0 + Hl, device=h.device) // G
            for n in ("k", "v"):
                pl[n] = p[n][:, sel]
                if cfg.use_bias and f"{n}_b" in p:
                    pl[f"{n}_b"] = p[f"{n}_b"][sel]
        q, k, v = model._qkv(pl, x, kind, ropes)
        if kv is not None:
            kv.append((k, v, True) if "k" in split else
                      (model._proj(p, x, "k", kind, ropes),
                       model._proj(p, x, "v", kind, ropes), False))
        if local:
            o = attention_local(q, k, v, window=cfg.window,
                                causal=cfg.causal, **common)
        else:
            o = attention_full(q, k, v, causal=cfg.causal, **common)
        out = _reduce(lay, o.reshape(B, S, -1) @ p["o"].reshape(-1, d))
        if cfg.use_bias and "o_b" in p:
            out = out + p["o_b"]
        return out
    if lay.seq_attn and not local:
        # every head for this rank's query rows against all keys
        x = _full(lay, h)
        S = x.shape[1]
        n = S // lay.tp
        off = lay.coord(lay.tp_axis) * n
        xr = h if lay.seq_resid else x[:, off:off + n]
        q = model._proj(p, xr, "q", kind, _row_ropes(ropes, off, n))
        k = model._proj(p, x, "k", kind, ropes)
        v = model._proj(p, x, "v", kind, ropes)
        if kv is not None:
            kv.append((k, v, False))
        o = attention_full(q, k, v, causal=cfg.causal, q_offset=off,
                           **common)
        out = model._out(p, o)
        return out if lay.seq_resid else C.all_gather(out, _tp(lay), 1)
    out, (k, v) = model._attn_sequence(p, _full(lay, h), kind, ropes)
    if kv is not None:
        kv.append((k, v, False))
    return _rows(lay, out)


def _mlp(lay, cfg, p, split, prefix, h):
    """The dense MLP (leaves ``{prefix}/w*``) on residual rows `h`."""
    if f"{prefix}/wd" not in split:
        return mlp_apply(p, h, cfg)          # row-wise: any rows
    ph = dict(p)
    if "bi" in p:
        n = p["wi"].shape[1]
        lo = lay.coord(lay.tp_axis) * n
        ph["bi"] = p["bi"][lo:lo + n]
    ph.pop("bd", None)
    y = _reduce(lay, mlp_apply(ph, _full(lay, h), cfg))
    return y + p["bd"] if "bd" in p else y


def _mixer(cfg, p, lay, split, h, kind, state=None):
    """SSM / RG-LRU on residual rows `h`, over all S rows: on this rank's
    channels (RG-LRU, W divisible by tp) or heads (SSM, ``_ssm_split``),
    ``wo``/``out_proj``'s partial sum reduced over TP; else on whole
    leaves, replicated over TP. With `state` (a list) a prefill also
    appends ``(final state, whether it holds this rank's heads or
    channels)``."""
    fwd = rglru_mod.rglru_forward if kind == RGLRU else ssm_mod.ssd_forward
    pm, kw, own = _mixer_params(cfg, p, lay, split, kind)
    if state is None:
        o = fwd(pm, _full(lay, h), cfg, **kw)
    else:
        o, st = fwd(pm, _full(lay, h), cfg, return_state=True, **kw)
        state.append((st, own))
    return _reduce(lay, o) if own else _rows(lay, o)


def _mixer_params(cfg, p, lay, split, kind):
    """(the mixer's leaves as its forward takes them, its keyword
    arguments, whether it runs on this rank's heads or channels)."""
    if kind == RGLRU:
        return p["rglru"], {}, "rglru/wx" in split
    if "ssm/A_log" not in split:
        return p["ssm"], {}, False
    n = p["ssm"]["A_log"].shape[0]
    h0 = lay.coord(lay.tp_axis) * n
    norm = functools.partial(_gated_norm, lay, h0 * cfg.ssm.head_dim)
    return ssm_mod.take_heads(p["ssm"], cfg, h0, n), {"norm": norm}, True


def _gated_norm(lay, lo: int, g, scale):
    """mamba2's gated norm on a rank's heads: `g` (its d_inner columns
    from `lo`) all-gathered over TP into whole rows, K7 on them with
    `scale` (``out_norm``, whole), the rank's columns kept."""
    whole = C.all_gather(g, _tp(lay), g.dim() - 1)
    return rmsnorm(whole, scale)[..., lo:lo + g.shape[-1]]


def _conv_whole(lay, cfg, kind, t):
    """A split mixer's conv history `t` (its channels on the last dim) →
    every channel, as one device holds it: the ranks' x channels
    all-gathered, and the B/C groups from a rank whose heads read them."""
    import torch
    last = t.dim() - 1
    if kind == RGLRU:
        return C.all_gather(t, _tp(lay), last)
    s = cfg.ssm
    _, nh, _ = ssm_mod.dims(cfg)
    n = nh // lay.tp
    d = n * s.head_dim
    x = C.all_gather(t[..., :d], _tp(lay), last)
    g0, g1 = ssm_mod.head_groups(cfg, lay.coord(lay.tp_axis) * n, n)
    if g1 - g0 == s.n_groups:
        return torch.cat([x, t[..., d:]], dim=last)
    ranks = C.all_gather(t[None, ..., d:], _tp(lay), 0)
    gl, N = g1 - g0, s.d_state
    b, c = [], []
    for grp in range(s.n_groups):
        r = grp * (nh // s.n_groups) // n       # the first rank reading it
        i = grp - ssm_mod.head_groups(cfg, r * n, n)[0]
        b.append(ranks[r][..., i * N:(i + 1) * N])
        c.append(ranks[r][..., (gl + i) * N:(gl + i + 1) * N])
    return torch.cat([x] + b + c, dim=last)


def _conv_own(lay, cfg, kind, t):
    """Every channel of a conv history → this rank's (``_conv_whole``'s
    inverse)."""
    if kind == RGLRU:
        return _take(lay, t, t.dim() - 1, (lay.tp_axis,))
    _, nh, _ = ssm_mod.dims(cfg)
    n = nh // lay.tp
    return ssm_mod.cut(t, ssm_mod.conv_spans(
        cfg, lay.coord(lay.tp_axis) * n, n))


def _moe(model, lay, p, split, h, exec_mesh):
    """The MoE half on residual rows `h` → (y, aux)."""
    cfg = model.cfg
    if cfg.moe_impl == "shard_map" and exec_mesh["mesh"] is not None:
        from .moe_shard_map import applicable, moe_apply_shard_map
        ax = exec_mesh["ax"]
        # this rank's rows are its token slice where the sequence or the
        # batch is split over "model"
        sliced = lay.seq_resid or (ax.model in lay.batch_axes)
        B = h.shape[0] * _size(lay, lay.batch_axes)
        S = h.shape[1] * (lay.tp if lay.seq_resid else 1)
        if B % ax.batch_size == 0 and \
                applicable(cfg, ax, (B // ax.batch_size) * S):
            y, aux = moe_apply_shard_map(p, h, cfg, exec_mesh["mesh"], ax,
                                         sliced=sliced)
            if cfg.moe.n_shared_experts:
                y = y + _mlp(lay, cfg, p["shared"], split, "moe/shared", h)
            return y, aux
    from .moe import moe_groups
    x = _full(lay, h)
    El = p["wg"].shape[0]
    esplit = "moe/wg" in split
    experts = (lay.coord(lay.tp_axis) * El, El) if esplit else None
    # a group holds min(4096, T) tokens of the GLOBAL batch: where this
    # rank's rows do not make whole groups, route the batch's rows (the
    # groups the one-device step forms) and keep this rank's
    t_local = x.shape[0] * x.shape[1]
    n_rows = _size(lay, lay.batch_axes)
    take = None
    if n_rows > 1 and t_local % min(4096, t_local * n_rows):
        b = x.shape[0]
        for a in reversed(lay.batch_axes):
            x = C.all_gather(x, lay.group(a), 0)
        lo = b * _rank_in(lay, lay.batch_axes)
        take = (lo, b)
    y, aux = moe_groups(p, x, cfg, experts=experts)
    if take is not None:
        y = y[take[0]:take[0] + take[1]]
    y = _reduce(lay, y) if esplit else _rows(lay, y)
    if cfg.moe.n_shared_experts:
        y = y + _mlp(lay, cfg, p["shared"], split, "moe/shared", h)
    return y, aux


def _size(lay, axes) -> int:
    sizes = dict(zip(lay.mesh.mesh_dim_names, tuple(lay.mesh.shape)))
    return math.prod(sizes[a] for a in axes)


def _rank_in(lay, axes) -> int:
    """This rank's mixed-radix position over `axes` (major first)."""
    sizes = dict(zip(lay.mesh.mesh_dim_names, tuple(lay.mesh.shape)))
    i = 0
    for a in axes:
        i = i * sizes[a] + lay.coord(a)
    return i


def _block(model, lay, p, split, x, kind, moe, ropes, exec_mesh, *,
           cache=None, mix=None):
    """One block on residual rows `x` → (x, aux). `cache` (a list): a
    prefill's keys/values or final state are appended to it; `mix`: the
    mixer half as ``mix(p, split, h, kind)`` (a decode step's)."""
    cfg = model.cfg
    h = apply_norm(p["norm_in"], x, cfg)
    if mix is not None:
        o = mix(p, split, h, kind)
    elif kind in ATTN:
        o = _attention(model, lay, p, split, h, kind, ropes, cache)
    else:
        o = _mixer(cfg, p, lay, split, h, kind, cache)
    if cfg.post_norm:
        o = apply_norm(p["norm_post"], o, cfg)
    x = x + o
    if kind == SSM:
        return x, {}
    h = apply_norm(p["norm_mlp"], x, cfg)
    if moe:
        y, aux = _moe(model, lay, p["moe"], split, h, exec_mesh)
    else:
        y, aux = _mlp(lay, cfg, p["mlp"], split, "mlp", h), {}
    if cfg.post_norm:
        y = apply_norm(p["norm_post_mlp"], y, cfg)
    return x + y, aux


AUX = ("load_balance_loss", "router_z_loss", "drop_fraction")


def _stages(model, lay, params, x, ropes, exec_mesh):
    """Every layer under the remat policy's wrapper → (x, aux summed over
    the MoE layers)."""
    from ..core.split_state import leaf_paths
    from .model import remat
    run = remat(model.cfg)
    aux_tot = {}
    for si, stage in enumerate(model.stages):
        prefix = f"stage_{si}"
        flat = leaf_paths(params[prefix])
        names = [n for n, _ in flat]
        layers = [t.unbind(0) for _, t in flat]

        def layer(x, *leaves, _stage=stage, _prefix=prefix, _names=names):
            p, split = _gather(lay, _prefix, _names, leaves)
            aux = {}
            for j, kind in enumerate(_stage.kinds):
                sub = {n.split("/", 1)[1] for n in split
                       if n.startswith(f"b{j}/")}
                x, a = _block(model, lay, p[f"b{j}"], sub, x, kind,
                              _stage.moe, ropes, exec_mesh)
                for k, v in a.items():
                    aux[k] = aux[k] + v if k in aux else v
            return (x, *(aux[k] for k in AUX if k in aux))

        for r in range(stage.repeat):
            out = run(layer, x, *(t[r] for t in layers))
            x = out[0]
            for k, v in zip([k for k in AUX if stage.moe], out[1:]):
                aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
    return x, aux_tot


# ---------------------------------------------------------------------------
# embedding and cross-entropy
# ---------------------------------------------------------------------------

def _embed(lay, cfg, w, split, tokens):
    import torch
    import torch.nn.functional as F
    if split:
        n = w.shape[0]
        local = tokens.long() - lay.coord(lay.tp_axis) * n
        inside = (local >= 0) & (local < n)
        e = F.embedding(local.clamp(0, n - 1), w) * \
            inside[..., None].to(w.dtype)
        x = _reduce(lay, e)
    else:
        x = _rows(lay, F.embedding(tokens.long(), w))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _xent_chunk(xb, wf, tb, mb, softcap, v0, group):
    """One chunk's Σ masked NLL in f32; with `group`, `wf` holds vocab
    columns [v0, v0 + V_loc) and the softmax spans the group's columns."""
    logits = _softcap(xb.float() @ wf, softcap)
    if group is None:
        lse = logits.logsumexp(dim=-1)
        correct = logits.gather(-1, tb.long()[..., None])[..., 0]
        return ((lse - correct) * mb).sum()
    n = wf.shape[1]
    m = C.all_reduce_max(logits.amax(dim=-1), group)
    lse = m + C.all_reduce((logits - m[..., None]).exp().sum(-1),
                           group).log()
    local = tb.long() - v0
    inside = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    correct = C.all_reduce(picked * inside, group)
    return ((lse - correct) * mb).sum()


def _xent(lay, x, w, split, targets, mask, *, softcap, chunk):
    """``model.chunked_xent`` on residual rows `x` (targets/mask: all S
    rows): vocab-parallel over all S rows where the head is split over
    TP, else over the rank's rows (their sums added over TP under
    ``seq_resid``). The same value on every TP rank."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint
    denom = torch.clamp(mask.sum(), min=1.0)
    group, v0 = None, 0
    if split:
        x = _full(lay, x)
        group = _tp(lay)
        v0 = lay.coord(lay.tp_axis) * w.shape[1]
    else:
        targets, mask = _rows(lay, targets), _rows(lay, mask)
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    wf = w.float()
    nll = torch.zeros((), device=x.device)
    for c in range(0, S + pad, chunk):
        nll = nll + checkpoint(_xent_chunk, x[:, c:c + chunk], wf,
                               targets[:, c:c + chunk], mask[:, c:c + chunk],
                               softcap, v0, group, use_reentrant=False)
    if not split and lay.seq_resid:
        nll = C.all_reduce(nll, _tp(lay))
    return nll / denom


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _top(lay, cfg, params):
    """The leaves outside the stages, gathered: (top-level leaves, the
    head as (d, V) or its TP columns, whether those are split, the final
    norm)."""
    top = {n: _param(lay, n, params[n]) for n in params
           if not n.startswith("stage_") and not isinstance(params[n], dict)}
    head, hsplit = top["embed"] if cfg.tie_embeddings else top["lm_head"]
    if cfg.tie_embeddings:
        head = head.T
    final = {k: _param(lay, f"final_norm/{k}", t)[0]
             for k, t in params["final_norm"].items()}
    return top, head, hsplit, final


def _features(lay, cfg, params, feats):
    """An encoder's input frames → this rank's residual rows."""
    import torch
    x = feats.to(getattr(torch, cfg.dtype))
    if cfg.positional == "conv":
        w = _param(lay, "pos_conv/w", params["pos_conv"]["w"])[0]
        x = conv_pos_embed({"w": w}, x)
    return _rows(lay, x)


def loss(model, params, batch, lay, exec_mesh):
    """``Model.loss`` of this rank's batch rows with the layout `lay`:
    (loss, metrics), the same on every TP rank; `params` holds the local
    shards."""
    import torch
    cfg = model.cfg
    top, head, hsplit, final = _top(lay, cfg, params)
    if cfg.family == "encoder":
        x = _features(lay, cfg, params, batch["features"])
        S = batch["features"].shape[1]
    else:
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = _embed(lay, cfg, *top["embed"], tokens)
    ropes = model._ropes(torch.arange(S, device=x.device))
    x, aux = _stages(model, lay, params, x, ropes, exec_mesh)
    x = apply_norm(final, x, cfg)
    if cfg.family == "encoder":
        nll = _xent(lay, x, head, hsplit, batch["labels"],
                    batch["mask"].float(), softcap=0.0, chunk=S)
        return nll, {"loss": nll.detach(), "nll": nll.detach()}
    B = tokens.shape[0]
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), device=x.device),
                      torch.zeros((B, 1), device=x.device)], dim=1)
    # 512-row chunks whatever the residual layout: the reference takes the
    # whole sequence under seq_shard_resid so that XLA does not slice a
    # sharded dim; here the head's rows are gathered first
    nll = _xent(lay, x, head, hsplit, targets, mask,
                softcap=cfg.final_softcap, chunk=512)
    out = nll
    if cfg.moe is not None and "load_balance_loss" in aux:
        out = out + cfg.moe.aux_loss_weight * aux["load_balance_loss"] \
            + 1e-4 * aux["router_z_loss"]
    metrics = {"nll": nll.detach(), **{k: v.detach() for k, v in aux.items()},
               "loss": out.detach()}
    return out, metrics


# ---------------------------------------------------------------------------
# serving on the layout
# ---------------------------------------------------------------------------

def serve_layout(cfg, mesh, batch: int, cache_len: int):
    """The layout a rank serves `batch` sequences with, caches of
    `cache_len` positions: the training layout of `cfg` without
    ``dp_over_model`` (the decode cache's layout, ``cache_specs``, keeps
    the model axis for heads or positions), its batch rows split over the
    DP axes where `batch` divides them (as the cache's), and the spec of
    every cache leaf (``cache_specs`` of the global cache) in
    ``cache_spec``."""
    import dataclasses

    from ..core.split_state import leaf_paths
    from ..sharding.partition import (_axis, act_constrainer, cache_specs,
                                      mesh_axes)
    from .model import Model
    lay = act_constrainer(dataclasses.replace(cfg, dp_over_model=False),
                          mesh)
    lay.batch_axes = entry_axes(_axis(mesh_axes(mesh), "batch", batch))
    abstract = Model(cfg).init_cache(batch, cache_len, device="meta")
    lay.cache_spec = {n: sh.spec for n, sh in
                      leaf_paths(cache_specs(abstract, mesh, cfg))}
    return lay


def batch_rows(lay, batch: int) -> tuple:
    """The rows [lo, hi) of a `batch`-row serving batch that this rank
    takes under `lay` (``serve_layout``)."""
    n = batch // _size(lay, lay.batch_axes)
    lo = _rank_in(lay, lay.batch_axes) * n
    return lo, lo + n


def _decoding(lay):
    """`lay` for one position a step: the residual stream whole on every
    TP rank, no sequence-parallel attention."""
    import copy
    d = copy.copy(lay)
    d.seq_resid = d.seq_attn = False
    return d


def _take(lay, t, dim: int, axes):
    """This rank's block of `t`'s dim `dim` split over mesh `axes`."""
    if not axes:
        return t
    n = t.shape[dim] // _size(lay, axes)
    return t.narrow(dim, _rank_in(lay, axes) * n, n)


def _gather_dim(lay, t, dim: int, axes):
    """`t`'s dim `dim` whole from every rank's block over mesh `axes`."""
    for a in reversed(axes):                       # minor axis first
        t = C.all_gather(t, lay.group(a), dim)
    return t


def _layers(model, lay, params):
    """Every block with its gathered parameters, in order: yields
    ``(stage, layer, j, kind, moe, params, names split over TP)``."""
    from ..core.split_state import leaf_paths
    for si, stage in enumerate(model.stages):
        prefix = f"stage_{si}"
        flat = leaf_paths(params[prefix])
        names = [n for n, _ in flat]
        for r in range(stage.repeat):
            p, split = _gather(lay, prefix, names, [t[r] for _, t in flat])
            for j, kind in enumerate(stage.kinds):
                sub = {n.split("/", 1)[1] for n in split
                       if n.startswith(f"b{j}/")}
                yield si, r, j, kind, stage.moe, p[f"b{j}"], sub


def _logits(lay, x, head, hsplit, softcap):
    """f32 logits of rows `x` over the whole vocabulary (gathered over TP
    where the head is split)."""
    logits = _softcap(x.float() @ head.float(), softcap)
    return C.all_gather(logits, _tp(lay), logits.dim() - 1) if hsplit \
        else logits


def _cache_entry(model, lay, kind, got, spec: dict, cache_len: int):
    """A block's prefill output (``_block``'s `cache`) → its cache leaves,
    this rank's blocks under `spec` (leaf → spec of the stacked leaf)."""
    if kind not in ATTN:
        st, own = got
        if own:
            return _state_out(model.cfg, lay, kind, st, spec)
        return {n: _take(lay, t, 1, entry_axes(spec[n][2]))
                for n, t in st.items()}
    k, v, k_split = got
    out = {}
    for n, t in model._build_attn_cache(kind, k, v, cache_len).items():
        l_axes, k_axes = entry_axes(spec[n][2]), entry_axes(spec[n][3])
        if k_split and not k_axes:
            t = C.all_gather(t, _tp(lay), 2)
        elif k_axes and not k_split:
            t = _take(lay, t, 2, k_axes)
        out[n] = _take(lay, t, 1, l_axes)
    return out


def prefill(model, params, tokens, lay, *, cache_len: int = 0,
            exec_mesh=None):
    """``Model.prefill`` of this rank's batch rows with the serving layout
    `lay` (``serve_layout``): `params` the local shards (each layer
    gathered as ``loss`` gathers it), `tokens` (B_local, S) → (last
    logits (B_local, V) f32 over the whole vocabulary, this rank's cache
    blocks under ``lay.cache_spec``)."""
    import torch
    cfg = model.cfg
    exec_mesh = exec_mesh or {"mesh": None, "ax": None}
    S = tokens.shape[1]
    cache_len = cache_len or S
    top, head, hsplit, final = _top(lay, cfg, params)
    x = _embed(lay, cfg, *top["embed"], tokens)
    ropes = model._ropes(torch.arange(S, device=x.device))
    caches: dict = {}
    for si, r, j, kind, moe, p, split in _layers(model, lay, params):
        got: list = []
        x, _ = _block(model, lay, p, split, x, kind, moe, ropes, exec_mesh,
                      cache=got)
        names = ("k", "v") if kind in ATTN else tuple(got[0][0])
        spec = {n: lay.cache_spec[f"stage_{si}/b{j}/{n}"] for n in names}
        entry = _cache_entry(model, lay, kind, got[0], spec, cache_len)
        layers = caches.setdefault(f"stage_{si}", {}).setdefault(f"b{j}",
                                                                 {})
        for n, t in entry.items():
            layers.setdefault(n, []).append(t)
    caches = {s: {b: {n: torch.stack(ts) for n, ts in c.items()}
                  for b, c in bs.items()} for s, bs in caches.items()}
    x = apply_norm(final, x, cfg)
    last = x[:, -1:]
    if lay.seq_resid:
        # the last position is the last TP rank's last row
        last = C.all_gather(last, _tp(lay), 1)[:, -1:]
    logits = _logits(lay, last[:, 0], head, hsplit, cfg.final_softcap)
    caches["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return logits, caches


def _attn_decode(model, lay, cache, spec, pos, ropes, p, split, h, kind):
    """One token's attention on the cache blocks of this rank (`cache`:
    this layer's views, written in place)."""
    cfg = model.cfg
    B, _, d = h.shape
    common = dict(softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
    kc, vc = cache["k"], cache["v"]
    l_axes = entry_axes(spec["k"][2])
    Lc = kc.shape[1]
    cap = Lc * _size(lay, l_axes)
    lo = _rank_in(lay, l_axes) * Lc
    if kind == ATTN_LOCAL:
        slot, n_valid = pos % cap, min(pos + 1, cap)
    else:
        # dynamic_update_slice clamps a start past the end
        slot, n_valid = min(pos, cap - 1), min(pos + 1, cap)
    if entry_axes(spec["k"][3]):
        # heads over TP: this rank's q heads and their kv heads
        tp = lay.coord(lay.tp_axis)
        pl = dict(p)
        for n in ("q", "k", "v"):
            if cfg.use_bias and f"{n}_b" in p:
                m = p[n].shape[1]
                pl[f"{n}_b"] = p[f"{n}_b"][tp * m:(tp + 1) * m]
        q, k, v = model._qkv(pl, h, kind, ropes)
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        o = attention_decode(q, kc, vc, kv_len=n_valid, **common)
    else:
        # every kv head on this rank, the positions split over `l_axes`
        pw = dict(p)
        for n in ("q", "k", "v"):
            if n in split:
                pw[n] = C.all_gather(p[n], _tp(lay), 1)
        q, k, v = model._qkv(pw, h, kind, ropes)
        if lo <= slot < lo + Lc:
            kc[:, slot - lo] = k[:, 0]
            vc[:, slot - lo] = v[:, 0]
        o = attention_decode(q, kc, vc, kv_len=n_valid, lo=lo,
                             groups=[lay.group(a) for a in l_axes], **common)
        if "o" in split:
            m = p["o"].shape[0]
            h0 = lay.coord(lay.tp_axis) * m
            o = o[:, :, h0:h0 + m]
    out = o.reshape(B, 1, -1) @ p["o"].reshape(-1, d)
    if "o" in split:
        out = _reduce(lay, out)
    if cfg.use_bias and "o_b" in p:
        out = out + p["o_b"]
    return out


def _state_out(cfg, lay, kind, st, spec):
    """A split mixer's state `st` → this rank's cache blocks under `spec`:
    the recurrent state as it is (the cache splits its heads or channels
    over ``"model"`` where the mixer does), the conv history made whole
    (``_conv_whole``) and cut to the cache's block."""
    return {n: _take(lay, _conv_whole(lay, cfg, kind, t), 1,
                     entry_axes(spec[n][2])) if n == "conv" else t
            for n, t in st.items()}


def _state_in(cfg, lay, kind, cache, spec):
    """This rank's cache blocks → a split mixer's state: its heads or
    channels (``_state_out``'s inverse)."""
    return {n: _conv_own(lay, cfg, kind, _gather_dim(
        lay, t, 1, entry_axes(spec[n][2]))) if n == "conv" else t
        for n, t in cache.items()}


def _mixer_decode(model, lay, cache, spec, pos, ropes, p, split, h, kind):
    """One token through an SSM or RG-LRU block (`pos`, `ropes`: unused, as
    ``_attn_decode``'s arguments). Split over TP (``_mixer``'s layout):
    the step reads and writes the rank's heads or channels of the
    recurrent state in the cache's block, computes its channels of the
    conv history and writes the history whole (``_state_in``,
    ``_state_out``), and the output's partial sum is all-reduced.
    Replicated: the state gathered where the cache splits it, this rank's
    blocks of the new state written back."""
    cfg = model.cfg
    step = rglru_mod.rglru_decode_step if kind == RGLRU \
        else ssm_mod.ssd_decode_step
    pm, kw, own = _mixer_params(cfg, p, lay, split, kind)
    if own:
        o, new = step(pm, h, cfg, _state_in(cfg, lay, kind, cache, spec),
                      **kw)
        for n, t in _state_out(cfg, lay, kind, new, spec).items():
            cache[n].copy_(t)
        return _reduce(lay, o)
    axes = {n: entry_axes(spec[n][2]) for n in cache}
    state = {n: _gather_dim(lay, t, 1, axes[n]) for n, t in cache.items()}
    o, new = step(pm, h, cfg, state)
    for n, t in new.items():
        cache[n].copy_(_take(lay, t, 1, axes[n]))
    return o


def decode_step(model, params, cache, tokens, lay, *, pos=None,
                exec_mesh=None):
    """``Model.decode_step`` of this rank's batch rows with the serving
    layout `lay`: `cache` this rank's blocks (written in place), `tokens`
    (B_local,) → (logits (B_local, V) f32 over the whole vocabulary,
    cache). `pos` (default ``int(cache["pos"])``) is the token's position,
    for a trace where the cache holds no values."""
    import functools

    import torch
    cfg = model.cfg
    exec_mesh = exec_mesh or {"mesh": None, "ax": None}
    lay = _decoding(lay)
    pos = int(cache["pos"]) if pos is None else int(pos)
    top, head, hsplit, final = _top(lay, cfg, params)
    x = _embed(lay, cfg, *top["embed"], tokens[:, None])
    ropes = model._ropes(torch.tensor([pos], device=x.device))
    for si, r, j, kind, moe, p, split in _layers(model, lay, params):
        c = {n: t[r] for n, t in cache[f"stage_{si}"][f"b{j}"].items()}
        spec = {n: lay.cache_spec[f"stage_{si}/b{j}/{n}"] for n in c}
        fn = _attn_decode if kind in ATTN else _mixer_decode
        x, _ = _block(model, lay, p, split, x, kind, moe, ropes, exec_mesh,
                      mix=functools.partial(fn, model, lay, c, spec, pos,
                                            ropes))
    x = apply_norm(final, x, cfg)
    logits = _logits(lay, x[:, 0], head, hsplit, cfg.final_softcap)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def encode(model, params, feats, lay, *, exec_mesh=None):
    """``Model.encode`` of this rank's batch rows with the layout `lay`:
    feats (B_local, S, d_model) → (B_local, S, V) f32 logits."""
    import torch
    cfg = model.cfg
    exec_mesh = exec_mesh or {"mesh": None, "ax": None}
    _, head, hsplit, final = _top(lay, cfg, params)
    x = _features(lay, cfg, params, feats)
    ropes = model._ropes(torch.arange(feats.shape[1], device=x.device))
    for _, _, _, kind, moe, p, split in _layers(model, lay, params):
        x, _ = _block(model, lay, p, split, x, kind, moe, ropes, exec_mesh)
    x = _full(lay, apply_norm(final, x, cfg))
    return _logits(lay, x, head, hsplit, 0.0)
