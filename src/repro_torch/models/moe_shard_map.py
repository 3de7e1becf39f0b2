"""Expert-parallel MoE with the explicit all-to-all schedule
(``src/repro/models/moe_shard_map.py`` on PyTorch): the route of
``moe_impl="shard_map"`` when an exec mesh is set
(``model.set_exec_mesh``).

  slice tokens over "model" → local top-k route → local (E, C, D) dispatch
  → all_to_all over "model" (tokens to their expert's shard)
  → local expert FFNs with FSDP-gathered (E/tp, D, F) weights
  → reverse all_to_all → local combine → all_gather token slices.

Each rank of the model axis routes its slice of g = t_loc / tp tokens
(t_loc: the tokens of its data shard) as one group, so the capacity is
``capacity(m, g)`` and tokens drop where that slice overflows an expert: the
reference's function, which differs from ``moe_apply``'s groups of 4,096
wherever anything drops. The aux values are means over every rank.
Falls back to the GSPMD route (``models.parallel._moe``) where the local
token count or the expert count does not divide tp.
"""
from __future__ import annotations

from ..sharding import collectives as C
from .layers import _act
from .moe import (_dispatch_slots, _mean, _positions_in_expert, _top_k,
                  capacity)


def applicable(cfg, mesh_axes_info, tokens_per_device: int) -> bool:
    m = cfg.moe
    ax = mesh_axes_info
    if ax.model is None or ax.tp <= 1:
        return False
    if m.n_experts % ax.tp or tokens_per_device % ax.tp:
        return False
    return True


def moe_apply_shard_map(params, x, cfg, mesh, ax, *, sliced=None):
    """x: this rank's residual rows → (y in x's layout, aux).

    `params`: the layer's MoE leaves with their FSDP dims gathered; the
    expert dim is this rank's E/tp block over "model", or all E experts
    (then the block is taken here). `sliced` (default
    ``cfg.seq_shard_resid``): x IS this rank's token slice (the sequence,
    or the batch, split over "model"), so the entry slice and the exit
    all-gather disappear; otherwise x (B_loc, S, D) is the same on every
    model rank and each takes its slice."""
    import torch
    import torch.nn.functional as F
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    tp = ax.tp
    group = mesh.get_group(ax.model)
    names = tuple(mesh.mesh_dim_names)
    mi = mesh.get_coordinate()[names.index(ax.model)]
    if sliced is None:
        sliced = bool(getattr(cfg, "seq_shard_resid", False))
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    t_loc = xt.shape[0] * (tp if sliced else 1)
    g = t_loc // tp
    Cap = capacity(m, g)
    El = E // tp
    act = _act(cfg.act)
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    if wg.shape[0] == E:
        wg, wu, wd = (w[mi * El:(mi + 1) * El] for w in (wg, wu, wd))
    xs = xt if sliced else xt[mi * g:(mi + 1) * g]             # (g, D)

    # ---- local routing (f32) ----
    logits = xs.float() @ params["router"].float()             # (g, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    e_flat = topi.reshape(-1)
    pos, counts = _positions_in_expert(e_flat, E)
    within = pos < Cap

    # ---- dispatch: the (E, C, D) buffer as a gather (moe.py's); a
    # dropped assignment fills no slot (the reference's mode="drop") ----
    rows = torch.cat([xs, xs.new_zeros((1, D))])
    slots = _dispatch_slots(e_flat[None], pos[None], counts[None], k, Cap,
                            g)[0]
    buf = F.embedding(slots, rows)                             # (E·C, D)

    # ---- EP exchange: tokens travel to their expert's shard ----
    recv = C.all_to_all(buf.view(tp, El * Cap, D), group)      # (tp,El·C,D)
    xin = recv.view(tp, El, Cap, D).transpose(0, 1).reshape(El, tp * Cap, D)

    # ---- local expert FFNs (the only matmuls) ----
    h = act(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    out = torch.bmm(h, wd)                                     # (El,tp·C,D)

    # ---- reverse exchange + combine ----
    outr = out.view(El, tp, Cap, D).transpose(0, 1).reshape(tp, El * Cap, D)
    back = C.all_to_all(outr.contiguous(), group).reshape(E * Cap, D)
    y = F.embedding((e_flat * Cap + pos.clamp(max=Cap - 1)).long(), back)
    w = (topw.reshape(-1) * within).to(y.dtype)
    y = (y * w[:, None]).view(g, k, D).sum(dim=1)

    # ---- reassemble the rank's residual rows ----
    y = y.view(x.shape) if sliced else \
        C.all_gather(y, group, 0).view(x.shape)

    # ---- aux: means over every rank ----
    axes = [a for a in (tuple(ax.batch or ()) + (ax.model,)) if a]
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))

    def pmean(t):
        for a in axes:
            t = C.all_reduce(t, mesh.get_group(a))
        return t / n

    me = _mean(probs, 0)
    ce = _mean(F.one_hot(topi[:, 0], E).float(), 0)
    lb = E * (pmean(me) * pmean(ce)).sum()
    z = pmean(_mean(logits.logsumexp(dim=-1).square()))
    drop = pmean(1.0 - _mean(within.float()))
    return y, {"load_balance_loss": lb, "router_z_loss": z,
               "drop_fraction": drop}
