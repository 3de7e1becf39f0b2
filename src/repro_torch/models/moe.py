"""Mixture-of-Experts layer (``src/repro/models/moe.py`` on PyTorch):
top-k routing in f32, capacity dispatch, batched expert MLPs, weighted
combine, and the switch-style aux losses.

The reference scatters tokens into an (G, E, C, D) buffer with
``mode="drop"`` and gathers them back with clamped indices. Here both
directions are gathers (``F.embedding``), so the step stays
deterministic on the card (its backward sums rows in a fixed order) and no
index is ever out of range:

* dispatch: slot (e, c) of a group is filled by the c-th assignment (in
  token-major order) routed to expert e, read from the stable sort of the
  group's expert ids; a slot with no assignment reads an appended zero row.
  A dropped assignment (position ≥ C) fills no slot — the reference's
  dropped write.
* combine: assignment (t, j) reads slot (e, min(pos, C − 1)), the
  reference's clamped gather, and weighs it by ``topw · within``, so a
  dropped assignment adds exactly 0.

The top-k order is explicit: a stable descending sort, so of two equal
probabilities the lower expert index comes first, as ``jax.lax.top_k``
takes it. The expert ids carry no gradient (the reference's
``stop_gradient``); ``topw`` is read from ``probs`` through a one-hot
product, so its gradient is an elementwise one.

On a mesh (``models.parallel``) a rank holds the experts ``[e0, e0 +
E_loc)``: ``moe_groups(.., experts=(e0, E_loc))`` routes every group over
all E experts as here, fills and runs only its own experts' slots, and
returns their part of the combine (an assignment to another rank's expert
adds 0), which the caller sums over the ranks.
"""
from __future__ import annotations

import math

from .layers import _act, mlp_apply


def _mean(x, dim=None):
    """The mean as ``jnp.mean`` computes it: the f32 sum times the f32
    reciprocal of the count (XLA folds the division by a constant into
    that product), so a mean of 0/1 values is the reference's bits."""
    import torch
    n = x.numel() if dim is None else \
        math.prod(x.shape[d] for d in (dim if isinstance(dim, tuple)
                                       else (dim,)))
    s = x.sum() if dim is None else x.sum(dim=dim)
    return s * (1.0 / torch.tensor(float(n), dtype=torch.float32))


def capacity(mcfg, group_tokens: int) -> int:
    """Slots per expert and group: ``top_k · tokens · capacity_factor /
    n_experts`` rounded up to a multiple of 16, at least 16."""
    c = math.ceil(mcfg.top_k * group_tokens * mcfg.capacity_factor
                  / mcfg.n_experts)
    return max(16, -(-c // 16) * 16)


def _positions_in_expert(idx_flat, n_experts: int, *, block: int = 2048):
    """Arrival-order position of each assignment within its expert, and
    each expert's count. idx_flat: (..., N) integer expert ids, token-major
    (earlier tokens win capacity). As the reference, N is padded with
    `n_experts` (an id no expert has) to whole blocks of `block`, each
    block counted through a (block, E) one-hot cumulative sum, and the
    counts carried from block to block. Returns (pos (..., N) int32,
    counts (..., E) int32)."""
    import torch
    import torch.nn.functional as F
    n = idx_flat.shape[-1]
    pad = (-n) % block
    idx_p = F.pad(idx_flat, (0, pad), value=n_experts)
    blocks = idx_p.reshape(idx_p.shape[:-1] + (-1, block))
    experts = torch.arange(n_experts, device=idx_flat.device)
    oh = (blocks[..., None] == experts).to(torch.int32)   # (.., nb, blk, E)
    excl = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh
    tot = oh.sum(dim=-2, dtype=torch.int32)               # (..., nb, E)
    carry = torch.cumsum(tot, dim=-2, dtype=torch.int32) - tot
    pos_b = carry[..., None, :] + excl
    pick = blocks.clamp(0, n_experts - 1).long()[..., None]
    pos = pos_b.gather(-1, pick)[..., 0]
    pos = pos.reshape(idx_p.shape)[..., :n]
    return pos, tot.sum(dim=-2, dtype=torch.int32)


def _top_k(probs, k: int):
    """(topw, topi) of the k largest probabilities, the lower index first
    among equals; topi carries no gradient."""
    import torch
    import torch.nn.functional as F
    _, order = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True)
    topi = order[..., :k]
    onehot = F.one_hot(topi, probs.shape[-1]).to(probs.dtype)
    topw = (probs[..., None, :] * onehot).sum(-1)
    return topw, topi


def _dispatch_slots(e_flat, pos_flat, counts, k: int, C: int, zero_row):
    """Source row of each (expert, slot) of each group: the token of the
    slot's assignment (``group · g + t``), or `zero_row` for an empty slot.
    e_flat/pos_flat: (G, g·k); counts: (G, E) → (G, E·C) int64."""
    import torch
    G, N = e_flat.shape
    E = counts.shape[-1]
    order = torch.sort(e_flat, dim=-1, stable=True).indices   # (G, N)
    starts = torch.cumsum(counts, dim=-1) - counts            # (G, E)
    c = torch.arange(C, device=e_flat.device)
    at = (starts[..., None] + c).clamp(max=N - 1)              # (G, E, C)
    src = order.gather(-1, at.reshape(G, E * C).long()) // k    # token
    g = N // k
    src = src + torch.arange(G, device=e_flat.device)[:, None] * g
    filled = (c < counts[..., None]).reshape(G, E * C)
    return torch.where(filled, src, zero_row)


def moe_apply(params, x, cfg, *, group_size: int = 4096):
    """x: (B, S, D) → (y, aux) with aux = {load_balance_loss,
    router_z_loss, drop_fraction} (f32 scalars)."""
    y, aux = moe_groups(params, x, cfg, group_size)
    if cfg.moe.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg)
    return y, aux


def moe_groups(params, x, cfg, group_size: int = 4096, experts=None):
    """The routed experts' part of ``moe_apply`` (no shared expert): x
    (B, S, D) in groups of min(group_size, B·S) tokens → (y, aux).
    `experts` (e0, E_loc): params hold experts [e0, e0 + E_loc) only, and y
    is their part of the combine."""
    import torch
    import torch.nn.functional as F
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    g = min(group_size, T)
    assert T % g == 0, (T, g)
    G = T // g
    C = capacity(m, g)
    E, k = m.n_experts, m.top_k

    xt = x.reshape(G, g, D)
    # ---- routing (f32) ----
    logits = xt.float() @ params["router"].float()            # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)                             # (G, g, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # ---- aux losses (switch-style load balance + z-loss) ----
    me = _mean(probs, (0, 1))
    ce = _mean(F.one_hot(topi[..., 0], E).float(), (0, 1))
    lb_loss = E * (me * ce).sum()
    z_loss = _mean(logits.logsumexp(dim=-1).square())

    # ---- positions within experts (per group) ----
    e_flat = topi.reshape(G, g * k)
    pos, counts = _positions_in_expert(e_flat, E)             # (G, g·k)
    within = pos < C
    drop_frac = 1.0 - _mean(within.float())

    # ---- dispatch: gather tokens into (G, E_loc, C, D) ----
    e0, El = experts or (0, E)
    rows = torch.cat([xt.reshape(G * g, D), xt.new_zeros((1, D))])
    slots = _dispatch_slots(e_flat, pos, counts, k, C, G * g)
    slots = slots[:, e0 * C:(e0 + El) * C]
    buf = F.embedding(slots, rows).view(G, El, C, D)

    # ---- expert FFNs: one batched product per expert ----
    act = _act(cfg.act)
    be = buf.transpose(0, 1).reshape(El, G * C, D)
    h = act(torch.bmm(be, params["wg"])) * torch.bmm(be, params["wu"])
    out = torch.bmm(h, params["wd"])                          # (El, G·C, D)
    out = out.view(El, G, C, D).transpose(0, 1).reshape(G * El * C, D)

    # ---- combine: gather back (clamped slot), weight, sum over k ----
    base = torch.arange(G, device=x.device)[:, None] * (El * C)
    el = e_flat - e0
    mine = (el >= 0) & (el < El)
    at = base + el.clamp(0, El - 1) * C + pos.clamp(max=C - 1)
    y = F.embedding(at.long(), out).view(G, g, k, D)
    w = (topw * (within & mine).view(G, g, k)).to(y.dtype)
    y = torch.einsum("gtkd,gtk->gtd", y, w)

    aux = {"load_balance_loss": lb_loss, "router_z_loss": z_loss,
           "drop_fraction": drop_frac}
    return y.reshape(B, S, D), aux
