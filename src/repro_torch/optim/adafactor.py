"""Adafactor (``src/repro/optim/adafactor.py`` on PyTorch): a factored
second moment, no momentum — the optimizer of the MoE configs and
chameleon-34b.

The same f32 math, leaf by leaf: for a leaf whose last two axes are both at
least ``min_dim_size_to_factor``, the row and column means of ``g² + eps``
are decayed into ``v_row`` (``p.shape[:-1]``) and ``v_col``
(``p.shape[:-2] + p.shape[-1:]``), so a stacked expert leaf (R, E, d, f)
keeps its R and E axes; any other leaf decays a full ``v``. The update is
clipped to an RMS of ``clip_threshold`` over the whole stacked leaf (every
layer of the stage, every expert), decoupled weight decay joins it on
``ndim >= 2`` leaves, and the parameter is rounded once to its dtype. The
state tree is ``{"f": {<param path>: {"v_row", "v_col"} | {"v"}},
"count"}`` with the JAX leaf names, so either package restores the other's
checkpoints.

As ``AdamW``, ``update`` writes the parameters and the state into the
tensors it was given (the JAX step donates its state) and returns the same
trees; the f32 temporaries of a leaf are freed before the next leaf, so a
step holds at most about two f32 copies of the largest leaf beside the
state.

On a mesh the update runs on each rank's local shards (``layout``, a
``sharding.partition.ShardLayout``): ``v_row`` and ``v_col`` take their
parameter's sharding with the reduced dim dropped, and the three
reductions that cross shards are summed over them — the row and column
means of ``g² + eps`` over a sharded dim, the mean of ``v_row`` that
normalises it, and the RMS of the update over the whole stacked leaf.
"""
from __future__ import annotations

import math

from ..core.split_state import leaf_paths, map_leaves


class Adafactor:
    def __init__(self, decay=0.99, eps=1e-30, clip_threshold=1.0,
                 min_dim_size_to_factor=32, weight_decay=0.0):
        self.decay = decay
        self.eps = eps
        self.clip_threshold = clip_threshold
        self.min_factor = min_dim_size_to_factor
        self.weight_decay = weight_decay

    def _factored(self, p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= self.min_factor
                and p.shape[-2] >= self.min_factor)

    def init(self, params):
        """Zero state on the params' device (meta params give a meta
        state: a restore target)."""
        import torch

        def leaf(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if self._factored(p):
                return {"v_row": zeros(p.shape[:-1]),
                        "v_col": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        dev = next(t for _, t in leaf_paths(params)).device
        return {"f": map_leaves(leaf, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def _leaf(self, p, g, s, lr, name=None, layout=None):
        import torch
        d = self.decay
        g = g.to(torch.float32, copy=True)     # the caller's grads stay
        if "v_row" in s:
            g2 = g.square().add_(self.eps)
            row = _mean(g2, -1, name, layout, -1)
            col = _mean(g2, -2, name, layout, -2)
            del g2
            s["v_row"].mul_(d).add_(row.mul_(1 - d))
            s["v_col"].mul_(d).add_(col.mul_(1 - d))
            v_row, v_col = s["v_row"], s["v_col"]
            r = v_row / torch.clamp(_mean(v_row, -1, name, layout, -2,
                                          keepdim=True), min=self.eps)
            denom = (torch.sqrt(r)[..., None]
                     * torch.sqrt(v_col)[..., None, :]).add_(1e-12)
            u = g.div_(denom)
            del denom
        else:
            s["v"].mul_(d).add_(g.square().add_(self.eps).mul_(1 - d))
            u = g.div_(torch.sqrt(s["v"]).add_(1e-12))
        # update clipping: RMS over the whole (stacked) leaf <= threshold
        if layout is None or not layout.axes(name):
            rms = torch.linalg.vector_norm(u) / math.sqrt(u.numel())
        else:
            rms = torch.sqrt(layout.psum_(name, u.square().sum())) / \
                math.sqrt(math.prod(layout.shapes[name]))
        u.div_(torch.clamp(rms / self.clip_threshold, min=1.0))
        if self.weight_decay and p.dim() >= 2:
            u.add_(p.to(torch.float32, copy=True).mul_(self.weight_decay))
        # p - lr·u, rounded once to the parameter's dtype
        p.copy_(u.mul_(lr).neg_().add_(p))

    def update(self, grads, state, params, lr, layout=None):
        """Apply one step in place; returns (params, opt_state), the trees
        that were passed in. With a `layout`, every tree holds this rank's
        local shards."""
        import torch
        state["count"].add_(1)
        flat_g = dict(leaf_paths(grads))
        flat_s = {}
        for name, t in leaf_paths(state["f"]):
            leaf, key = name.rsplit("/", 1)
            flat_s.setdefault(leaf, {})[key] = t
        with torch.no_grad():
            for name, p in leaf_paths(params):
                self._leaf(p, flat_g[name], flat_s[name], lr, name, layout)
        return params, state

    def state_sharding(self, param_specs, abstract_params, mesh):
        """Factored stats inherit the param spec with the reduced dim
        dropped."""
        from ..sharding.partition import NamedSharding, replicated

        def leaf(sharding, p):
            parts = list(sharding.spec) + [None] * (p.dim()
                                                    - len(sharding.spec))
            if self._factored(p):
                return {"v_row": NamedSharding(mesh, tuple(parts[:-1])),
                        "v_col": NamedSharding(
                            mesh, tuple(parts[:-2] + parts[-1:]))}
            return {"v": NamedSharding(mesh, tuple(parts))}

        def walk(specs, params):
            return {k: walk(specs[k], v) if isinstance(v, dict)
                    else leaf(specs[k], v) for k, v in params.items()}

        return {"f": walk(param_specs, abstract_params),
                "count": replicated(mesh)}


def _mean(t, dim, name, layout, param_dim, keepdim=False):
    """``t.mean(dim)``; over a dim that is sharded (parameter dim
    `param_dim` of leaf `name` in `layout`), the local sum summed over
    the shards and divided by the global length."""
    axes = () if layout is None else layout.axes(name, [param_dim])
    if not axes:
        return t.mean(dim, keepdim=keepdim)
    n = layout.shapes[name][param_dim]
    return layout.psum_(name, t.sum(dim, keepdim=keepdim),
                        [param_dim]).div_(n)
