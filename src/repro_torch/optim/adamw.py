"""AdamW with f32 moments (``src/repro/optim/adamw.py`` on PyTorch).

The same f32 math, step by step: bias corrections ``1 - b ** count``, the
update ``(m / bc1) / (sqrt(v / bc2) + eps)``, decoupled weight decay on
``ndim >= 2`` leaves only, and the parameter rounded once to its dtype.
Every quantity stays a tensor on the state's device (the learning rate and
the count too), so a step never waits for the host.

One deviation, named here: ``update`` writes the new parameters and
moments into the tensors it was given and returns the same trees. The JAX
step donates its state (``donate_argnums``), so the caller owns no old
state in either package; in place, the port holds one copy of the 10 GB
state instead of two at the end of a step.

On a mesh the update runs on each rank's local shards: ``layout``
(``sharding.partition.ShardLayout``) names how every leaf is sharded, and
the one reduction AdamW makes, the global norm of the clip, sums each
leaf's local sum of squares over its shards before the leaves are added.
"""
from __future__ import annotations

from ..core.split_state import leaf_paths


def global_norm(grads, layout=None):
    """sqrt of the sum of squares of every leaf in f32, summed leaf by leaf
    in flatten order (as the JAX package's Python ``sum``). With a
    `layout`, `grads` are local shards and each leaf's sum is summed over
    its shards first."""
    import torch

    def sq(name, g):
        s = g.float().square().sum()
        return s if layout is None else layout.psum_(name, s)

    return torch.sqrt(sum(sq(n, g) for n, g in leaf_paths(grads)))


class AdamW:
    def __init__(self, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 clip_norm=1.0):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params):
        import torch
        dev = next(t for _, t in leaf_paths(params)).device

        def zeros(tree):
            return {k: zeros(v) if isinstance(v, dict)
                    else torch.zeros(v.shape, dtype=torch.float32,
                                     device=v.device)
                    for k, v in tree.items()}

        return {"m": zeros(params), "v": zeros(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params, lr, layout=None):
        """Apply one step in place (see the module docstring); returns
        (params, opt_state), the trees that were passed in. With a
        `layout`, every tree holds this rank's local shards."""
        import torch
        grads = clip_by_global_norm(grads, self.clip_norm, layout)
        state["count"].add_(1)
        c = state["count"].float()
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=c.device), c)
        flat_g = dict(leaf_paths(grads))
        flat_m = dict(leaf_paths(state["m"]))
        flat_v = dict(leaf_paths(state["v"]))
        with torch.no_grad():
            for name, p in leaf_paths(params):
                g = flat_g[name].float()
                m, v = flat_m[name], flat_v[name]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                del g
                if p.dim() >= 2:    # decoupled wd on matrices only
                    step = step + self.weight_decay * p.float()
                p.copy_((p.float() - lr * step).to(p.dtype))
        return params, state

    def state_sharding(self, param_specs, abstract_params, mesh):
        """The moments take their parameter's sharding."""
        from ..sharding.partition import replicated
        return {"m": param_specs, "v": param_specs,
                "count": replicated(mesh)}


def clip_by_global_norm(grads, max_norm, layout=None):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))`` in f32,
    rounded back to the leaf's dtype (new tensors)."""
    import torch
    if not max_norm:
        return grads
    norm = global_norm(grads, layout)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(tree):
        return {k: clip(v) if isinstance(v, dict)
                else (v.float() * scale).to(v.dtype) for k, v in tree.items()}

    return clip(grads)
