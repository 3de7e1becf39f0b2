"""Split-state model — the PyTorch adaptation of MANA's split-process
approach.

MANA tags application memory as *upper half* (checkpointed) and MPI/network
libraries as *lower half* (re-instantiated by a trivial MPI application on
restart). Here:

  upper half  = TrainState: {params, opt, step, rng} — a nested dict of
                tensors. This is the ONLY thing checkpoints persist.
  lower half  = mesh, shardings, device, streams, kernel libraries —
                derived from (config, current topology) at restore time.

Because the upper half stores *logical* tensors (global shape + dtype +
index ranges per shard), a checkpoint taken on one mesh restores onto any
other — the M×N portability property, strengthened to elasticity.

Leaf names are the JAX package's: ``/``-joined dict keys, walked in SORTED
key order (what ``jax.tree_util`` does with dicts), so a checkpoint written
by either package names and orders its leaves identically.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def leaf_paths(tree, prefix: str = ""):
    """Stable string path per leaf, in flatten order — checkpoint shard
    naming ("memory-region table" entries, Lesson 1)."""
    out = []
    for key, sub in _items(tree):
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(sub, (dict, list, tuple)):
            out.extend(leaf_paths(sub, name))
        else:
            out.append((name, sub))
    return out


def map_leaves(fn, tree):
    """`fn` over the leaves of a nested dict (anything that is not a dict
    is a leaf), keeping its keys."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(template, leaves):
    """Rebuild `template`'s nested structure with `leaves` (in
    ``leaf_paths`` order) in place of its leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def init_train_state(model, optimizer, *, seed: int = 0, device=None):
    """Concrete initial state ``{"params", "opt", "step", "rng"}`` of the
    JAX ``init_train_state``: ``model.init`` drawn from `seed` on `device`
    (``None`` → CUDA), the optimizer's state of those params, an int32
    ``step`` of 0 and the uint32 ``rng`` words of ``PRNGKey(0)`` (zeros)."""
    import torch
    params = model.init(seed=seed, device=device)
    dev = next(t for _, t in leaf_paths(params)).device
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        # uint32 has few kernels: build the zeros as int32 and reinterpret
        "rng": torch.zeros(2, dtype=torch.int32, device=dev)
        .view(torch.uint32),
    }


def abstract_train_state(model, optimizer):
    """The state's tree as meta tensors (leaf names, shapes and dtypes of
    the JAX ``abstract_train_state``; no allocation) — a restore
    target."""
    import torch
    params = model.abstract_params()
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "rng": torch.empty(2, dtype=torch.int32, device="meta")
        .view(torch.uint32),
    }


def state_shardings(abstract_state, mesh, optimizer):
    """``partition.NamedSharding`` of every state leaf on `mesh`: the
    params by the reference's partition rules, the optimizer's state by
    its ``state_sharding``, ``step`` and ``rng`` replicated."""
    from ..sharding.partition import param_specs, replicated
    ps = param_specs(abstract_state["params"], mesh)
    return {
        "params": ps,
        "opt": optimizer.state_sharding(ps, abstract_state["params"], mesh),
        "step": replicated(mesh),
        "rng": replicated(mesh),
    }


# ---------------------------------------------------------------------------
# lower half
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LowerHalfDescriptor:
    """Recorded in the manifest FOR INFORMATION ONLY — restore never requires
    any of it to match (that's the point of the split)."""
    mesh_shape: tuple
    mesh_axes: tuple
    n_devices: int
    runtime: str
    config_digest: str

    def to_json(self):
        return asdict(self)


def config_digest(cfg) -> str:
    blob = json.dumps(asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def lower_half_descriptor(mesh, cfg) -> LowerHalfDescriptor:
    """The mesh's shape and axis names (a ``DeviceMesh`` or an
    ``AbstractMesh``); ``mesh=None`` is one device, ``(1,)`` on
    ``("data",)``."""
    import torch
    shape = (1,) if mesh is None else tuple(mesh.shape)
    return LowerHalfDescriptor(
        mesh_shape=shape,
        mesh_axes=("data",) if mesh is None
        else tuple(mesh.mesh_dim_names),
        n_devices=math.prod(shape),
        runtime=f"torch-{torch.__version__}",
        config_digest=config_digest(cfg),
    )
