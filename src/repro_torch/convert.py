"""Carry a training state between the JAX package's form and the port's.

The JAX side is a nested dict of numpy arrays (``np.asarray`` of each JAX
leaf: bfloat16 as an ``ml_dtypes`` array); the port's is a nested dict of
tensors. bfloat16 crosses as its 16-bit pattern (``torch.Tensor.numpy()``
refuses bf16), so no bit changes on the way; every leaf keeps its own
dtype (a MoE router's float32 among bfloat16 params, Adafactor's float32
``opt/f/**`` factors and its int32 ``count``). The tests move weights and
state across with these two functions.
"""
from __future__ import annotations

import numpy as np

from .core.codec import dtype_name
from .core.save_path import to_host
from .core.split_state import map_leaves
from .devices import resolve_device
from .sharding.collectives import full_tensor


def from_jax_state(np_tree, device=None, shardings=None):
    """Nested dict of numpy arrays → nested dict of tensors on `device`
    (``None`` → CUDA); with `shardings` (a matching tree of
    ``sharding.partition.NamedSharding``) each full leaf is distributed by
    its placements, this rank keeping its local range as a ``DTensor``."""
    import torch
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, order="C")       # a copy; keeps 0-d leaves 0-d
        name = dtype_name(a)
        if name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).to(dev) \
                .view(torch.bfloat16)
        if name == "uint32":
            return torch.from_numpy(a.view(np.int32)).to(dev) \
                .view(torch.uint32)
        return torch.from_numpy(a).to(dev)

    tree = map_leaves(leaf, np_tree)
    if shardings is None:
        return tree
    from .sharding.partition import distribute_tree
    return distribute_tree(tree, shardings)


def params_from_jax(np_params, device=None):
    """The JAX ``Model.init`` parameter tree (nested dict of numpy arrays)
    → the port's ``Model`` parameter tree on `device`: the same nested
    names and stacked stage axes, so ``split_state.leaf_paths`` of a
    serving checkpoint match the JAX package's one for one. A thin alias of
    ``from_jax_state``, named for this use."""
    return from_jax_state(np_params, device)


def to_numpy_state(state):
    """Nested dict of tensors → nested dict of host numpy arrays; bfloat16
    leaves come back as ``core.codec.BF16`` (their uint16 bit pattern,
    logical dtype ``bfloat16``). A ``DTensor`` leaf is gathered to its
    full tensor first (``sharding.collectives.full_tensor``)."""
    return map_leaves(lambda t: to_host(full_tensor(t)
                                        if hasattr(t, "full_tensor") else t),
                      state)
