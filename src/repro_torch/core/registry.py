"""Annotated state-region table with runtime checks — paper Lesson 1:

  "an annotated table of all memory regions, along with dynamic runtime
   checks, would help catch bugs early in the development phase."

Every upper-half leaf gets a registry row (name, shape, dtype, bytes, role,
sharding description). The table is validated (a) before save, (b) against
the manifest after restore — shape/dtype/name drift is caught at the
boundary with a coded error instead of corrupting training state.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from .codec import dtype_name
from .errors import RegistryMismatchError
from .namespace import check_leaf_name
from .split_state import leaf_paths


@dataclass(frozen=True)
class Region:
    name: str
    shape: tuple
    dtype: str
    nbytes: int
    role: str            # params | opt | step | rng | data | other
    sharding: str = ""


def _role(name: str) -> str:
    head = name.split("/", 1)[0]
    return head if head in ("params", "opt", "step", "rng") else "other"


def build_registry(state) -> list:
    rows = []
    for name, leaf in leaf_paths(state):
        check_leaf_name(name)
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = (dtype_name(leaf) if hasattr(leaf, "dtype")
                 else type(leaf).__name__)
        size = int(np.prod(shape)) if shape else 1
        itemsize = np.dtype("float32").itemsize
        try:
            itemsize = np.dtype(dtype).itemsize
        except TypeError:
            if dtype == "bfloat16":
                itemsize = 2
        # single-device tensors carry no sharding spec (as a JAX array on
        # one device records "")
        rows.append(Region(name, shape, dtype, size * itemsize,
                           _role(name)))
    return rows


def registry_json(rows) -> list:
    return [asdict(r) for r in rows]


def validate_against(state, manifest_leaves: dict, *, strict: bool = True):
    """Post-restore runtime check: every state leaf must match the manifest's
    recorded region (name, shape, dtype)."""
    problems = []
    for name, leaf in leaf_paths(state):
        rec = manifest_leaves.get(name)
        if rec is None:
            problems.append(f"leaf {name!r} missing from manifest")
            continue
        if tuple(rec["shape"]) != tuple(leaf.shape):
            problems.append(
                f"{name}: shape {tuple(leaf.shape)} != saved "
                f"{tuple(rec['shape'])}")
        if str(rec["dtype"]) != dtype_name(leaf):
            problems.append(
                f"{name}: dtype {dtype_name(leaf)} != saved {rec['dtype']}")
    extra = set(manifest_leaves) - {n for n, _ in leaf_paths(state)}
    if extra and strict:
        problems.append(f"manifest has {len(extra)} unknown leaves "
                        f"(e.g. {sorted(extra)[:3]})")
    if problems:
        raise RegistryMismatchError("state-region table validation failed",
                                    problems=problems[:10],
                                    n_problems=len(problems))
    return True


def total_bytes(rows) -> int:
    return sum(r.nbytes for r in rows)
