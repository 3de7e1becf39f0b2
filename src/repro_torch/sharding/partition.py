"""Logical-axis sharding resolver (``src/repro/sharding/partition.py`` on
PyTorch): DP/FSDP/TP/EP over the assigned meshes.

Parallelism layout (the reference's):
  * batch (DP)      → ("pod", "data")   — pods are pure data-parallel replicas
  * FSDP (ZeRO-3)   → "data"            — weight matrices shard their non-TP
                                          dim over "data"
  * TP              → "model"           — attention heads, FFN hidden, vocab
  * EP              → "model"           — MoE expert dim

Every rule is divisibility-checked: a dim that does not divide the mesh axis
falls back to replication, so no shard is ever uneven.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry per
tensor dim, each ``None``, an axis name, or a tuple of axis names (one
tensor dim sharded over several mesh axes, major to minor); a one-name
tuple is written as the name, as JAX canonicalises it, and ``()`` is the
fully replicated spec ``P()``. ``NamedSharding(mesh, spec)`` pairs a spec
with a mesh and turns it into ``DTensor`` placements: ``Shard(d)`` on each
mesh dim that shards tensor dim ``d``, ``Replicate()`` on every other. The
mesh may be a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``: specs,
placements and index ranges read only its shape and axis names.

``act_constrainer(cfg, mesh)`` gives the reference's activation layout:
the spec of each named activation (``resid``, ``attn_q``, ``attn_kv``,
their ``_local`` forms and ``moe_in``), which the model's training forward
on a mesh computes with explicit collectives (``models.parallel``) where
GSPMD would insert them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.elastic import ShardRange
from ..core.split_state import leaf_paths, map_leaves


@dataclass(frozen=True)
class MeshAxes:
    batch: tuple          # axes for the batch/DP dimension, e.g. ("pod","data")
    fsdp: str | None      # axis for weight (ZeRO-3) sharding
    model: str | None     # axis for TP/EP
    batch_size: int
    fsdp_size: int
    tp: int


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axes(mesh) -> MeshAxes:
    names = tuple(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    if "pod" in names:
        batch = ("pod", "data")
    elif "data" in names:
        batch = ("data",)
    else:
        batch = ()
    fsdp = "data" if "data" in names else None
    model = "model" if "model" in names else None
    bs = 1
    for a in batch:
        bs *= sizes[a]
    return MeshAxes(batch, fsdp, model,
                    batch_size=bs,
                    fsdp_size=sizes.get("data", 1),
                    tp=sizes.get("model", 1))


def _div(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _axis(ax: MeshAxes, which: str, dim: int):
    """Return the mesh axis for a logical axis iff the dim divides it."""
    if which == "model":
        return ax.model if ax.model and _div(dim, ax.tp) else None
    if which == "fsdp":
        return ax.fsdp if ax.fsdp and _div(dim, ax.fsdp_size) else None
    if which == "batch":
        return ax.batch if ax.batch and _div(dim, ax.batch_size) else None
    raise ValueError(which)


def _entry(e):
    """One spec entry as JAX canonicalises it: a one-name tuple is the
    name, an empty one is None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def P(*parts) -> tuple:
    """``PartitionSpec(*parts)`` as a tuple."""
    return tuple(_entry(p) for p in parts)


def entry_axes(entry) -> tuple:
    """The mesh axes one spec entry names, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# parameter shardings (by leaf path)
# ---------------------------------------------------------------------------

def spec_for_param(path, shape: tuple, ax: MeshAxes) -> tuple:
    """path: the leaf's keys (a tuple of str, or a ``/``-joined name)."""
    names = path.split("/") if isinstance(path, str) else \
        [getattr(p, "key", str(p)) for p in path]
    leaf = names[-1]
    in_rglru = "rglru" in names
    in_ssm = "ssm" in names

    def s(dims):  # helper: dims is list of logical axes per dim
        parts = [(_axis(ax, d, shape[i]) if d else None)
                 for i, d in enumerate(dims)]
        return P(*parts)

    nd = len(shape)
    if leaf == "embed":
        # vocab over TP only: an fsdp-sharded d_model would put the LM-head
        # contraction on a sharded dim
        return s(["model", None])
    if leaf == "lm_head":
        return s([None, "model"])
    if leaf in ("q", "k", "v") and not (in_rglru or in_ssm):
        return s([None, "fsdp", "model", None][:nd] if nd == 4
                 else ["fsdp", "model", None])
    if leaf == "o" and nd >= 3:
        return s([None, "model", None, "fsdp"][:nd] if nd == 4
                 else ["model", None, "fsdp"])
    if leaf in ("wg", "wu", "wi"):
        if in_rglru:  # rglru wg: (R, d, w)
            return s([None, "fsdp", "model"][:nd])
        if nd == 4:   # moe experts (R, E, d, f)
            return s([None, "model", "fsdp", None])
        return s([None, "fsdp", "model"][:nd] if nd == 3
                 else ["fsdp", "model"])
    if leaf == "wd":
        if nd == 4:   # moe experts (R, E, f, d)
            return s([None, "model", None, "fsdp"])
        return s([None, "model", "fsdp"][:nd] if nd == 3
                 else ["model", "fsdp"])
    if leaf == "router":
        return s([None, "fsdp", None][:nd])
    if in_rglru:
        if leaf == "wx":
            return s([None, "fsdp", "model"][:nd])
        if leaf == "wo":
            return s([None, "model", "fsdp"][:nd])
        if leaf in ("lam", "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b",
                    "conv_b"):
            return s([None, "model"][:nd])
        if leaf == "conv_w":
            return s([None, None, "model"][:nd])
    if in_ssm:
        if leaf == "in_proj":
            return s([None, "fsdp", "model"][:nd])
        if leaf == "out_proj":
            return s([None, "model", "fsdp"][:nd])
        if leaf == "conv_w":
            return s([None, None, "model"][:nd])
        if leaf in ("conv_b", "out_norm"):
            return s([None, "model"][:nd])
        if leaf in ("A_log", "D", "dt_bias"):
            return s([None, "model"][:nd])
    # norms, biases, pos_conv, everything small: replicated
    return P()


# ---------------------------------------------------------------------------
# a spec on a mesh: placements and index ranges
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding`` on PyTorch: a spec on a mesh."""
    mesh: object
    spec: tuple

    def dim_axes(self, ndim: int) -> list:
        """Per tensor dim, the mesh axes that shard it (major to minor)."""
        parts = list(self.spec) + [None] * (ndim - len(self.spec))
        return [entry_axes(e) for e in parts[:ndim]]

    @property
    def placements(self) -> tuple:
        """One ``DTensor`` placement per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, e in enumerate(self.spec):
            axes = entry_axes(e)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                # DTensor shards one tensor dim over several mesh dims in
                # mesh order; the reference's specs always name them so
                raise ValueError(f"spec entry {e!r} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def range_at(self, shape, coord) -> ShardRange:
        """Index range the device at mesh coordinate `coord` holds."""
        sizes = _sizes(self.mesh)
        pos = dict(zip(self.mesh.mesh_dim_names, coord))
        start, stop = [], []
        for n, axes in zip(shape, self.dim_axes(len(shape))):
            k, i = 1, 0
            for a in axes:          # mixed radix, major first
                k, i = k * sizes[a], i * sizes[a] + pos[a]
            if n % k:
                raise ValueError(f"dim {n} does not divide over {axes}")
            start.append(i * (n // k))
            stop.append((i + 1) * (n // k))
        return ShardRange(tuple(start), tuple(stop))

    def device_ranges(self, shape) -> list:
        """Index range of every device, in flat mesh order (rank order)."""
        dims = tuple(self.mesh.shape)
        out = []
        for r in range(math.prod(dims)):
            coord, rem = [], r
            for n in reversed(dims):
                coord.append(rem % n)
                rem //= n
            out.append(self.range_at(shape, tuple(reversed(coord))))
        return out

    def unique_ranges(self, shape) -> list:
        """(range, owner rank) per distinct range, in the order JAX's
        ``addressable_shards`` meets them: the lowest rank holding a range
        owns it (a replicated range is saved once)."""
        seen, out = set(), []
        for r, rng in enumerate(self.device_ranges(shape)):
            key = (rng.start, rng.stop)
            if key not in seen:
                seen.add(key)
                out.append((rng, r))
        return out

    def flat_rank(self) -> int:
        """This rank's flat position in the mesh (a ``DeviceMesh`` only)."""
        r = 0
        for n, c in zip(tuple(self.mesh.shape), self.mesh.get_coordinate()):
            r = r * n + c
        return r

    def local_range(self, shape) -> ShardRange:
        """This rank's range (a ``DeviceMesh`` only)."""
        return self.range_at(shape, tuple(self.mesh.get_coordinate()))


def sharding_of(t) -> NamedSharding:
    """The ``NamedSharding`` of a ``DTensor``'s placements (Shard and
    Replicate only; several mesh dims sharding one tensor dim in mesh
    order, as DTensor applies them)."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    parts = [[] for _ in range(t.dim())]
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            parts[pl.dim % t.dim()].append(names[i])
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} has no index range")
    return NamedSharding(mesh, P(*parts))


def param_specs(abstract_params, mesh):
    """``NamedSharding`` of every parameter leaf, in the params' tree."""
    ax = mesh_axes(mesh)

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}/{k}" if prefix else k
            out[k] = walk(v, name) if isinstance(v, dict) else \
                NamedSharding(mesh, spec_for_param(name, tuple(v.shape), ax))
        return out

    return walk(abstract_params, "")


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# batch & cache shardings
# ---------------------------------------------------------------------------

def batch_axes_for(cfg, ax: MeshAxes, batch_dim: int):
    """DP axes for a given global batch size. With cfg.dp_over_model the
    "model" axis joins DP when the batch divides it."""
    if getattr(cfg, "dp_over_model", False) and ax.model:
        full = ax.batch + (ax.model,)
        if batch_dim % (ax.batch_size * ax.tp) == 0:
            return full
    return ax.batch


# ---------------------------------------------------------------------------
# activation layout (installed into the model via models.set_constrainer)
# ---------------------------------------------------------------------------

class ActLayout:
    """``act_constrainer(cfg, mesh)``: the reference's activation specs
    (``specs``, name → spec, key by key ``src/repro/sharding/partition.py::
    act_constrainer``) and what the model's forward on a mesh reads from
    them (``models.parallel``):

    * ``tp_axis``: the axis that splits heads, FFN hidden, vocab and
      experts (``"model"``), or None where nothing does (no model axis, a
      model axis of one, or ``dp_over_model``, which makes it a batch axis);
    * ``seq_resid``: the residual stream holds this rank's 1/tp of the
      sequence (``resid`` sharded on dim 1: ``seq_shard_resid``);
    * ``seq_attn``: global attention computes this rank's 1/tp of the
      query rows against the whole key sequence, every head (``attn_q``
      sharded on dim 1: ``seq_shard_attn`` where the heads do not divide);
    * ``param_spec(name)``: a parameter leaf's spec (the partition rules).

    ``batch_axes`` (the axes the batch rows are split over) is set by the
    train step that computes with the layout."""

    def __init__(self, cfg, mesh):
        ax = mesh_axes(mesh)
        tp = ax.tp
        heads_div = tp <= 1 or cfg.n_heads == 0 or cfg.n_heads % tp == 0
        kv_div = tp <= 1 or cfg.n_kv_heads == 0 or cfg.n_kv_heads % tp == 0
        batch = ax.batch or None
        model = ax.model
        if getattr(cfg, "dp_over_model", False) and model:
            # batch takes the model axis too; nothing else shards over it
            batch = ax.batch + (model,)
            model = None
            heads_div = True  # suppress the SP fallback specs below
        specs = {}
        if getattr(cfg, "seq_shard_resid", False) and model:
            specs["resid"] = P(batch, model, None)
        else:
            specs["resid"] = P(batch, None, None)
        if heads_div:
            specs["attn_q"] = P(batch, None, model, None)
            specs["attn_kv"] = P(batch, None, model if kv_div else None,
                                 None)
            specs["attn_q_local"] = specs["attn_q"]
            specs["attn_kv_local"] = specs["attn_kv"]
        else:
            if cfg.seq_shard_attn:
                # global attention: shard the q sequence dim (SP); kv
                # replicated
                specs["attn_q"] = P(batch, model, None, None)
            else:
                specs["attn_q"] = P(batch, None, None, None)
            specs["attn_kv"] = P(batch, None, None, None)
            # local attention: heads replicated fallback
            specs["attn_q_local"] = P(batch, None, None, None)
            specs["attn_kv_local"] = P(batch, None, None, None)
        d_div = tp <= 1 or cfg.d_model % tp == 0
        specs["moe_in"] = P(batch, None, model if d_div else None)
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.tp_axis = model if model and tp > 1 else None
        self.tp = tp if self.tp_axis else 1
        self.seq_resid = self.tp_axis is not None and \
            specs["resid"][1] is not None
        self.seq_attn = self.tp_axis is not None and \
            specs["attn_q"][1] is not None
        self.batch_axes = tuple(entry_axes(specs["resid"][0]))
        self._pspecs = None

    def group(self, axis):
        """The process group of mesh axis `axis` (None: no axis)."""
        return None if axis is None else self.mesh.get_group(axis)

    def coord(self, axis) -> int:
        """This rank's coordinate on mesh axis `axis` (0 for None)."""
        if axis is None:
            return 0
        names = tuple(self.mesh.mesh_dim_names)
        return self.mesh.get_coordinate()[names.index(axis)]

    def param_spec(self, name: str) -> tuple:
        """The spec of parameter leaf `name` (``/``-joined, stacked
        layout) under the partition rules."""
        if self._pspecs is None:
            from ..state import abstract_params
            self._pspecs = {n: sh.spec for n, sh in leaf_paths(param_specs(
                abstract_params(self.cfg), self.mesh))}
        return self._pspecs[name]


def act_constrainer(cfg, mesh) -> ActLayout:
    return ActLayout(cfg, mesh)


def _size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_spec(batch_shapes: dict, mesh, cfg=None):
    """Shard every batch input on its leading (batch) dim when divisible."""
    ax = mesh_axes(mesh)

    def leaf(x):
        ndim = len(x.shape)
        if not ndim:
            return NamedSharding(mesh, P())
        b = x.shape[0]
        axes = batch_axes_for(cfg, ax, b) if cfg is not None else ax.batch
        size = _size(mesh, axes) if axes else 1
        if not axes or b % size:
            axes = _axis(ax, "batch", b)
        return NamedSharding(mesh, P(axes, *([None] * (ndim - 1))))

    return map_leaves(leaf, batch_shapes)


def cache_specs(abstract_cache, mesh, cfg):
    """Decode caches: (R, B, L, K, hd) attn / (R, B, ...) states.

    Batch shards over DP axes when divisible; otherwise the sequence dim of
    attention caches shards over "model" (long-context, batch=1 decode) and
    head/state dims shard over "model" when divisible.
    """
    ax = mesh_axes(mesh)

    def leaf(name, x):
        shape = tuple(x.shape)
        if not shape:
            return NamedSharding(mesh, P())
        if name.split("/")[-1] in ("k", "v") and len(shape) == 5:
            R, B, L, K, hd = shape
            b_ax = _axis(ax, "batch", B)
            if b_ax is not None:
                k_ax = _axis(ax, "model", K)
                l_ax = _axis(ax, "model", L) if k_ax is None else None
                return NamedSharding(mesh, P(None, b_ax, l_ax, k_ax, None))
            # batch too small: shard the sequence dim over everything we can
            l_axes = tuple(a for a in ((ax.fsdp,) + ((ax.model,)
                                                     if ax.model else ()))
                           if a) or None
            if l_axes and L % _size(mesh, l_axes) == 0:
                return NamedSharding(mesh, P(None, None, l_axes, None, None))
            return NamedSharding(mesh, P())
        # recurrent / conv states: (R, B, ...)
        B = shape[1]
        b_ax = _axis(ax, "batch", B)
        rest = [None] * (len(shape) - 2)
        if len(shape) >= 3:
            m_ax = _axis(ax, "model", shape[2])
            if b_ax is not None or m_ax is not None:
                rest[0] = m_ax
        return NamedSharding(mesh, P(None, b_ax, *rest))

    flat = {n: leaf(n, x) for n, x in leaf_paths(abstract_cache)}

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else flat[f"{prefix}/{k}"
                                                 if prefix else k]
                for k, v in tree.items()}

    return walk(abstract_cache, "")


# ---------------------------------------------------------------------------
# reductions across the shards of a leaf (the optimizers' sharded update)
# ---------------------------------------------------------------------------

class ShardLayout:
    """The parameter leaves' layout on a ``DeviceMesh`` as an optimizer
    sees it: per ``/``-joined param name, the global shape and the
    ``NamedSharding``. An update on local shards calls ``psum_`` where the
    one-device update reduces over a dim (or the whole leaf): the partial
    result is summed over the mesh axes that shard those dims, one
    all-reduce per axis over that axis's group."""

    def __init__(self, shardings: dict, shapes: dict):
        self.shardings = shardings
        self.shapes = shapes

    @classmethod
    def of(cls, param_shardings, abstract_params) -> "ShardLayout":
        return cls(dict(leaf_paths(param_shardings)),
                   {n: tuple(p.shape) for n, p in leaf_paths(abstract_params)})

    def axes(self, name: str, dims=None) -> tuple:
        """Mesh axes that shard tensor dims `dims` (all dims if None)."""
        shape = self.shapes[name]
        per = self.shardings[name].dim_axes(len(shape))
        dims = range(len(shape)) if dims is None else \
            [d % len(shape) for d in dims]
        return tuple(a for d in dims for a in per[d])

    def psum_(self, name: str, t, dims=None):
        """Sum `t` in place over the shards of dims `dims` of leaf
        `name`; returns `t`."""
        import torch.distributed as dist
        mesh = self.shardings[name].mesh
        for a in self.axes(name, dims):
            dist.all_reduce(t, group=mesh.get_group(a))
        return t


def distribute_tree(tree, shardings):
    """A tree of full tensors (every rank holding the same values) as
    ``DTensor``s placed by `shardings` (the same tree of
    ``NamedSharding``): each rank keeps its local range of every leaf (the
    full tensor itself where the range is the whole leaf)."""
    from torch.distributed.tensor import DTensor
    flat = dict(leaf_paths(shardings))

    def walk(node, prefix):
        out = {}
        for k, t in node.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(t, dict):
                out[k] = walk(t, name)
                continue
            sh = flat[name]
            rng = sh.local_range(tuple(t.shape))
            local = t
            if tuple(rng.shape) != tuple(t.shape):
                local = t[tuple(slice(a, b) for a, b in
                                zip(rng.start, rng.stop))].clone()
            out[k] = DTensor.from_local(local, sh.mesh, sh.placements,
                                        run_check=False, shape=t.shape,
                                        stride=t.stride())
        return out

    return walk(tree, "")
