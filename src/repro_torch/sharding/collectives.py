"""Differentiable collectives over one mesh axis: the PyTorch form of what
GSPMD inserts for the reference's layout (FSDP gathers, the TP/SP
reductions, the EP exchange).

Each takes the axis's process group (``DeviceMesh.get_group(axis)``) and
is a ``torch.autograd.Function`` whose backward is its forward's adjoint:

  all_gather(x, g, dim)       concatenate every rank's x along `dim`;
                              backward: reduce-scatter along `dim`
  reduce_scatter(x, g, dim)   sum over the ranks, keep this rank's
                              slice of `dim`; backward: all-gather
  all_reduce(x, g)            sum over the ranks; backward: all-reduce
  copy_to(x, g)               Megatron's f: identity forward, all-reduce
                              backward (a tensor replicated over the axis
                              whose users on each rank see a share of the
                              loss)
  reduce_from(x, g)           Megatron's g: all-reduce forward, identity
                              backward (each rank's share of the loss
                              summed into the replicated total)
  all_to_all(x, g)            dim 0 in equal blocks, block r to rank r;
                              backward: the reverse exchange (the same op)
  full_tensor(t)              a ``DTensor``'s full tensor (not
                              differentiable): c10d all-gathers, where
                              ``DTensor.full_tensor`` issues functional
                              collectives
  gather_param(t, gathers, replicated)
                              a parameter leaf's local shard to the
                              tensor a layer computes with: copy_to over
                              the axes that replicate it, all-gather of
                              each (group, dim) in `gathers`; backward:
                              the gradient's reduce-scatters and
                              all-reduces in f32, rounded once

Sums run in f32 and are rounded once to the tensor's dtype (a bf16 partial
sum is never rounded between ranks). A group of one rank is the identity.

gloo runs all four primitives (all-gather into a tensor, reduce-scatter
into a tensor, all-to-all, all-reduce) on CUDA tensors in the torch builds
the port runs on, so nothing is staged through host memory:
``chip_smoke.py``'s parallel phase checks each on the card before it
trains. ``all_gather_single``/``reduce_scatter_single`` (torch 2.13, which
deprecates the ``*_into_tensor``/``*_tensor`` names) are used where the
build has them.
"""
from __future__ import annotations

import functools


def size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def _front(x, dim):
    """`x` with `dim` moved to the front, contiguous."""
    return x.movedim(dim, 0).contiguous() if dim else x.contiguous()


def _all_gather_raw(x, group, dim: int):
    import torch
    import torch.distributed as dist
    n = size(group)
    if n == 1:
        return x
    xf = _front(x, dim)
    out = torch.empty((n * xf.shape[0],) + tuple(xf.shape[1:]),
                      dtype=x.dtype, device=x.device)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, xf, group=group)
    return out.movedim(0, dim) if dim else out


# f32 elements a reduce-scatter stages at once (256 MB): a layer's gathered
# expert stack is 1.3 GB of f32 gradient
_STAGE_ELEMS = 1 << 26


def _reduce_scatter_raw(x, group, dim: int):
    """f32 sum over the group of `x`, this rank's block of `dim` (f32, a
    new tensor). Where `dim` is not the first and `x` holds more than
    ``_STAGE_ELEMS`` elements, blocks of the first dim go one after
    another, so that the f32 staging copy is a block, not the tensor."""
    import torch
    n = size(group)
    if dim and n > 1 and x.shape[0] > 1 and x.numel() > _STAGE_ELEMS:
        shape = list(x.shape)
        shape[dim] //= n
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
        step = max(1, _STAGE_ELEMS // x[0].numel())
        for i in range(0, x.shape[0], step):
            out[i:i + step] = _reduce_scatter_block(x[i:i + step], group,
                                                    dim)
        return out
    return _reduce_scatter_block(x, group, dim)


def _reduce_scatter_block(x, group, dim: int):
    import torch
    import torch.distributed as dist
    n = size(group)
    # one f32 copy, in the order the collective reads
    xf = torch.empty(x.movedim(dim, 0).shape, dtype=torch.float32,
                     device=x.device).copy_(x.movedim(dim, 0))
    if n == 1:
        return xf.movedim(0, dim) if dim else xf
    out = torch.empty((xf.shape[0] // n,) + tuple(xf.shape[1:]),
                      dtype=torch.float32, device=x.device)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, xf, group=group)
    return out.movedim(0, dim) if dim else out


def _all_reduce_raw(x, group, *, inplace: bool = False):
    """f32 sum over the group (f32); with `inplace` an f32 contiguous `x`
    (the caller's own buffer) takes the sum."""
    import torch.distributed as dist
    xf = x.float().contiguous()
    if size(group) > 1:
        if xf is x and not inplace:
            xf = xf.clone()
        dist.all_reduce(xf, group=group)
    return xf


def all_reduce_max(x, group):
    """Elementwise max over the group; carries no gradient."""
    import torch.distributed as dist
    x = x.detach().clone()
    if size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _all_to_all_raw(x, group):
    import torch
    import torch.distributed as dist
    if size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


@functools.cache
def _functions():
    import torch

    class AllGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            return _all_gather_raw(x, group, dim)

        @staticmethod
        def backward(ctx, g):
            return (_reduce_scatter_raw(g, ctx.group, ctx.dim).to(g.dtype),
                    None, None)

    class ReduceScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            return _reduce_scatter_raw(x, group, dim).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            return _all_gather_raw(g, ctx.group, ctx.dim), None, None

    class AllReduce(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return _all_reduce_raw(x, group).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            return _all_reduce_raw(g, ctx.group).to(g.dtype), None

    class CopyTo(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return _all_reduce_raw(g, ctx.group).to(g.dtype), None

    class ReduceFrom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            return _all_reduce_raw(x, group).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class AllToAll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return _all_to_all_raw(x, group)

        @staticmethod
        def backward(ctx, g):
            return _all_to_all_raw(g, ctx.group), None

    class GatherParam(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, gathers, replicated):
            ctx.gathers, ctx.replicated = gathers, replicated
            for group, dim in gathers:
                t = _all_gather_raw(t, group, dim)
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            # f32 from the first reduction on (a new tensor: the
            # all-reduces then sum in place)
            dt = g.dtype
            if not ctx.gathers:
                g = g.to(torch.float32, copy=True)
            for group, dim in reversed(ctx.gathers):
                g = _reduce_scatter_raw(g, group, dim)
            for group in ctx.replicated:
                g = _all_reduce_raw(g, group, inplace=True)
            return g.to(dt), None, None

    return dict(AllGather=AllGather, ReduceScatter=ReduceScatter,
                AllReduce=AllReduce, CopyTo=CopyTo, ReduceFrom=ReduceFrom,
                AllToAll=AllToAll, GatherParam=GatherParam)


def all_gather(x, group, dim: int = 0):
    if size(group) == 1:
        return x
    return _functions()["AllGather"].apply(x, group, dim)


def reduce_scatter(x, group, dim: int = 0):
    if size(group) == 1:
        return x
    return _functions()["ReduceScatter"].apply(x, group, dim)


def all_reduce(x, group):
    if size(group) == 1:
        return x
    return _functions()["AllReduce"].apply(x, group)


def copy_to(x, group):
    if size(group) == 1:
        return x
    return _functions()["CopyTo"].apply(x, group)


def reduce_from(x, group):
    if size(group) == 1:
        return x
    return _functions()["ReduceFrom"].apply(x, group)


def all_to_all(x, group):
    if size(group) == 1:
        return x
    return _functions()["AllToAll"].apply(x, group)


def gather_param(t, gathers=(), replicated=()):
    """`t` (a parameter's local shard) all-gathered over each (group, dim)
    of `gathers` in order, as one differentiable op whose backward sums the
    gradient over those groups (reduce-scatters, last gather first) and
    over each group of `replicated` (all-reduces), in f32, rounded once.
    Groups of one rank are left out."""
    gathers = tuple((g, d) for g, d in gathers if size(g) > 1)
    replicated = tuple(g for g in replicated if size(g) > 1)
    if not gathers and not replicated:
        return t
    return _functions()["GatherParam"].apply(t, gathers, replicated)


def full_tensor(t):
    """The full tensor of ``DTensor`` `t`, all-gathered over each mesh dim
    that shards it, innermost first (several mesh dims shard one tensor
    dim in mesh order, major first). ``DTensor.full_tensor`` issues
    functional collectives, and gloo does not run those on CUDA tensors:
    the process dies in ``wait_tensor``. Shard and Replicate placements of
    even shards only, as the port's partition rules give; uneven shards
    raise on every rank, before any collective."""
    x = t.to_local()
    mesh = t.device_mesh
    split = [1] * x.dim()
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            split[pl.dim % x.dim()] *= mesh.size(i)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} has no full tensor to gather")
    if any(x.shape[d] * n != t.shape[d] for d, n in enumerate(split)):
        raise ValueError(f"uneven shards: local {tuple(x.shape)} of "
                         f"{tuple(t.shape)}, split {split}")
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if pl.is_shard():
            x = _all_gather_raw(x, mesh.get_group(i), pl.dim % x.dim())
    return x
