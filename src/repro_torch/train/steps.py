"""Train and serve step functions (``src/repro/train/steps.py``)."""
from __future__ import annotations

import contextlib
import logging
import math
import os

from ..core.split_state import leaf_paths, tree_unflatten
from ..optim import global_norm, lr_schedule

log = logging.getLogger("repro_torch.train")


CUBLAS_WORKSPACE = ":4096:8"     # the CUBLAS_WORKSPACE_CONFIG training needs


@contextlib.contextmanager
def deterministic(device):
    """Run the block with ``torch.use_deterministic_algorithms(True)`` on a
    CUDA device (restoring the caller's setting after), so that two runs of
    a step on the same inputs give the same bits — what the JAX step gets
    from XLA — and an operator without a deterministic kernel raises
    instead of drifting. cuBLAS is deterministic only under
    ``CUBLAS_WORKSPACE_CONFIG``, read when the process first uses cuBLAS:
    the process sets it before that (``launch/train.py`` does, to
    ``CUBLAS_WORKSPACE``), and the block raises where it is unset.
    Uninitialised memory is not filled in the block: every kernel writes
    all of its output."""
    import torch
    import torch.utils.deterministic as tud
    if device.type != "cuda":
        yield
        return
    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError(
            "a deterministic train step on CUDA needs CUBLAS_WORKSPACE_CONFIG"
            f" (e.g. {CUBLAS_WORKSPACE!r}) set before the process first "
            "uses cuBLAS")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        tud.fill_uninitialized_memory = prev[2]


def make_train_step(model, optimizer, *, lr_fn=None, grad_accum: int = 1,
                    accum_dtype=None, shardings=None, batch_axes=()):
    """Returns train_step(state, batch) -> (state, metrics).

    grad_accum > 1 splits the batch's leading dim into microbatches and
    sums their gradients in `accum_dtype` (f32 by default; "bfloat16"
    halves the accumulator), then divides by grad_accum, as the JAX step's
    ``lax.scan`` does. The state is updated in place (the JAX step donates
    it); every tensor, the metrics included, stays on the state's device.

    With `shardings` (``core.split_state.state_shardings``) the state is a
    tree of ``DTensor``s on that mesh and `batch` is this rank's rows, the
    batch dim sharded over the mesh axes `batch_axes`; the step computes
    the one-device step's function (``_sharded_step``).
    """
    import torch
    lr_fn = lr_fn or lr_schedule

    def value_and_grad(params, batch, scale):
        leaves = leaf_paths(params)
        live = [p.detach().requires_grad_() for _, p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, live), batch)
            # a leaf the loss never reads (an encoder's token embedding)
            # gets zeros, as from jax.grad
            grads = torch.autograd.grad(
                loss if scale is None else loss * scale, live,
                allow_unused=True, materialize_grads=True)
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def loss_and_grads(params, batch, scale=None):
        """(loss, metrics, grads) of `batch` (of `scale` · loss, where
        given) over plain parameter tensors."""
        if grad_accum == 1:
            return value_and_grad(params, batch, scale)
        adt = getattr(torch, accum_dtype) if accum_dtype else torch.float32
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
               for n, p in leaf_paths(params)}
        losses, per = [], []
        for i in range(grad_accum):
            l_, m_, g = value_and_grad(
                params, {k: v[i] for k, v in micro.items()}, scale)
            for n, gg in leaf_paths(g):
                acc[n].add_(gg.to(adt))
            losses.append(l_)
            per.append(m_)
            del g
        grads = tree_unflatten(params, [acc[n] / grad_accum
                                        for n, _ in leaf_paths(params)])
        metrics = {k: torch.stack([m_[k] for m_ in per]).mean()
                   for k in per[0]}
        return torch.stack(losses).mean(), metrics, grads

    if shardings is not None:
        return _sharded_step(model, optimizer, lr_fn, loss_and_grads,
                             shardings, tuple(batch_axes))

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        with deterministic(dev):
            loss, metrics, grads = loss_and_grads(params, batch)
            lr = lr_fn(state["step"])
            grad_norm = global_norm(grads)
            optimizer.update(grads, state["opt"], params, lr)
            state["step"].add_(1)
        metrics = dict(metrics)
        metrics["lr"] = lr
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def _loss_weight(cfg, batch):
    """The count the loss of `batch` averages over: the masked frames of
    an encoder batch, the B·(S−1) next-token targets of an LM batch."""
    import torch
    if cfg.family == "encoder":
        return batch["mask"].sum().float()
    b, s = batch["tokens"].shape
    return torch.tensor(float(b * (s - 1)), device=batch["tokens"].device)


_GATHER_ROWS = None
_EP_LOGGED = False


def _gather_rows(x, group):
    """All-gather `x` along dim 0 over `group`, differentiable: the
    backward sums every rank's gradient of the gathered rows and keeps
    this rank's (an all-reduce, which gloo and NCCL both have)."""
    global _GATHER_ROWS
    if _GATHER_ROWS is None:
        import torch
        import torch.distributed as dist

        class GatherRows(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, group):
                parts = [torch.empty_like(x)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x.contiguous(), group=group)
                ctx.group, ctx.rows = group, x.shape[0]
                ctx.rank = dist.get_rank(group)
                return torch.cat(parts)

            @staticmethod
            def backward(ctx, g):
                g = g.contiguous().clone()
                dist.all_reduce(g, group=ctx.group)
                lo = ctx.rank * ctx.rows
                return g[lo:lo + ctx.rows], None

        _GATHER_ROWS = GatherRows
    return _GATHER_ROWS.apply(x, group)


def _sharded_step(model, optimizer, lr_fn, loss_and_grads, shardings,
                  batch_axes):
    """The train step on a mesh, computing the one-device step's function:

    1. each rank gathers the parameters to full tensors
       (``DTensor.full_tensor``);
    2. runs the one-device ``Model`` on its own batch rows, its loss
       scaled by its share of the global loss's count (equal shares of an
       LM batch; an encoder's masked frames may differ by rank);
    3. the gradients are summed over the batch axes and brought to each
       leaf's placements (``redistribute``: a reduce-scatter where the
       leaf is sharded);
    4. the optimizer updates the local shards (``ShardLayout`` supplies
       the reductions across shards: the clip's global norm, Adafactor's
       means and RMS).

    A MoE layer groups ``min(4096, T)`` tokens of the GLOBAL batch (its
    capacity depends on the group's size): where this rank's rows do not
    make whole groups, the layer gathers the batch's tokens over the batch
    axes (``models.moe.token_gather``), routes the groups the one-device
    step forms, and keeps its own rows; the gradient flows back through
    the gather."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..models.moe import token_gather
    from ..sharding.partition import ShardLayout
    from ..core.split_state import map_leaves

    global _EP_LOGGED
    p_shard = dict(leaf_paths(shardings["params"]))
    mesh = next(iter(p_shard.values())).mesh
    names = tuple(mesh.mesh_dim_names)
    layout = None
    partial = tuple(Partial() if a in batch_axes else Replicate()
                    for a in names)
    groups = [mesh.get_group(a) for a in batch_axes]
    cfg = model.cfg
    if cfg.moe is not None and cfg.moe_impl == "shard_map" and \
            not _EP_LOGGED:
        _EP_LOGGED = True
        log.info("moe_impl=shard_map: expert-parallel compute is not "
                 "ported yet; the step runs moe_apply (the same function)")

    def psum_batch(t):
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    def gather(x):
        # minor axis first, so the rows come out in mixed-radix order
        full = x
        for g in reversed(groups):
            full = _gather_rows(full, g)
        lo = x.shape[0] * _batch_index(mesh, batch_axes)
        return full, (lambda y: y[lo:lo + x.shape[0]])

    def train_step(state, batch):
        nonlocal layout
        params = state["params"]
        step = state["step"].to_local()
        dev = step.device
        if layout is None:
            layout = ShardLayout.of(shardings["params"], params)
        with deterministic(dev):
            full = map_leaves(lambda d: d.full_tensor(), params)
            w = _loss_weight(cfg, batch)
            scale = w / psum_batch(w.clone())
            b = next(iter(batch.values())).shape
            n_batch = math.prod(mesh.size(names.index(a))
                                for a in batch_axes)
            t_local = b[0] * b[1]
            ctx = contextlib.nullcontext()
            if cfg.moe is not None and groups and \
                    t_local % min(4096, t_local * n_batch):
                ctx = token_gather(gather)
            with ctx:
                _, metrics, grads = loss_and_grads(full, batch, scale)
            del full
            # summed in f32, rounded once to the leaf's dtype
            grads = {n: DTensor.from_local(g.float(), mesh, partial,
                                           run_check=False)
                     .redistribute(mesh, p_shard[n].placements).to_local()
                     .to(g.dtype) for n, g in leaf_paths(grads)}
            grads = tree_unflatten(params, [grads[n] for n, _ in
                                            leaf_paths(params)])
            keys = sorted(metrics)
            vals = psum_batch(torch.stack([metrics[k].float() for k in keys])
                              * scale)
            metrics = dict(zip(keys, vals))
            lr = lr_fn(step)
            grad_norm = global_norm(grads, layout)
            optimizer.update(grads, map_leaves(_local, state["opt"]),
                             map_leaves(_local, params), lr, layout)
            step.add_(1)
        metrics["lr"] = lr
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _batch_index(mesh, axes) -> int:
    """This rank's mixed-radix position over mesh `axes` (major first)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    i = 0
    for a in axes:
        d = names.index(a)
        i = i * mesh.size(d) + coord[d]
    return i


def make_serve_fns(model):
    """Returns (prefill_fn, decode_fn, encode_fn) for greedy serving.

    prefill_fn(params, tokens, cache_len=0) -> (next_token (B,) int32, cache)
    decode_fn(params, cache, token)         -> (next_token (B,) int32, cache)
    """
    def sample(logits):
        # the first index of the maximum, as jnp.argmax
        return logits.argmax(dim=-1).int()

    def prefill_fn(params, tokens, cache_len=0):
        logits, cache = model.prefill(params, tokens, cache_len=cache_len)
        return sample(logits), cache

    def decode_fn(params, cache, token):
        logits, cache = model.decode_step(params, cache, token)
        return sample(logits), cache

    def encode_fn(params, features):
        return model.encode(params, features)

    return prefill_fn, decode_fn, encode_fn
