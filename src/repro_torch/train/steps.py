"""Train and serve step functions (``src/repro/train/steps.py``)."""
from __future__ import annotations

import contextlib
import math
import os

from ..core.split_state import leaf_paths, tree_unflatten
from ..optim import global_norm, lr_schedule


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
    the one-device step's function with the reference's layout
    (``_layout_step``). ``train_step.grads(state, batch)`` gives (loss,
    metrics, gradients) without an update.
    """
    import torch
    lr_fn = lr_fn or lr_schedule

    def value_and_grad(params, batch, scale):
        leaves = leaf_paths(params)
        live = [p.detach().requires_grad_() for _, p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, live), batch)
            # a leaf the loss never reads (an encoder's token embedding)
            # gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(
                loss if scale is None else loss * scale, live,
                allow_unused=True, materialize_grads=True)
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def loss_and_grads(params, batch, vg=value_and_grad):
        """(loss, metrics, grads) of `batch` over plain parameter tensors
        (`vg`: one microbatch's)."""
        if grad_accum == 1:
            return vg(params, batch, None)
        adt = getattr(torch, accum_dtype) if accum_dtype else torch.float32
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
               for n, p in leaf_paths(params)}
        losses, per = [], []
        for i in range(grad_accum):
            l_, m_, g = vg(params, {k: v[i] for k, v in micro.items()},
                           None)
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
        return _layout_step(model, optimizer, lr_fn, loss_and_grads,
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

    def grads(state, batch):
        """(loss, metrics, gradients) of `batch` at `state`, which stays
        as it is."""
        with deterministic(state["step"].device):
            return loss_and_grads(state["params"], batch)

    train_step.grads = grads
    return train_step


def _loss_weight(cfg, batch):
    """The count the loss of `batch` averages over: the masked frames of
    an encoder batch, the B·(S−1) next-token targets of an LM batch."""
    import torch
    if cfg.family == "encoder":
        return batch["mask"].sum().float()
    b, s = batch["tokens"].shape
    return torch.tensor(float(b * (s - 1)), device=batch["tokens"].device)


def _layout_step(model, optimizer, lr_fn, loss_and_grads, shardings,
                 batch_axes):
    """The train step on a mesh, computing the one-device step's function
    with the reference's activation layout (``models.parallel``):

    1. the parameters go in as each rank's local shards (``to_local``);
       each layer all-gathers its own FSDP-sharded leaves just before it
       runs and keeps its TP dims split. Layers run under the remat
       policy's wrapper (``models.model.remat``): under ``nothing``
       autograd does not keep the gathered weights, and the backward
       gathers each layer's again;
    2. each rank's loss (of its batch rows, equal on every rank of the TP
       axis) is weighted by its share of the global loss's count over the
       batch axes (equal shares of an LM batch; an encoder's masked frames
       may differ by rank) and by 1 / its replicas over the other axes,
       and the shares are summed over every mesh axis (``reduce_from``)
       into the global loss and metrics that each rank reports;
    3. the gradients come out of the collectives' backward as the local
       shards' gradients, summed over the ranks in f32 and rounded once;
    4. the optimizer updates the local shards (``ShardLayout`` supplies
       the reductions across shards: the clip's global norm, Adafactor's
       means and RMS).

    No rank ever holds the whole parameter tree. A MoE layer routes the
    groups the one-device step forms (``models.parallel._moe``)."""
    import torch
    import torch.distributed as dist

    from ..core.split_state import map_leaves
    from ..models import parallel
    from ..models.model import _exec
    from ..sharding import collectives as C
    from ..sharding.partition import ShardLayout, act_constrainer

    p_shard = dict(leaf_paths(shardings["params"]))
    mesh = next(iter(p_shard.values())).mesh
    names = tuple(mesh.mesh_dim_names)
    lay = act_constrainer(model.cfg, mesh)
    lay.batch_axes = batch_axes
    n_batch = math.prod(mesh.size(names.index(a)) for a in batch_axes)
    replicas = mesh.size() // n_batch
    groups = [mesh.get_group(a) for a in names]
    layout = None

    def share_sum(t):
        for g in groups:
            t = C.reduce_from(t, g)
        return t

    def value_and_grad(params, batch, _):
        leaves = leaf_paths(params)
        live = [p.detach().requires_grad_() for _, p in leaves]
        with torch.enable_grad():
            loss, metrics = parallel.loss(
                model, tree_unflatten(params, live), batch, lay, _exec)
            keys = sorted(k for k in metrics if k != "loss")
            vals = torch.stack([loss.float()] + [metrics[k].float()
                                                 for k in keys])
            tot = share_sum(vals * (scale(batch) / replicas))
            grads = torch.autograd.grad(tot[0], live, allow_unused=True,
                                        materialize_grads=True)
        tot = tot.detach()
        metrics = {"loss": tot[0], **dict(zip(keys, tot[1:]))}
        return tot[0], metrics, tree_unflatten(params, list(grads))

    def scale(batch):
        w = _loss_weight(model.cfg, batch)
        total = w.clone()
        for a in batch_axes:
            dist.all_reduce(total, group=mesh.get_group(a))
        return w / total

    def train_step(state, batch):
        nonlocal layout
        params = state["params"]
        step = state["step"].to_local()
        if layout is None:
            layout = ShardLayout.of(shardings["params"], params)
        with deterministic(step.device):
            local = map_leaves(_local, params)
            _, metrics, grads = loss_and_grads(local, batch,
                                               value_and_grad)
            lr = lr_fn(step)
            grad_norm = global_norm(grads, layout)
            optimizer.update(grads, map_leaves(_local, state["opt"]),
                             local, lr, layout)
            step.add_(1)
        metrics["lr"] = lr
        metrics["grad_norm"] = grad_norm
        return state, metrics

    def grads(state, batch):
        """(loss, metrics, the local shards' gradients) of `batch` at
        `state`, which stays as it is."""
        with deterministic(state["step"].to_local().device):
            return loss_and_grads(map_leaves(_local, state["params"]),
                                  batch, value_and_grad)

    train_step.grads = grads
    return train_step


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def make_serve_fns(model, *, mesh=None, batch: int = 0,
                   cache_len: int = 0):
    """Returns (prefill_fn, decode_fn, encode_fn) for greedy serving.

    prefill_fn(params, tokens, cache_len=0) -> (next_token (B,) int32, cache)
    decode_fn(params, cache, token)         -> (next_token (B,) int32, cache)

    With `mesh` they serve one rank of it (``models.parallel``): `params`
    are the rank's local shards, `tokens` and the results its rows of a
    `batch`-row batch (``parallel.batch_rows``), the cache its blocks of a
    `cache_len`-position cache (``partition.cache_specs``); the next
    tokens come from the logits over the whole vocabulary, and
    ``decode_fn`` takes the token's position as `pos` where the cache's
    ``pos`` holds no value (a trace on fake tensors).
    """
    def sample(logits):
        # the first index of the maximum, as jnp.argmax
        return logits.argmax(dim=-1).int()

    if mesh is not None:
        return _mesh_serve_fns(model, mesh, batch, cache_len, sample)

    def prefill_fn(params, tokens, cache_len=0):
        logits, cache = model.prefill(params, tokens, cache_len=cache_len)
        return sample(logits), cache

    def decode_fn(params, cache, token):
        logits, cache = model.decode_step(params, cache, token)
        return sample(logits), cache

    def encode_fn(params, features):
        return model.encode(params, features)

    return prefill_fn, decode_fn, encode_fn


def _mesh_serve_fns(model, mesh, batch, cache_len, sample):
    from ..models import parallel
    from ..models.model import _exec
    lay = parallel.serve_layout(model.cfg, mesh, batch, cache_len)

    def prefill_fn(params, tokens, cache_len=cache_len):
        logits, cache = parallel.prefill(model, params, tokens, lay,
                                         cache_len=cache_len,
                                         exec_mesh=_exec)
        return sample(logits), cache

    def decode_fn(params, cache, token, pos=None):
        logits, cache = parallel.decode_step(model, params, cache, token,
                                             lay, pos=pos, exec_mesh=_exec)
        return sample(logits), cache

    def encode_fn(params, features):
        return parallel.encode(model, params, features, lay,
                               exec_mesh=_exec)

    return prefill_fn, decode_fn, encode_fn
