"""Train and serve step functions (``src/repro/train/steps.py``)."""
from __future__ import annotations

import contextlib
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
                    accum_dtype=None):
    """Returns train_step(state, batch) -> (state, metrics).

    grad_accum > 1 splits the batch's leading dim into microbatches and
    sums their gradients in `accum_dtype` (f32 by default; "bfloat16"
    halves the accumulator), then divides by grad_accum, as the JAX step's
    ``lax.scan`` does. The state is updated in place (the JAX step donates
    it); every tensor, the metrics included, stays on the state's device.
    """
    import torch
    lr_fn = lr_fn or lr_schedule

    def value_and_grad(params, batch):
        leaves = leaf_paths(params)
        live = [p.detach().requires_grad_() for _, p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, live), batch)
            # a leaf the loss never reads (an encoder's token embedding)
            # gets zeros, as from jax.grad
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        with deterministic(dev):
            if grad_accum == 1:
                loss, metrics, grads = value_and_grad(params, batch)
            else:
                adt = getattr(torch, accum_dtype) if accum_dtype \
                    else torch.float32
                micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                      + tuple(v.shape[1:]))
                         for k, v in batch.items()}
                acc = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
                       for n, p in leaf_paths(params)}
                losses, per = [], []
                for i in range(grad_accum):
                    l_, m_, g = value_and_grad(
                        params, {k: v[i] for k, v in micro.items()})
                    for n, gg in leaf_paths(g):
                        acc[n].add_(gg.to(adt))
                    losses.append(l_)
                    per.append(m_)
                    del g
                grads = tree_unflatten(params, [acc[n] / grad_accum
                                                for n, _ in
                                                leaf_paths(params)])
                metrics = {k: torch.stack([m_[k] for m_ in per]).mean()
                           for k in per[0]}
                loss = torch.stack(losses).mean()
            lr = lr_fn(state["step"])
            grad_norm = global_norm(grads)
            optimizer.update(grads, state["opt"], params, lr)
            state["step"].add_(1)
        metrics = dict(metrics)
        metrics["lr"] = lr
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


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
