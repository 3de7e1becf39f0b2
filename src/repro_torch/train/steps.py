"""Serve step functions (``src/repro/train/steps.py::make_serve_fns``)."""
from __future__ import annotations


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
