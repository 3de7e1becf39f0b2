"""The port's attention against the reference's oracle: the port of
``tests/test_attention.py``, its cases and tolerances, on the same inputs
(seeded numpy) through ``repro_torch.models.layers.attention_full``/
``attention_local``/``attention_decode`` and JAX's
``repro.models.layers.attention_reference``.

The reference suite checks its chunked XLA paths; the port's functions are
K8 (its plain version on the CPU) and take no ``chunk``: each case keeps
its ``chunk`` among its parameters, and nothing reads it. The gradients
are the port's autograd function: K8's forward,
``kernels/flash_attention/ops.py::attention_backward`` as its backward.
The port's decode takes ``lo``/``groups`` where the reference's takes
``window``/``pos``; the suite's decode case uses neither. The card's
case (K8's forward and ``attention_backward`` against the plain
version's autograd) is in ``test_torch_suites_cuda.py``, which imports
no JAX. ~30 s alone at ``-n 6 --dist loadfile`` (most of it importing
JAX and its eager reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention_reference
from repro_torch.models.layers import (attention_decode, attention_full,
                                       attention_local)


def _qkv(B, Sq, Sk, H, K, D, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, K, D), dtype=np.float32),
            rng.standard_normal((B, Sk, K, D), dtype=np.float32))


def _t(*xs, dtype=torch.float32, device="cpu", grad=False):
    return [torch.from_numpy(x).to(device=device, dtype=dtype)
            .requires_grad_(grad) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _f32(t):
    return np.asarray(t.detach().float().cpu().numpy())


@pytest.mark.parametrize("B,S,H,K,D,chunk,causal,cap", [
    (2, 64, 4, 4, 16, 16, True, 0.0),
    (1, 96, 4, 2, 32, 32, True, 0.0),     # GQA, non-divisible pad
    (2, 64, 8, 1, 16, 64, True, 50.0),    # MQA + softcap
    (1, 50, 2, 2, 16, 16, False, 0.0),    # non-causal, padding
])
def test_full_matches_reference(B, S, H, K, D, chunk, causal, cap):
    x = _qkv(B, S, S, H, K, D)
    out = attention_full(*_t(*x), causal=causal, softcap=cap)
    ref = attention_reference(*_j(*x), causal=causal, softcap=cap)
    assert np.max(np.abs(_f32(out) - np.asarray(ref))) < 2e-5


@pytest.mark.parametrize("B,S,H,K,D,W,chunk", [
    (2, 64, 4, 2, 16, 16, 16),
    (1, 80, 4, 1, 16, 24, 32),   # window not multiple of chunk
    (2, 48, 2, 2, 16, 48, 16),   # window == S
])
def test_local_matches_reference(B, S, H, K, D, W, chunk):
    x = _qkv(B, S, S, H, K, D)
    out = attention_local(*_t(*x), window=W)
    ref = attention_reference(*_j(*x), causal=True, window=W)
    assert np.max(np.abs(_f32(out) - np.asarray(ref))) < 2e-5


def _port_grads(x):
    q, k, v = _t(*x, grad=True)
    attention_full(q, k, v, causal=True).sum().backward()
    return [_f32(t.grad) for t in (q, k, v)]


def test_gradients_match_reference():
    x = _qkv(1, 32, 32, 4, 2, 16)

    def f_ref(q, k, v):
        return attention_reference(q, k, v, causal=True).sum()

    g1 = _port_grads(x)
    g2 = jax.grad(f_ref, argnums=(0, 1, 2))(*_j(*x))
    for a, b in zip(g1, g2):
        assert np.max(np.abs(a - np.asarray(b))) < 5e-5


def test_decode_matches_reference_tail():
    """Decoding the last position over a cache equals full attention's last
    row."""
    B, S, H, K, D = 2, 33, 4, 2, 16
    x = _qkv(B, S, S, H, K, D)
    ref = attention_reference(*_j(*x), causal=True)
    q, k, v = _t(*x)
    out = attention_decode(q[:, -1:], k, v, kv_len=S)
    assert np.max(np.abs(_f32(out) - np.asarray(ref[:, -1:]))) < 2e-5


def test_bf16_path_close():
    x = _qkv(2, 64, 64, 4, 2, 32)
    out = attention_full(*_t(*x, dtype=torch.bfloat16), causal=True)
    ref = attention_reference(*_j(*x, dtype=jnp.bfloat16), causal=True)
    assert out.dtype == torch.bfloat16
    assert np.max(np.abs(_f32(out) - np.asarray(ref.astype(jnp.float32)))) \
        < 3e-2
