"""The port's int8 error-feedback gradient codec (``repro_torch.optim.
compress``) on the CPU: ports of ``test_compress_and_parallel.py``'s codec
tests (the error bound, descent under error feedback, the residual carried,
the wire-bytes ratio), each also held against the JAX package's
``GradCompression`` on the same inputs.

Tolerances: the quantize → dequantize round trip and the error buffer
bit for bit against JAX's (the same f32 divisions and round half to even);
the descent 1e-2 (the JAX test's bound), and the JAX run's iterates 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compress import GradCompression as JGradCompression
from repro.optim.compress import _quant_dequant as jquant_dequant
from repro_torch.optim.compress import GradCompression, _quant_dequant


def _x(n, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale) \
        .astype(np.float32)


def test_quant_dequant_error_bound():
    x = torch.from_numpy(_x(1000))
    y = _quant_dequant(x)
    err = (y - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127 + 1e-6


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 9, 5), (256,),
                                   (0,)])
def test_quant_dequant_matches_jax(shape):
    n = int(np.prod(shape))
    x = _x(n, seed=n).reshape(shape)
    x.flat[:3] = 0.0
    got = _quant_dequant(torch.from_numpy(x)).numpy()
    ref = np.asarray(jquant_dequant(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _quadratic():
    A = np.diag(np.linspace(0.5, 3.0, 64)).astype(np.float32)
    b = np.ones(64, np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def test_error_feedback_preserves_descent():
    """SGD on a quadratic with int8+EF grads converges like exact SGD."""
    A, b = _quadratic()

    def grad(w):
        return A @ w - b

    gc = GradCompression()
    st = gc.init({"w": torch.zeros(4096)})          # force EF on
    assert st["error"]["w"] is not None
    st = {"error": {"w": torch.zeros(64)}}
    w_exact = w_comp = torch.zeros(64)
    jgc = JGradCompression()
    jst = {"error": {"w": jnp.zeros((64,))}}
    jw = jnp.zeros((64,))
    for _ in range(300):
        w_exact = w_exact - 0.1 * grad(w_exact)
        gh, st = gc.apply({"w": grad(w_comp)}, st)
        w_comp = w_comp - 0.1 * gh["w"]
        jgh, jst = jgc.apply({"w": jnp.asarray(grad(
            torch.from_numpy(np.array(jw))).numpy())}, jst)
        jw = jw - 0.1 * jgh["w"]
    w_star = torch.linalg.solve(A, b)
    assert float(torch.linalg.norm(w_comp - w_star)) < 1e-2
    assert float(torch.linalg.norm(w_comp - w_exact)) < 1e-2
    np.testing.assert_allclose(w_comp.numpy(), np.asarray(jw), atol=1e-5)


def test_error_feedback_residual_carried():
    gc = GradCompression(min_size=1)
    st = gc.init({"w": torch.zeros(512)})
    g = {"w": torch.full((512,), 1e-3)}
    gh, st = gc.apply(g, st)
    # whatever was rounded away must be in the error buffer
    np.testing.assert_allclose((gh["w"] + st["error"]["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6)
    jgc = JGradCompression(min_size=1)
    jgh, jst = jgc.apply({"w": jnp.full((512,), 1e-3)},
                         jgc.init({"w": jnp.zeros((512,))}))
    np.testing.assert_array_equal(gh["w"].numpy(), np.asarray(jgh["w"]))
    np.testing.assert_array_equal(st["error"]["w"].numpy(),
                                  np.asarray(jst["error"]["w"]))


def test_small_leaves_stay_exact_and_bf16_round_trips():
    """Leaves under min_size carry no error buffer and pass through; a
    bf16 gradient comes back bf16, as JAX's ``astype(g.dtype)``."""
    gc = GradCompression()
    params = {"big": torch.zeros(4096, dtype=torch.bfloat16),
              "small": torch.zeros(8)}
    st = gc.init(params)
    assert st["error"]["small"] is None
    assert st["error"]["big"].dtype == torch.float32
    g = {"big": torch.from_numpy(_x(4096, seed=2)).bfloat16(),
         "small": torch.from_numpy(_x(8, seed=3))}
    gh, st2 = gc.apply(g, st)
    assert gh["small"] is g["small"] and st2["error"]["small"] is None
    assert gh["big"].dtype == torch.bfloat16
    jgc = JGradCompression()
    jg = {"big": jnp.asarray(g["big"].float().numpy(), jnp.bfloat16),
          "small": jnp.asarray(g["small"].numpy())}
    jgh, jst = jgc.apply(jg, jgc.init(jg))
    np.testing.assert_array_equal(gh["big"].float().numpy(),
                                  np.asarray(jgh["big"], np.float32))
    np.testing.assert_array_equal(st2["error"]["big"].numpy(),
                                  np.asarray(jst["error"]["big"]))
    off, same = GradCompression(enabled=False).apply(g, st)
    assert off is g and same is st


def test_wire_bytes_ratio():
    comp, raw = GradCompression.wire_bytes({"w": torch.zeros(1 << 20)})
    assert raw / comp > 3.8  # ~4x minus scale overhead
    assert (comp, raw) == JGradCompression.wire_bytes(
        {"w": jnp.zeros((1 << 20,))})
