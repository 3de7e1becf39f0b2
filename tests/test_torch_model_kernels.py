"""The plain versions of the port's model kernels against the JAX package's
Pallas kernels run in interpret mode: ``rmsnorm_plain`` against
``rmsnorm_fused`` (K7) and ``flash_attention_plain`` against
``flash_attention`` (K8), on the shapes, dtypes and tolerances of
``tests/test_kernels.py`` with inputs from a numpy seed. On this CPU machine
the wrappers take these plain versions (their tensors lie on the CPU); the
CUDA kernels are held to them on the card (``test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_reference as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm_fused as jrms
from repro_torch.convert import from_jax_state
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}      # test_kernels.py:66
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}     # test_kernels.py:34


def _normal(rng, shape, dtype):
    return rng.standard_normal(shape).astype(np.float32).astype(DTYPES[dtype])


def _port(a):
    return from_jax_state({"a": a}, device="cpu")["a"]


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


@pytest.mark.parametrize("shape", [(16, 64), (37, 96), (3, 5, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, shape, dtype)
    s = (rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32) \
        .astype(DTYPES[dtype])
    ref = jrms(jnp.asarray(x), jnp.asarray(s), block_rows=8, interpret=True)
    got = rn.rmsnorm_plain(_port(x), _port(s))
    assert got.dtype == _port(x).dtype and got.shape == shape
    _close(got, ref, RMS_TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (1, 64, 64, 4, 4, 32),
    (2, 128, 128, 4, 1, 16),    # MQA
    (1, 96, 96, 8, 2, 64),      # GQA 4:1
    (1, 60, 60, 2, 2, 16),      # non-multiple-of-block seq
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, K, D, dtype):
    rng = np.random.default_rng(Sq * H + D)
    q = _normal(rng, (B, Sq, H, D), dtype)
    k = _normal(rng, (B, Sk, K, D), dtype)
    v = _normal(rng, (B, Sk, K, D), dtype)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 block_q=32, block_k=32, interpret=True)
    got = fa.flash_attention_plain(_port(q), _port(k), _port(v), causal=True)
    assert got.dtype == _port(q).dtype and got.shape == (B, Sq, H, D)
    _close(got, ref, ATTN_TOL[dtype])


@pytest.mark.parametrize("window,softcap,causal", [
    (16, 0.0, True), (0, 30.0, True), (24, 0.0, False), (0, 0.0, False),
])
def test_flash_attention_plain_masks_match_pallas(window, softcap, causal):
    B, S, H, K, D = 1, 80, 4, 2, 32
    rng = np.random.default_rng(window + int(softcap) + causal)
    q, k, v = (_normal(rng, (B, S, n, D), "float32") for n in (H, K, K))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 block_q=16, block_k=16, interpret=True, **kw)
    got = fa.flash_attention_plain(_port(q), _port(k), _port(v), **kw)
    _close(got, ref, 2e-5)
    # the naive oracle, on (B, H, S, D), agrees with the JAX one
    t = (0, 2, 1, 3)
    oref = jref(*(jnp.asarray(a.transpose(t)) for a in (q, k, v)), **kw)
    ogot = fa.attention_reference(*(_port(a.transpose(t)) for a in (q, k, v)),
                                  **kw)
    _close(ogot, oref, 2e-5)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_plain_head_dim_80_matches_pallas(window, dtype):
    """hubert-xlarge's head dim 80, non-causal (with and without a
    two-sided window), scale 1/sqrt(80): the plain version against the
    Pallas kernel, whose block takes the full D, and the naive oracles
    against each other."""
    B, S, H, D = 2, 80, 4, 80
    rng = np.random.default_rng(D + window)
    q, k, v = (_normal(rng, (B, S, H, D), dtype) for _ in range(3))
    kw = dict(causal=False, window=window)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 block_q=16, block_k=16, interpret=True, **kw)
    got = fa.flash_attention_plain(_port(q), _port(k), _port(v), **kw)
    assert got.dtype == _port(q).dtype and got.shape == (B, S, H, D)
    _close(got, ref, ATTN_TOL[dtype])
    t = (0, 2, 1, 3)
    oref = jref(*(jnp.asarray(a.transpose(t)) for a in (q, k, v)), **kw)
    ogot = fa.attention_reference(*(_port(a.transpose(t)) for a in (q, k, v)),
                                  **kw)
    _close(ogot, oref, ATTN_TOL[dtype])


def test_wrappers_take_plain_versions_on_cpu_and_do_not_count():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    s = torch.zeros(32)
    q = torch.from_numpy(rng.standard_normal((1, 9, 2, 16))
                         .astype(np.float32))
    kv = q[:, :, :1].contiguous()
    before = (rn.launches, fa.launches)
    assert torch.equal(rn.rmsnorm_fused(x, s), rn.rmsnorm_plain(x, s))
    assert torch.equal(fa.flash_attention(q, kv, kv, window=4),
                       fa.flash_attention_plain(q, kv, kv, window=4))
    assert (rn.launches, fa.launches) == before


@pytest.mark.parametrize("S,causal,window", [(7, True, 0), (7, True, 3),
                                             (9, False, 2), (5, False, 0)])
def test_unmasked_pairs_counts_the_mask(S, causal, window):
    mask = fa._mask(S, S, causal, window, "cpu")
    assert fa.unmasked_pairs(S, S, causal, window) == int(mask.sum())
