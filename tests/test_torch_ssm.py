"""The port's SSM (Mamba-2 SSD) and RG-LRU blocks and the two convolutions
(``models/ssm.py``, ``models/rglru.py``, ``models/layers.py``) against the
JAX package's on the CPU, at the reduced mamba2-780m (d 64, 8 heads of 16,
state 16, chunk 32) and recurrentgemma-9b (lru_width 64), f32: weights
from the JAX inits carried across by ``convert.params_from_jax``, inputs
from a numpy seed.

Tolerances: f32 values within 1e-5 of the reference's largest magnitude
(the sums run in another order; measured ~4e-7 of it); the reference
tests' own equivalences (chunked = recurrent, segmented prefill, the
scan = the recurrence) at ``tests/test_ssm_rglru.py``'s bounds.

The chunk-256 gradient: the reference's ``jax.grad`` of ``ssd_forward`` is
NaN at mamba2's real chunk size (``src/repro/models/ssm.py:104-107`` takes
``exp`` of the masked upper triangle, which overflows, and its backward
multiplies 0 by inf); the port masks before the ``exp``. SSD is exact
under a change of chunk size, so the port's gradient at chunk 256 is held
to ``jax.grad`` at chunk 32 on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels.flash_attention import \
    attention_reference as jattention_reference
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_state, params_from_jax
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import layers, rglru, ssm
from repro_torch.state import INITS

KEY = jax.random.PRNGKey(7)
JSSM, TSSM = jreduced(jget_config("mamba2-780m")), \
    reduced(get_config("mamba2-780m"))
JRG, TRG = jreduced(jget_config("recurrentgemma-9b")), \
    reduced(get_config("recurrentgemma-9b"))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _x(seed, B, S, d, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            * scale).astype(np.float32)


def _close(got, ref, what="", rel=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max() + 1e-12,
                               err_msg=what)


def _state(jtree):
    return {k: _t(v) for k, v in jtree.items()}


@pytest.fixture(scope="module")
def ssm_params():
    p = jssm.init_ssm(KEY, JSSM)
    return p, _port(p)


@pytest.fixture(scope="module")
def rg_params():
    p = jrglru.init_rglru(KEY, JRG)
    return p, _port(p)


# ---------------------------------------------------------------------------
# against the reference functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_ssd_forward_matches_jax(ssm_params, carried):
    jp, tp = ssm_params
    x = _x(0, 2, 64, JSSM.d_model)
    st = None
    if carried:     # the state of an earlier segment, through both
        _, st = jssm.ssd_forward(jp, jnp.asarray(_x(1, 2, 32, JSSM.d_model)),
                                 JSSM, return_state=True)
    jy, jst = jssm.ssd_forward(jp, jnp.asarray(x), JSSM, state=st,
                               return_state=True)
    ty, tst = ssm.ssd_forward(tp, torch.from_numpy(x), TSSM,
                              state=None if st is None else _state(st),
                              return_state=True)
    _close(ty, jy, "y")
    for k in ("conv", "h"):
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k], k)


def test_ssd_decode_step_matches_jax(ssm_params):
    jp, tp = ssm_params
    x = _x(2, 3, 5, JSSM.d_model)
    jst = jssm.init_ssm_state(JSSM, 3)
    tst = ssm.init_ssm_state(TSSM, 3)
    assert {k: tuple(v.shape) for k, v in tst.items()} == \
        {k: v.shape for k, v in jst.items()}
    for t in range(5):
        jy, jst = jssm.ssd_decode_step(jp, jnp.asarray(x[:, t:t + 1]), JSSM,
                                       jst)
        ty, tst = ssm.ssd_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                      TSSM, tst)
        _close(ty, jy, f"y {t}")
        _close(tst["h"], jst["h"], f"h {t}")


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_forward_matches_jax(rg_params, carried):
    jp, tp = rg_params
    x = _x(3, 2, 48, JRG.d_model)
    st = None
    if carried:
        _, st = jrglru.rglru_forward(jp, jnp.asarray(_x(4, 2, 9, JRG.d_model)),
                                     JRG, return_state=True)
    jy, jst = jrglru.rglru_forward(jp, jnp.asarray(x), JRG, state=st,
                                   return_state=True)
    ty, tst = rglru.rglru_forward(tp, torch.from_numpy(x), TRG,
                                  state=None if st is None else _state(st),
                                  return_state=True)
    _close(ty, jy, "y")
    for k in ("conv", "h"):
        _close(tst[k], jst[k], k)


def test_rglru_decode_step_matches_jax(rg_params):
    jp, tp = rg_params
    x = _x(5, 3, 6, JRG.d_model)
    jst, tst = jrglru.init_rglru_state(JRG, 3), rglru.init_rglru_state(TRG, 3)
    for t in range(6):
        jy, jst = jrglru.rglru_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                           JRG, jst)
        ty, tst = rglru.rglru_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                          TRG, tst)
        _close(ty, jy, f"y {t}")
        _close(tst["h"], jst["h"], f"h {t}")


def test_rglru_gates_match_jax(rg_params):
    jp, tp = rg_params
    u = _x(6, 4, 16, JRG.rglru.lru_width)
    ja, jb = jrglru._gates(jp, jnp.asarray(u))
    ta, tb = rglru._gates(tp, torch.from_numpy(u))
    _close(ta, ja, "a")
    _close(tb, jb, "b")


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_jax(carried):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if carried else None
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    state=None if st is None
                                    else jnp.asarray(st))
    ty, tst = layers.causal_conv1d(_t(x), _t(w), _t(b),
                                   state=None if st is None else _t(st))
    _close(ty, jy, "y")
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("S", [1, 37, 200])
def test_conv_pos_embed_and_its_gradient_match_jax(S):
    """Width 128, same-padded 64 left and 63 right, a cross-correlation in
    f32, tanh-GELU, added to x; the gradients w.r.t. x and w."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = (rng.standard_normal((128, 16)) * 0.2).astype(np.float32)
    g = rng.standard_normal((2, S, 16)).astype(np.float32)

    def jf(x, w):
        return jnp.sum(jlayers.conv_pos_embed({"w": w}, x) * g)

    jy = jlayers.conv_pos_embed({"w": jnp.asarray(w)}, jnp.asarray(x))
    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = layers.conv_pos_embed({"w": tw}, tx)
    _close(ty, jy, "y")
    (ty * _t(g)).sum().backward()
    _close(tx.grad, jgx, "dx")
    _close(tw.grad, jgw, "dw")


# ---------------------------------------------------------------------------
# the reference's own equivalences, on the port
# ---------------------------------------------------------------------------

def test_ssd_chunked_equals_recurrent(ssm_params):
    _, tp = ssm_params
    x = torch.from_numpy(_x(9, 2, 64, TSSM.d_model))
    y_seq, final = ssm.ssd_forward(tp, x, TSSM, return_state=True)
    st = ssm.init_ssm_state(TSSM, 2)
    outs = []
    for t in range(64):
        y, st = ssm.ssd_decode_step(tp, x[:, t:t + 1], TSSM, st)
        outs.append(y)
    assert (y_seq - torch.cat(outs, 1)).abs().max() < 1e-3
    assert (final["h"] - st["h"]).abs().max() < 1e-3


def test_ssd_state_carry_across_segments(ssm_params):
    _, tp = ssm_params
    x = torch.from_numpy(_x(10, 1, 64, TSSM.d_model))
    y_full, st_full = ssm.ssd_forward(tp, x, TSSM, return_state=True)
    y1, st1 = ssm.ssd_forward(tp, x[:, :32], TSSM, return_state=True)
    y2, st2 = ssm.ssd_forward(tp, x[:, 32:], TSSM, state=st1,
                              return_state=True)
    assert (torch.cat([y1, y2], 1) - y_full).abs().max() < 1e-3
    assert (st2["h"] - st_full["h"]).abs().max() < 1e-3


def test_ssd_refuses_a_ragged_last_chunk(ssm_params):
    _, tp = ssm_params
    with pytest.raises(AssertionError):
        ssm.ssd_forward(tp, torch.zeros((1, 40, TSSM.d_model)), TSSM)


def test_rglru_scan_equals_recurrent(rg_params):
    _, tp = rg_params
    x = torch.from_numpy(_x(11, 2, 48, TRG.d_model))
    y_seq, final = rglru.rglru_forward(tp, x, TRG, return_state=True)
    st = rglru.init_rglru_state(TRG, 2)
    outs = []
    for t in range(48):
        y, st = rglru.rglru_decode_step(tp, x[:, t:t + 1], TRG, st)
        outs.append(y)
    assert (y_seq - torch.cat(outs, 1)).abs().max() < 1e-4
    assert (final["h"] - st["h"]).abs().max() < 1e-4


def test_rglru_decay_bounded(rg_params):
    _, tp = rg_params
    u = torch.from_numpy(_x(12, 4, 16, TRG.rglru.lru_width, scale=1.0))
    a, _ = rglru._gates(tp, u)
    assert bool((a > 0).all()) and bool((a < 1).all())


@pytest.mark.parametrize("S", [1, 2, 5, 48, 129])
def test_log_depth_scan_is_the_recurrence(S):
    """``_scan`` against the sequential recurrence in f64, at lengths on
    and off the powers of two."""
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, S, 7)))
    b = torch.from_numpy(rng.standard_normal((3, S, 7)))
    h = torch.zeros((3, 7), dtype=torch.float64)
    ref = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    got = rglru._scan(a, b)
    torch.testing.assert_close(got, torch.stack(ref, 1), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the chunk-256 gradient
# ---------------------------------------------------------------------------

def _chunked(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk_size=chunk))


def test_ssd_gradient_at_chunk_256_is_finite_where_the_reference_is_nan():
    jc256, jc32 = _chunked(JSSM, 256), _chunked(JSSM, 32)
    tc256 = _chunked(TSSM, 256)
    jp = jssm.init_ssm(KEY, jc256)
    x = np.random.default_rng(13).standard_normal(
        (2, 256, JSSM.d_model)).astype(np.float32)
    g = np.random.default_rng(14).standard_normal(
        (2, 256, JSSM.d_model)).astype(np.float32)

    def jloss(p, cfg):
        return jnp.sum(jssm.ssd_forward(p, jnp.asarray(x), cfg) * g)

    ref256 = jax.grad(jloss)(jp, jc256)
    nan = {k for k, v in ref256.items() if np.isnan(np.asarray(v)).any()}
    # the reference's fault, documented: if this changes, so does ROADMAP §3
    assert {"in_proj", "A_log", "dt_bias"} <= nan
    ref32 = jax.grad(jloss)(jp, jc32)
    assert not any(np.isnan(np.asarray(v)).any() for v in ref32.values())
    tp = {k: v.requires_grad_() for k, v in _port(jp).items()}
    ty = ssm.ssd_forward(tp, torch.from_numpy(x), tc256)
    (ty * torch.from_numpy(g)).sum().backward()
    for k, v in tp.items():
        assert torch.isfinite(v.grad).all(), k
        _close(v.grad, ref32[k], k, rel=1e-4)


# ---------------------------------------------------------------------------
# inits and K8 at hubert's head dim
# ---------------------------------------------------------------------------

def test_ssm_and_rglru_inits_follow_the_reference_formulas():
    g = torch.Generator().manual_seed(0)
    a_log = INITS["a_log"]((2, 48), g, "cpu")
    ref = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, 48)))
    np.testing.assert_allclose(a_log[1].numpy(), ref, rtol=2.5e-7, atol=0)
    assert torch.equal(a_log[0], a_log[1])
    dt = torch.nn.functional.softplus(
        INITS["dt_bias"]((4096,), g, "cpu").double())
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) < 2e-3
    assert 0.08 < float(dt.max()) <= 1e-1 * (1 + 1e-5)
    lam = INITS["lam"]((4096,), g, "cpu").double()
    a0 = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert 0.9 - 1e-6 <= float(a0.min()) < 0.91
    assert 0.99 < float(a0.max()) <= 0.999 + 1e-6


def test_k8_takes_every_head_dim_of_the_pallas_domain():
    assert fa.HEAD_DIMS == tuple(range(16, 257, 16))
    assert [fa.kernel_dim(d) for d in (16, 32, 48, 64, 80, 128, 144, 256)] \
        == [16, 32, 64, 64, 128, 128, 256, 256]
    for d in (8, 72, 272):
        with pytest.raises(ValueError):
            fa.kernel_dim(d)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_plain_at_head_dim_80_noncausal(dtype, tol, window):
    """K8's plain version (what the wrapper runs on the CPU) at hubert's
    head dim 80, non-causal (with and without a two-sided window), against
    the JAX package's ``attention_reference`` on the same inputs (the
    ``tests/test_kernels.py`` tolerances); the scale is 1/√80 in both."""
    rng = np.random.default_rng(80 + window)
    B, S, H, D = 2, 130, 4, 80
    np_dt = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               .astype(np_dt) for _ in range(3))
    got = fa.flash_attention(*(from_jax_state({"a": a}, device="cpu")["a"]
                               for a in (q, k, v)),
                             causal=False, window=window)
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    ref = jattention_reference(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        causal=False, window=window)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(ref, np.float32).transpose(0, 2, 1, 3), rtol=0, atol=tol)
