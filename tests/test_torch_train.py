"""The training slice of the port on the CPU, held against the JAX package
at the reduced gemma3-1b (f32, vocab 128, window 16): the data pipeline
(batch for batch), the optimizer, ``Model.loss`` and its gradients, one
``make_train_step`` and the train state's tree (the Trainer itself is
``test_torch_trainer.py``). Weights cross from JAX through ``convert``;
the kernel wrappers take their plain versions (the tensors lie on the
CPU), and the backward passes of K7/K8 are the port's own PyTorch ops.

Tolerances: f32 loss 1e-5 relative and gradients 1e-4 of each leaf's
largest entry (sums in another order; JAX's XLA attention runs an online
softmax over chunks). bf16 loss 1e-3 relative and gradients 1e-1 relative
L2 per leaf, and per leaf no further from JAX's f32 gradients than twice
JAX's own bf16 gradients are (+1e-2): the port's attention scales q in f32
(the Pallas kernel's math) where JAX's XLA path rounds the scaled q to
bf16, and the two frameworks round bf16 intermediates at different
places. One train step: metrics 2e-5 relative, parameters a tenth of the
step's learning rate."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.split_state import init_train_state as jinit_state
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import lr_schedule as jlr
from repro.train.steps import make_train_step as jmake_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_state, params_from_jax
from repro_torch.core.split_state import (abstract_train_state,
                                          init_train_state, leaf_paths,
                                          tree_unflatten)
from repro_torch.data.pipeline import DataState, SyntheticPipeline
from repro_torch.models import Model
from repro_torch.optim import Adafactor, AdamW, lr_schedule, make_optimizer
from repro_torch.train.steps import make_train_step

ARCH = "gemma3-1b"
CFG = reduced(get_config(ARCH))
JCFG = jreduced(jget_config(ARCH))


def _np(t):
    return t.detach().float().numpy()


def _tokens(seed, B=2, S=40):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_and_state_match_jax():
    jp = JPipeline(JCFG, batch=4, seq_len=16)
    tp = SyntheticPipeline(CFG, batch=4, seq_len=16, device="cpu")
    js, ts = jp.init_state(seed=3), tp.init_state(seed=3)
    for _ in range(5):
        jb, js = jp.next(js)
        tb, ts = tp.next(ts)
        assert tb["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tb["tokens"].numpy(), jb["tokens"])
        assert ts.to_json() == js.to_json()


def test_pipeline_state_restores_exactly():
    pipe = SyntheticPipeline(CFG, batch=4, seq_len=16, device="cpu")
    s0 = pipe.init_state(seed=9)
    batches, s = [], s0
    for _ in range(5):
        b, s = pipe.next(s)
        batches.append(b)
    mid = s0
    for _ in range(3):
        _, mid = pipe.next(mid)
    mid = DataState.from_json(mid.to_json())
    b3, _ = pipe.next(mid)
    assert torch.equal(b3["tokens"], batches[3]["tokens"])
    assert sum(s.source_counts) == 5 * 4 * 16


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 57, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_lr_schedule_matches_jax(step):
    got = lr_schedule(torch.tensor(step, dtype=torch.int32))
    ref = jlr(jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in params.items()}
    jopt = JAdamW()
    jst = jopt.init(jax.tree.map(jnp.asarray, params))
    jp = jax.tree.map(jnp.asarray, params)
    topt = AdamW()
    tp = from_jax_state(params, "cpu")
    tst = topt.init(tp)
    for lr in (1e-2, 3e-3):
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                              jnp.float32(lr))
        topt.update(from_jax_state(grads, "cpu"), tst, tp,
                    torch.tensor(lr))
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(tst["m"][k]), np.asarray(jst["m"][k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(tst["v"][k]), np.asarray(jst["v"][k]),
                                   rtol=1e-6, atol=1e-7)
    assert int(tst["count"]) == int(jst["count"]) == 2


def test_make_optimizer_and_adafactor():
    assert isinstance(make_optimizer(CFG), AdamW)
    assert isinstance(Adafactor(), Adafactor)
    assert isinstance(
        make_optimizer(dataclasses.replace(CFG, optimizer="adafactor")),
        Adafactor)


# ---------------------------------------------------------------------------
# loss and gradients, one train step
# ---------------------------------------------------------------------------

def _models(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    tcfg = dataclasses.replace(CFG, dtype=dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    return jm, jparams, tm, params_from_jax(jax.tree.map(np.asarray,
                                                         jparams), "cpu")


def _jax_grads(dtype, toks):
    jm, jparams, _, _ = _models(dtype)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)})
    return jl, jmet, jg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    _, _, tm, tparams = _models(dtype)
    toks = _tokens(0)
    jl, jmet, jg = _jax_grads(dtype, toks)
    ref32 = [np.asarray(a) for _, a in jleaf_paths(_jax_grads("float32",
                                                              toks)[2])]
    live = [p.detach().requires_grad_() for _, p in leaf_paths(tparams)]
    tl, tmet = tm.loss(tree_unflatten(tparams, live),
                       {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tl, live)
    assert set(tmet) == set(jmet) == {"nll", "loss"}
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    def rel(a, b):
        return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)

    for (name, ref), got, r32 in zip(jleaf_paths(jg), grads, ref32):
        assert tuple(got.shape) == ref.shape, name
        assert str(got.dtype).endswith(dtype), name
        r, g = np.asarray(ref, np.float32), _np(got)
        if dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max() + 1e-12,
                                       err_msg=name)
        else:
            # bf16 noise: JAX's own bf16 gradients sit up to 9% from its
            # f32 ones here (the q/k-norm scales sum many products); the
            # port's must sit as near JAX's bf16 ones, and no further
            # than twice JAX's distance (+1%) from the f32 gradients
            assert rel(g, r) < 1e-1, (name, rel(g, r))
            assert rel(g, r32) <= 2 * rel(r, r32) + 1e-2, \
                (name, rel(g, r32), rel(r, r32))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    jm, jparams, tm, _ = _models("float32")
    jopt = JAdamW()
    jstate = jinit_state(jm, jopt, jax.random.PRNGKey(1))
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate), "cpu")
    toks = _tokens(5, B=4, S=24)
    jnew, jmet = jmake_step(jm, jopt, grad_accum=grad_accum)(
        jstate, {"tokens": jnp.asarray(toks)})
    tnew, tmet = make_train_step(tm, AdamW(), grad_accum=grad_accum)(
        tstate, {"tokens": torch.from_numpy(toks)})
    assert set(tmet) == set(jmet)
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-5, err_msg=k)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tnew["opt"]["count"]) == 1
    for (name, ref), (tname, got) in zip(jleaf_paths(jnew),
                                         leaf_paths(tnew)):
        assert name == tname
        r, g = np.asarray(ref, np.float32), _np(got)
        # Adam's first step moves a parameter by lr·g/(|g| + eps): where
        # |g| is near eps the quotient magnifies the gradients' rounding
        # difference, so parameters agree to a tenth of one step
        atol = 0.1 * float(jmet["lr"]) if name.startswith("params/") else \
            1e-4 * np.abs(r).max() + 1e-20
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)


def test_abstract_and_initial_state_match_jax_tree():
    jm, _, tm, _ = _models("float32")
    jstate = jinit_state(jm, JAdamW(), jax.random.PRNGKey(0))
    specs = [(n, tuple(a.shape), str(np.asarray(a).dtype))
             for n, a in jleaf_paths(jstate)]

    def tspecs(tree):
        return [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for n, t in leaf_paths(tree)]

    assert tspecs(abstract_train_state(tm, AdamW())) == specs
    fresh = init_train_state(tm, AdamW(), seed=0, device="cpu")
    assert tspecs(fresh) == specs
    # convert carries the AdamW count and the rng words of a JAX state
    moved = from_jax_state(jax.tree.map(np.asarray, jstate), "cpu")
    assert tspecs(moved) == specs
    assert moved["opt"]["count"].dtype == torch.int32
    assert moved["rng"].dtype == torch.uint32
    np.testing.assert_array_equal(
        moved["rng"].view(torch.int32).numpy().view(np.uint32),
        np.asarray(jstate["rng"]))
    assert torch.equal(fresh["rng"].view(torch.int32),
                       moved["rng"].view(torch.int32))


def test_deterministic_step_needs_the_cublas_workspace(monkeypatch):
    """On CUDA the deterministic step refuses to run without
    ``CUBLAS_WORKSPACE_CONFIG`` (cuBLAS reads it at its first use, so a
    setting made inside the step could come too late); the launcher sets
    it before anything runs. The check comes before any CUDA call."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train.steps import CUBLAS_WORKSPACE, deterministic
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with deterministic(torch.device("cuda")):
            pass
    with deterministic(torch.device("cpu")):
        pass
    with pytest.raises(SystemExit):
        launch_train.main(["--help"])
    import os
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE
