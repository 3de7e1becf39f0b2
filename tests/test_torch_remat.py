"""Per-layer rematerialisation in the port (``cfg.remat_policy``: nothing,
dots, full, offload_resid), on the CPU, held against the JAX package at
``reduced(cfg)`` (f32) for the five families: dense attention
(gemma3-1b, 7 layers: a unit of 6 blocks and a unit of 1), MoE
(llama4-scout), SSM (mamba2-780m), RG-LRU with local attention
(recurrentgemma-9b: units of 3 blocks) and the encoder (hubert-xlarge).

Weights come from the JAX ``Model.init`` through
``convert.params_from_jax``; inputs from a numpy seed. Checks:

* loss and every gradient under nothing / dots / offload_resid bit-equal
  (``torch.equal``) to ``full``'s: the recompute replays the same
  operators on the same inputs;
* each policy's gradients against ``jax.value_and_grad(model.loss)`` under
  the same policy: f32 loss 1e-5 relative, gradients 1e-4 of each leaf's
  largest entry (``tests/test_torch_train.py``) plus 1e-6 of the model's
  largest gradient for a leaf that is rounding noise
  (``tests/test_torch_families.py``: hubert's ``k_b``);
* what the forward leaves held for the backward. Non-reentrant
  ``torch.utils.checkpoint`` keeps a unit's inputs, and selective
  checkpointing its kept outputs, outside autograd's saved-tensor hooks,
  so a hook installed around the forward does not see them; ``_Held``
  follows every storage the forward makes (a weak reference on its Python
  object, which PyTorch keeps alive as long as the storage: the dry run's
  way of counting live bytes) and lists those still alive when it
  returns. Under ``dots`` they add, to ``nothing``'s, exactly the dot
  outputs that ``jax.ad_checkpoint``'s ``saved_residuals`` lists for the
  reference's checkpointed scan body (element counts, each unit's);
  under ``nothing`` one more unit adds one unit input, B·S·D·itemsize
  bytes; under ``offload_resid`` each unit holds one host copy of shape
  (B, S, D) and no parameter;
* with grad disabled, ``encode``, ``prefill`` and ``decode_step`` run no
  checkpoint; an unknown policy raises ``KeyError``, as the reference's
  lookup does."""
import collections
import dataclasses
import functools
import gc
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.models import Model as JModel
from repro.models.model import _resolve_policy as jresolve_policy
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.split_state import leaf_paths, tree_unflatten
from repro_torch.models import Model
from repro_torch.models import model as model_mod

ARCHS = ["gemma3-1b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-9b", "hubert-xlarge"]
POLICIES = ["nothing", "dots", "full", "offload_resid"]
B, S = 2, 64


def _np(t):
    return t.detach().float().numpy()


def _cfgs(arch, policy, n_layers=None):
    j, t = jreduced(jget_config(arch)), reduced(get_config(arch))
    extra = {"n_layers": n_layers} if n_layers else {}
    return (dataclasses.replace(j, remat_policy=policy, **extra),
            dataclasses.replace(t, remat_policy=policy, **extra))


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"features": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32),
                "mask": rng.random((B, S)) < 0.35}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)}


@functools.lru_cache(maxsize=None)
def _init(arch, n_layers=None):
    jcfg, _ = _cfgs(arch, "nothing", n_layers)
    return JModel(jcfg).init(jax.random.PRNGKey(1))


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _port(arch, policy):
    """(loss, gradients in leaf order) of the port under `policy`."""
    jcfg, tcfg = _cfgs(arch, policy)
    tp = params_from_jax(jax.tree.map(np.asarray, _init(arch)), "cpu")
    live = [t.detach().requires_grad_() for _, t in leaf_paths(tp)]
    loss, _ = Model(tcfg).loss(tree_unflatten(tp, live),
                               _torch_batch(_batch(tcfg)))
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


@functools.lru_cache(maxsize=None)
def _jax(arch, policy):
    jcfg, _ = _cfgs(arch, policy)
    b = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, _), g = jax.jit(jax.value_and_grad(JModel(jcfg).loss,
                                              has_aux=True))(_init(arch), b)
    return float(loss), g


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["nothing", "dots", "offload_resid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bit_equal_to_full(arch, policy):
    loss, grads = _port(arch, policy)
    ref_loss, ref = _port(arch, "full")
    assert torch.equal(loss, ref_loss)
    assert len(grads) == len(ref)
    for (name, _), g, r in zip(jleaf_paths(_init(arch)), grads, ref):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_under_the_same_policy(arch, policy):
    loss, grads = _port(arch, policy)
    jl, jg = _jax(arch, policy)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    floor = 1e-6 * max(np.abs(np.asarray(a)).max()
                       for _, a in jleaf_paths(jg))
    for (name, ref), got in zip(jleaf_paths(jg), grads):
        r = np.asarray(ref, np.float32)
        assert tuple(got.shape) == r.shape, name
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(_np(got), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + floor,
                                   err_msg=f"{policy} {name}")


# ---------------------------------------------------------------------------
# what the forward holds for the backward
# ---------------------------------------------------------------------------

class _Held(TorchDispatchMode):
    """Every storage made by an operator while the mode is on, except
    those of `known` tensors, with (shape, dtype, device, operator) of the
    tensor that made it; ``live`` keeps those whose storage is alive."""

    def __init__(self, known):
        super().__init__()
        self.known = {id(t.untyped_storage()) for t in known}
        self.live = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            k = id(st)
            if k in self.known or k in self.live:
                continue
            self.live[k] = (tuple(t.shape), t.dtype, t.device.type,
                            str(func.overloadpacket))
            weakref.finalize(st, self.live.pop, k, None)
        return out


def _held(arch, policy, n_layers=None):
    """(storages the loss's forward leaves alive, the model, the config):
    what autograd and the checkpoints hold for the backward."""
    _, tcfg = _cfgs(arch, policy, n_layers)
    tp = params_from_jax(jax.tree.map(np.asarray, _init(arch, n_layers)),
                         "cpu")
    live = [t.detach().requires_grad_() for _, t in leaf_paths(tp)]
    batch = _torch_batch(_batch(tcfg))
    model = Model(tcfg)
    mode = _Held(live + list(batch.values()))
    with mode:
        loss, metrics = model.loss(tree_unflatten(tp, live), batch)
    del metrics
    gc.collect()
    held = list(mode.live.values())
    assert loss.requires_grad
    return held, model, tcfg


def _nbytes(held):
    return sum(math.prod(s) * d.itemsize for s, d, _, _ in held)


def _reference_dots(arch) -> collections.Counter:
    """(element count, dtype) of each dot output that the reference's
    checkpointed scan body (``src/repro/models/model.py``
    ``_run_stages_sequence``'s ``body`` under ``jax.checkpoint`` with the
    ``dots`` policy) saves, times the stage's repeats."""
    jcfg, _ = _cfgs(arch, "dots")
    m = JModel(jcfg)
    params = _init(arch)
    ropes = m._ropes(jnp.arange(S))
    out = collections.Counter()
    for si, stage in enumerate(m.stages):
        def body(xc, layer_p, _stage=stage):
            for j, kind in enumerate(_stage.kinds):
                xc, _, _ = m._block_sequence(layer_p[f"b{j}"], xc, kind,
                                             _stage.moe, ropes,
                                             want_cache=False)
            return xc

        f = jax.checkpoint(body, policy=jresolve_policy("dots"),
                           prevent_cse=False)
        layer_p = jax.tree.map(lambda a: a[0], params[f"stage_{si}"])
        x = jnp.zeros((B, S, jcfg.d_model), jnp.float32)
        for aval, src in saved_residuals(f, x, layer_p):
            if src.startswith(("from the argument", "from a constant")):
                continue
            out[(math.prod(aval.shape), str(aval.dtype))] += stage.repeat
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_reference_dot_outputs(arch):
    dots, model, _ = _held(arch, "dots")
    nothing, _, _ = _held(arch, "nothing")
    extra = collections.Counter(dots) - collections.Counter(nothing)
    assert not collections.Counter(nothing) - collections.Counter(dots)
    assert {op for _, _, _, op in extra.elements()} <= {"aten.mm",
                                                       "aten.bmm"}
    got = collections.Counter({(math.prod(s), str(d).replace("torch.", "")):
                               n for (s, d, _, _), n in extra.items()})
    ref = _reference_dots(arch)
    assert sum(ref.values()) > 0
    assert got == ref


def _units(model) -> int:
    return sum(stage.repeat for stage in model.stages)


@pytest.mark.parametrize("arch", ARCHS)
def test_nothing_holds_one_unit_input_per_unit(arch):
    """One unit more (the pattern once more) holds B·S·D·itemsize bytes
    more under ``nothing``; under ``full`` it holds far more."""
    base = reduced(get_config(arch)).n_layers
    more = base + len(get_config(arch).pattern)
    h0, m0, cfg = _held(arch, "nothing", base)
    h1, m1, _ = _held(arch, "nothing", more)
    assert _units(m1) == _units(m0) + 1
    unit_input = B * S * cfg.d_model * 4
    assert _nbytes(h1) - _nbytes(h0) == unit_input
    f0, _, _ = _held(arch, "full", base)
    f1, _, _ = _held(arch, "full", more)
    assert _nbytes(f1) - _nbytes(f0) > 4 * unit_input


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_holds_one_host_copy_per_unit_and_no_parameter(arch):
    held, model, cfg = _held(arch, "offload_resid")
    copies = [h for h in held if h[3] == "aten.empty"]
    assert len(copies) == _units(model)
    assert {h[:3] for h in copies} == {((B, S, cfg.d_model), torch.float32,
                                        "cpu")}
    # the rest is what nothing's forward holds, with the copies standing
    # in for the unit inputs: no parameter (a copy would be a new storage)
    nothing, _, _ = _held(arch, "nothing")
    assert sorted(map(str, (h[:3] for h in held))) == \
        sorted(map(str, (h[:3] for h in nothing)))


# ---------------------------------------------------------------------------
# where the policies apply
# ---------------------------------------------------------------------------

@pytest.fixture
def checkpoints(monkeypatch):
    """Counts ``torch.utils.checkpoint.checkpoint`` calls."""
    import torch.utils.checkpoint as tuc
    calls = []
    inner = tuc.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tuc, "checkpoint", spy)
    return calls


def _model(arch, policy="nothing"):
    _, tcfg = _cfgs(arch, policy)
    tp = params_from_jax(jax.tree.map(np.asarray, _init(arch)), "cpu")
    return Model(tcfg), tp, tcfg


def test_encode_recomputes_only_with_grad(checkpoints):
    model, tp, cfg = _model("hubert-xlarge")
    feats = torch.from_numpy(_batch(cfg)["features"])
    with torch.no_grad():
        ref = model.encode(tp, feats)
    assert checkpoints == []
    live = {n: t.detach().requires_grad_() for n, t in leaf_paths(tp)}
    got = model.encode(tree_unflatten(tp, list(live.values())), feats)
    assert len(checkpoints) == _units(model)
    assert torch.equal(got.detach(), ref)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_prefill_and_decode_never_recompute(arch, checkpoints):
    model, tp, cfg = _model(arch)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.no_grad():
        _, cache = model.prefill(tp, tokens, cache_len=S + 2)
        model.decode_step(tp, cache, tokens[:, -1])
    assert checkpoints == []


@pytest.mark.parametrize("where", ["loss", "encode"])
def test_unknown_policy_raises(where):
    arch = "hubert-xlarge" if where == "encode" else "gemma3-1b"
    model, tp, cfg = _model(arch, "everything")
    with pytest.raises(KeyError):
        if where == "encode":
            model.encode(tp, torch.from_numpy(_batch(cfg)["features"]))
        else:
            model.loss(tp, _torch_batch(_batch(cfg)))
    assert sorted(model_mod.REMAT_POLICIES) == sorted(POLICIES)


def test_one_device_step_grads_are_the_losss_and_leave_the_state():
    """``make_train_step(...).grads`` (the card's remat phase takes each
    policy's gradients through it) gives the loss's gradients and leaves
    the state as it was."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import make_train_step
    model, tp, cfg = _model("gemma3-1b")
    state = {"params": tp, "step": torch.zeros((), dtype=torch.int32)}
    before = [t.clone() for _, t in leaf_paths(tp)]
    loss, metrics, g = make_train_step(model, make_optimizer(cfg)).grads(
        state, _torch_batch(_batch(cfg)))
    ref_loss, ref = _port("gemma3-1b", "nothing")
    assert torch.equal(loss, ref_loss) and torch.equal(metrics["loss"],
                                                       ref_loss)
    assert all(torch.equal(a, b) for (_, a), b in zip(leaf_paths(g), ref))
    assert all(torch.equal(a, b) for (_, a), b in zip(leaf_paths(tp),
                                                      before))
    assert int(state["step"]) == 0
