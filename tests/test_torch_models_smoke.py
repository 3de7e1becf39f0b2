"""``tests/test_models_smoke.py`` through the port: its four tests, with
its own assertions, for every arch at ``reduced(cfg)`` — one forward and
one optimizer step, prefill against step-by-step decode (the no-drop
capacity for MoE configs), the long-context decode state bounded, and the
encoder's shapes.

Each case runs on the reference's weights and inputs: ``Model.init`` and
the batch from its ``PRNGKey(0)``, its training state carried across with
``convert.from_jax_state``. The port runs with ``device="cpu"`` (the
kernel wrappers take their plain versions) and is also held against the
reference's outputs on those weights, within the tolerances of
``tests/test_torch_zoo.py`` and ``tests/test_torch_families.py``: f32
loss and metrics 1e-5 relative (the step's 2e-5, ``drop_fraction`` also
2^-23 absolute), logits 1e-5 of their largest entry; after the step,
parameters within a tenth of the learning rate (1.1 of it where the
gradient is rounding noise, as in ``test_torch_families.py``) and the
optimizer's leaves 1e-4 of each leaf's largest entry.

The reference's jitted steps dominate the file's time; a module fixture
compiles them on a few threads at once (XLA compiles outside the GIL)."""
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, CONFIGS, reduced
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.models import Model as JModel
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.steps import make_train_step as jmake_step
from repro_torch.configs import get_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import from_jax_state, params_from_jax
from repro_torch.core.split_state import leaf_paths
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.train.steps import make_train_step

KEY = jax.random.PRNGKey(0)
DECODERS = [a for a in ARCH_IDS if CONFIGS[a].family != "encoder"]
THREADS = 3


def _batch(cfg, B=2, S=32):
    if cfg.family == "encoder":
        return {
            "features": jax.random.normal(KEY, (B, S, cfg.d_model)),
            "labels": jax.random.randint(KEY, (B, S), 0, cfg.vocab_size),
            "mask": jnp.ones((B, S), bool),
        }
    return {"tokens": jax.random.randint(KEY, (B, S), 0, cfg.vocab_size)}


def _no_drop(cfg):
    """The reference's no-drop capacity, so token dropping can't cause
    divergence."""
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe,
                                    capacity_factor=float(cfg.moe.n_experts)))


def _np(t):
    return t.detach().float().numpy()


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _reference(arch):
    """The reference's side of every case of `arch`: its jitted step (the
    step's metrics carry ``model.loss``'s), its jitted prefill on the
    no-drop config, its jitted ``encode``; all as numpy."""
    cfg = reduced(CONFIGS[arch])
    model = JModel(cfg)
    params = model.init(KEY)
    opt = jmake_optimizer(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32),
             "rng": jax.random.key_data(KEY)}
    batch = _batch(cfg)
    new_state, m = jax.jit(jmake_step(model, opt))(state, batch)
    out = {"state": _host(state), "batch": _host(batch),
           "new_state": _host(new_state),
           "metrics": {k: float(v) for k, v in m.items()}}
    if cfg.family == "encoder":
        feats = jax.random.normal(KEY, (2, 24, cfg.d_model))
        out["feats"] = np.asarray(feats)
        out["encode"] = np.asarray(jax.jit(model.encode)(params, feats))
        return out
    dcfg = _no_drop(cfg)
    dmodel = JModel(dcfg)
    dparams = dmodel.init(KEY)
    toks = jax.random.randint(KEY, (2, 16), 0, dcfg.vocab_size)
    out["decode_params"] = _host(dparams)
    out["decode_tokens"] = np.asarray(toks)
    out["prefill"] = np.asarray(jax.jit(dmodel.prefill)(dparams, toks)[0])
    return out


@pytest.fixture(scope="module")
def ref():
    with ThreadPoolExecutor(THREADS) as pool:
        return dict(zip(ARCH_IDS, pool.map(_reference, ARCH_IDS)))


def _close(got, want, what, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-12,
                               err_msg=what)


def _metric_atol(name):
    return 2.0 ** -23 if name == "drop_fraction" else 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step(arch, ref):
    r = ref[arch]
    cfg = treduced(get_config(arch))
    model = Model(cfg)
    state = from_jax_state(r["state"], "cpu")
    batch = _torch(r["batch"])
    loss, metrics = model.loss(state["params"], batch)
    assert torch.isfinite(loss), metrics
    assert 1.0 < float(loss) < 20.0
    np.testing.assert_allclose(float(loss), r["metrics"]["loss"], rtol=1e-5)
    # one full optimizer step
    opt = make_optimizer(cfg)
    step = make_train_step(model, opt)
    new_state, m = step(state, batch)
    assert int(new_state["step"]) == 1
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert all(bool(torch.isfinite(x.float()).all())
               for _, x in leaf_paths(new_state["params"]))
    # against the reference's step on the same weights and batch
    assert set(m) == set(r["metrics"])
    for k, want in r["metrics"].items():
        np.testing.assert_allclose(float(m[k]), want, rtol=2e-5,
                                   atol=_metric_atol(k), err_msg=k)
    lr = r["metrics"]["lr"]
    jnew = jleaf_paths(r["new_state"])
    # a leaf whose gradient is rounding noise (below 1e-6 of the largest
    # first moment) moves by Adam's normalised noise in either package
    m_ref = {n[len("opt/m/"):]: np.abs(a).max() for n, a in jnew
             if n.startswith("opt/m/")}
    noise = {n for n, a in m_ref.items()
             if a < 1e-6 * max(m_ref.values())}
    got = leaf_paths(new_state)
    assert [n for n, _ in got] == [n for n, _ in jnew]
    for (name, want), (_, t) in zip(jnew, got):
        w = np.asarray(want, np.float32)
        leaf = name.split("/", 1 if name.startswith("params/") else 2)[-1]
        if name.startswith("params/"):
            atol = (1.1 if leaf in noise else 0.1) * lr
        else:
            atol = 1e-4 * np.abs(w).max() + 1e-20
            if leaf in noise:
                atol += 1e-6 * max(m_ref.values())
        np.testing.assert_allclose(_np(t), w, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_matches_decode(arch, ref):
    r = ref[arch]
    cfg = _no_drop(treduced(get_config(arch)))
    model = Model(cfg)
    params = params_from_jax(r["decode_params"], "cpu")
    toks = torch.from_numpy(r["decode_tokens"])
    B, S = toks.shape
    logits_pf, _ = model.prefill(params, toks)
    _close(logits_pf, r["prefill"], "prefill")
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        logits_dec, cache = model.decode_step(params, cache, toks[:, t])
    assert torch.max(torch.abs(logits_pf - logits_dec)) < 2e-3, arch
    np.testing.assert_allclose(_np(logits_dec), r["prefill"], rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-9b",
                                  "mamba2-780m"])
def test_long_context_decode_state_is_bounded(arch):
    """long_500k archs: decode state must not grow with absolute position;
    the cache trees' sizes are the reference's."""
    cfg = treduced(get_config(arch))
    model = Model(cfg)
    n = {L: sum(x.numel() for _, x in leaf_paths(
        model.init_cache(1, L, device="meta"))) for L in (64, 128)}
    jmodel = JModel(reduced(CONFIGS[arch]))
    assert n == {L: sum(x.size for x in jax.tree.leaves(
        jax.eval_shape(lambda L=L: jmodel.init_cache(1, L))))
        for L in (64, 128)}
    if cfg.family in ("ssm",):
        assert n[64] == n[128]  # pure-SSM state is O(1)
    # state growth only from global-attention layers (≤ fraction of layers)
    assert n[128] <= n[64] * 2.2


def test_encoder_shapes(ref):
    r = ref["hubert-xlarge"]
    cfg = treduced(get_config("hubert-xlarge"))
    model = Model(cfg)
    params = params_from_jax(r["state"]["params"], "cpu")
    logits = model.encode(params, torch.from_numpy(r["feats"]))
    assert logits.shape == (2, 24, cfg.vocab_size)
    assert bool(torch.all(torch.isfinite(logits)))
    _close(logits, r["encode"], "encode")
