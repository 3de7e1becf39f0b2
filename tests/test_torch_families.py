"""The SSM, RG-LRU and encoder families in the port's ``Model``, serving
launcher and ``Trainer``, on the CPU, held against the JAX package at
``reduced(cfg)`` (f32, vocab 128 or 504 → 128): mamba2-780m (SSM blocks
only, no MLP; tied embeddings), recurrentgemma-9b (RG-LRU, RG-LRU, local
attention; MQA, window 16) and hubert-xlarge (encoder: conv positional
embedding, LayerNorm with biases, non-causal attention, frame features in,
an untied head out). Weights come from the JAX ``Model.init`` through
``convert.params_from_jax``; inputs from a numpy seed; the kernel wrappers
take their plain versions (the tensors lie on the CPU).

Per config: the full-size training state's leaf names, shapes and dtypes
(the SSM's ``A_log``/``D``/``dt_bias`` and the RG-LRU's ``lam`` and gates
in f32 among bf16 leaves), the reduced ``param_specs``, the loss (or
``encode``), prefill and decode with the cache tree the serving
checkpoint stores, and one AdamW train step. Then serving checkpoints of
mamba2 and recurrentgemma written by each package and resumed by the
other token for token, the encoder pipeline's batches, and a mamba2 and a
hubert ``Trainer`` preempted and resumed (also from a JAX checkpoint).

Tolerances (``tests/test_torch_train.py``'s): f32 loss 1e-5 relative,
logits and caches 1e-5 of their largest entry; the train step's metrics
2e-5 relative, parameters a tenth of the step's learning rate, optimizer
moments 1e-4 of each leaf's largest entry."""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import storage as jstorage
from repro.core.split_state import abstract_train_state as jabstract
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro.train.steps import make_train_step as jmake_step
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import from_jax_state, params_from_jax
from repro_torch.core import storage as tstorage
from repro_torch.core.preempt import PreemptionGuard
from repro_torch.core.split_state import (abstract_train_state, leaf_paths,
                                          tree_unflatten)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.state import param_specs
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.steps import make_train_step

FAMILIES = ["mamba2-780m", "recurrentgemma-9b", "hubert-xlarge"]
DECODERS = ["mamba2-780m", "recurrentgemma-9b"]
# prompts past the reduced window of 16 (the ring wraps) and a whole
# number of SSD chunks (min(32, S) divides S)
SERVE = dict(n_requests=3, prompt_len=20, gen_len=12, ckpt_every=0,
             seed=13)


def _np(t):
    return t.detach().float().numpy()


def _specs(pairs):
    return [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for n, x in pairs]


def _spec_leaves(node, prefix=""):
    for k in sorted(node):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(node[k], dict):
            yield from _spec_leaves(node[k], name)
        else:
            yield (name, tuple(node[k][0]), node[k][2])


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max() + 1e-12,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jm = JModel(jreduced(jget_config(arch)))
    return jm, jm.init(jax.random.PRNGKey(1))


def _encoder_batch(seed, cfg, B=2, S=40):
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32),
            "mask": rng.random((B, S)) < 0.35}


def _batch(arch, cfg, seed, B, S):
    if cfg.family == "encoder":
        return _encoder_batch(seed, cfg, B, S)
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)}


@pytest.fixture(autouse=True)
def private_stores(monkeypatch):
    """Both serving launchers' stores under the test's workdir (the
    default fast tier is shared per process under /dev/shm)."""
    monkeypatch.setattr(jserve, "default_store",
                        partial(jstorage.default_store, burst_buffer=False))
    monkeypatch.setattr(tserve, "default_store",
                        partial(tstorage.default_store, burst_buffer=False))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_arch_ids_include_the_three_families():
    assert len(ARCH_IDS) == 10 and set(FAMILIES) <= set(ARCH_IDS)
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    for arch in FAMILIES:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_size_state_tree_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    ref = _specs(jleaf_paths(jabstract(JModel(jcfg),
                                       jmake_optimizer(jcfg))))
    got = _specs(leaf_paths(abstract_train_state(Model(cfg),
                                                 make_optimizer(cfg))))
    assert got == ref
    f32 = {n.rsplit("/", 1)[1] for n, _, d in got
           if n.startswith("params/stage") and d == "float32"}
    assert f32 == {"ssm": {"A_log", "D", "dt_bias"},
                   "recurrentgemma-9b": {"lam", "gate_a_w", "gate_a_b",
                                         "gate_x_w", "gate_x_b"},
                   "encoder": set()}[
        "ssm" if cfg.family == "ssm" else
        "encoder" if cfg.family == "encoder" else arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_param_specs_match_jax(arch):
    cfg = reduced(get_config(arch))
    _, jp = _jax_init(arch)
    ref = _specs(jleaf_paths(jp))
    assert list(_spec_leaves(param_specs(cfg))) == ref
    assert _specs(leaf_paths(Model(cfg).abstract_params())) == ref
    tp = Model(cfg).init(seed=0, device="cpu")
    assert _specs(leaf_paths(tp)) == ref
    assert all(torch.isfinite(t).all() for _, t in leaf_paths(tp))


# ---------------------------------------------------------------------------
# forward, serving path, encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_loss_prefill_and_decode_match_jax(arch):
    cfg = reduced(get_config(arch))
    jm, jp = _jax_init(arch)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _batch(arch, cfg, 0, 2, 64)["tokens"]
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :32]), cache_len=40)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :32]), cache_len=40)
    _close(tlog, jlog, "prefill")
    assert _specs(leaf_paths(tc)) == _specs(jleaf_paths(jc))
    for dev in ("cpu", "meta"):
        assert _specs(leaf_paths(tm.init_cache(2, 40, device=dev))) == \
            _specs(jleaf_paths(jm.init_cache(2, 40)))
    jdecode = jax.jit(jm.decode_step)
    for i in range(4):
        nt = toks[:, 32 + i]
        jlog, jc = jdecode(jp, jc, jnp.asarray(nt))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nt))
        _close(tlog, jlog, f"decode {i}")
    assert int(tc["pos"]) == int(jc["pos"]) == 36
    jflat = dict(jleaf_paths(jc))
    for name, t in leaf_paths(tc):
        if name != "pos":
            _close(t, jflat[name], name)


def test_encode_and_encoder_loss_match_jax():
    arch = "hubert-xlarge"
    cfg = reduced(get_config(arch))
    jm, jp = _jax_init(arch)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b = _encoder_batch(0, cfg)
    je = jm.encode(jp, jnp.asarray(b["features"]))
    te = tm.encode(tp, torch.from_numpy(b["features"]))
    assert te.dtype == torch.float32 and tuple(te.shape) == je.shape
    _close(te, je, "encode")
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tmet) == set(jmet) == {"loss", "nll"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_match_jax(arch):
    """Every leaf's gradient of the loss against ``jax.grad``, within
    1e-4 of its largest entry plus 1e-6 of the model's largest gradient
    (f32); a leaf the loss never reads (hubert's token embedding) gets
    zeros, as from ``jax.grad``."""
    cfg = reduced(get_config(arch))
    jm, jp = _jax_init(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b = _batch(arch, cfg, 7, 2, 64)
    jg = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v)
                                        for k, v in b.items()})[0])(jp)
    live = [t.detach().requires_grad_() for _, t in leaf_paths(tp)]
    loss, _ = Model(cfg).loss(tree_unflatten(tp, live),
                              {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    # plus 1e-6 of the largest gradient: a leaf whose gradient is rounding
    # noise (hubert's k_b: softmax is invariant to a shift of every key)
    floor = 1e-6 * max(np.abs(np.asarray(a)).max() for _, a in
                       jleaf_paths(jg))
    for (name, ref), got in zip(jleaf_paths(jg), grads):
        r = np.asarray(ref, np.float32)
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(_np(got), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + floor,
                                   err_msg=name)
    if cfg.family == "encoder":
        assert not np.asarray(jg["embed"]).any()


@pytest.mark.parametrize("arch", ["mamba2-780m", "hubert-xlarge"])
def test_train_step_matches_jax(arch):
    """One AdamW step; hubert's token embedding, which ``encode`` never
    reads, gets the zero gradient ``jax.grad`` gives it. A leaf whose
    gradient is rounding noise moves by Adam's normalised noise in both
    packages: its parameters are held within 1.1 · lr, its moments within
    1e-6 of the largest first moment more."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    (jm, jp), tm = _jax_init(arch), Model(cfg)
    jopt, topt = jmake_optimizer(jcfg), make_optimizer(cfg)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.key_data(jax.random.PRNGKey(0))}
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate), "cpu")
    b = _batch(arch, cfg, 5, 4, 32)
    jnew, jmet = jmake_step(jm, jopt)(jstate, {k: jnp.asarray(v)
                                               for k, v in b.items()})
    tnew, tmet = make_train_step(tm, topt)(
        tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-5, err_msg=k)
    lr = float(jmet["lr"])
    # a leaf whose gradient is rounding noise (below 1e-6 of the largest:
    # hubert's k_b, whose gradient softmax's shift invariance makes 0)
    # gets Adam's normalised noise, at most lr, in either package
    m_ref = {n[len("opt/m/"):]: np.abs(np.asarray(a)).max()
             for n, a in jleaf_paths(jnew) if n.startswith("opt/m/")}
    noise = {n for n, a in m_ref.items() if a < 1e-6 * max(m_ref.values())}
    for (name, ref), (tname, got) in zip(jleaf_paths(jnew),
                                         leaf_paths(tnew)):
        assert name == tname
        r, g = np.asarray(ref, np.float32), _np(got)
        leaf = name.split("/", 1 if name.startswith("params/") else 2)[-1]
        if name.startswith("params/"):
            atol = 1.1 * lr if leaf in noise else 0.1 * lr
        else:
            atol = 1e-4 * np.abs(r).max() + 1e-20
            if leaf in noise:
                atol += 1e-6 * max(m_ref.values())
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    assert noise <= {"embed", "stage_0/b0/k_b"}
    if cfg.family == "encoder":
        assert not tnew["opt"]["m"]["embed"].any()


def test_encoder_pipeline_batches_match_jax():
    cfg = reduced(get_config("hubert-xlarge"))
    jcfg = jreduced(jget_config("hubert-xlarge"))
    tp = SyntheticPipeline(cfg, batch=3, seq_len=24, device="cpu")
    jpipe = JPipeline(jcfg, batch=3, seq_len=24)
    ts, js = tp.init_state(4), jpipe.init_state(4)
    for _ in range(3):
        tb, ts = tp.next(ts)
        jb, js = jpipe.next(js)
        assert set(tb) == set(jb) == {"features", "labels", "mask"}
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        assert tb["mask"].dtype == torch.bool
        assert ts.to_json() == js.to_json()


# ---------------------------------------------------------------------------
# serving checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Each package's uninterrupted run of each decoder family."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "default_store",
                   partial(jstorage.default_store, burst_buffer=False))
        mp.setattr(tserve, "default_store",
                   partial(tstorage.default_store, burst_buffer=False))
        for arch in DECODERS:
            wd = tmp_path_factory.mktemp(arch)
            j = jserve.run(arch, workdir=str(wd / "jax"), **SERVE)
            t = tserve.run(arch, workdir=str(wd / "port"), device="cpu",
                           **SERVE)
            assert j["status"] == t["status"] == "completed"
            out[arch] = (j["tokens"], t["tokens"])
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_jax_preempts_port_resumes_token_exact(tmp_path, uninterrupted,
                                               arch):
    wd = str(tmp_path / "serve")
    pre = jserve.run(arch, workdir=wd, preempt_at=5, **SERVE)
    assert pre["status"] == "preempted" and pre["cursor"] == 5
    res = tserve.run(arch, workdir=wd, device="cpu", **SERVE)
    assert res["status"] == "completed" and res["restore_s"] >= 0
    np.testing.assert_array_equal(res["tokens"], uninterrupted[arch][0])


@pytest.mark.parametrize("arch", DECODERS)
def test_port_preempts_jax_resumes_token_exact(tmp_path, uninterrupted,
                                               arch):
    wd = str(tmp_path / "serve")
    pre = tserve.run(arch, workdir=wd, preempt_at=5, device="cpu", **SERVE)
    assert pre["status"] == "preempted" and pre["save_bytes"] > 0
    res = jserve.run(arch, workdir=wd, **SERVE)
    assert res["status"] == "completed"
    np.testing.assert_array_equal(res["tokens"], uninterrupted[arch][1])


def test_serving_depth_cut(tmp_path):
    """``n_layers`` serves the config's first layers at its widths (the
    card's recurrentgemma-9b run takes 6 of 38), and the cut run
    preempts and resumes token-exact."""
    kw = dict(SERVE, n_layers=3, device="cpu")
    full = tserve.run("recurrentgemma-9b", workdir=str(tmp_path / "f"), **kw)
    pre = tserve.run("recurrentgemma-9b", workdir=str(tmp_path / "p"),
                     preempt_at=5, **kw)
    res = tserve.run("recurrentgemma-9b", workdir=str(tmp_path / "p"), **kw)
    assert pre["status"] == "preempted" and res["status"] == "completed"
    np.testing.assert_array_equal(res["tokens"], full["tokens"])
    cfg = reduced(get_config("recurrentgemma-9b"))
    assert len(Model(dataclasses.replace(cfg, n_layers=3)).stages) == 1 \
        < len(Model(cfg).stages)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _tcfg(path, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("seq_len", 32)
    kw.setdefault("log_every", 100)
    return TrainerConfig(workdir=str(path), **kw)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hubert-xlarge"])
def test_trainer_preempt_and_resume_bit_exact(tmp_path, arch):
    """Run A six steps; run B (incremental CDC, byteplane params)
    preempted after step 3 and resumed to step 6: the same
    ``params_digest``."""
    cfg = reduced(get_config(arch))
    tA = Trainer(cfg, _tcfg(tmp_path / "a", ckpt_every=0, seed=3),
                 device="cpu")
    tA.init_or_restore()
    tA.fit(6)
    pol = dict(ckpt_mode="incremental", chunking="cdc", chunk_size=4096,
               codec="raw", params_codec="byteplane-rle", ckpt_every=2,
               seed=3)
    tB = Trainer(cfg, _tcfg(tmp_path / "b", **pol), device="cpu")
    tB.init_or_restore()
    with PreemptionGuard() as guard:
        tB.fit(6, guard=guard, stop_after=3)
        guard.request()
        rep = tB.fit(6, guard=guard)
    assert rep["status"] == "preempted" and rep["step"] == 3
    tB.manager.close()
    tC = Trainer(cfg, _tcfg(tmp_path / "b", **pol), device="cpu")
    tC.init_or_restore()
    assert tC.restored_from == 3
    out = tC.fit(6)
    assert out["status"] == "completed"
    assert tC.params_digest() == tA.params_digest()
    assert all(np.isfinite(h["loss"]) for h in tA.history)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hubert-xlarge"])
def test_port_resumes_jax_trainer_checkpoint(tmp_path, arch):
    kw = dict(batch=2, seq_len=32, ckpt_every=2, log_every=100, seed=2)
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jt = JTrainer(jcfg, JTrainerConfig(workdir=str(tmp_path / "run"), **kw))
    jt.init_or_restore()
    jt.fit(2)
    jt.manager.close()
    jr = JTrainer(jcfg, JTrainerConfig(workdir=str(tmp_path / "run"), **kw))
    jr.init_or_restore()
    t = Trainer(cfg, TrainerConfig(workdir=str(tmp_path / "run"), **kw),
                device="cpu")
    t.init_or_restore()
    assert t.restored_from == jr.restored_from == 2
    assert t.params_digest() == jr.params_digest()
    assert t.fit(3)["status"] == "completed"


@pytest.mark.parametrize("arch", ["mamba2-780m", "hubert-xlarge"])
def test_train_launcher_runs_the_family_on_cpu(tmp_path, arch, capsys):
    argv = ["--arch", arch, "--steps", "2", "--ckpt-every", "2",
            "--batch", "2", "--seq-len", "32", "--workdir",
            str(tmp_path / "w"), "--device", "cpu", "--sync-ckpt"]
    assert ttrain.main(argv) == 0
    assert "status=completed step=2" in capsys.readouterr().out
