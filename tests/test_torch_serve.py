"""The serving slice as a whole on reduced gemma3-1b (f32, vocab 128,
window 16): the port's ``Model`` against the JAX package's on the same
weights (JAX ``Model.init`` carried across by ``convert``), the cache tree
the serving checkpoint stores, and preempt/resume across the two packages
— a serving run preempted by one and resumed by the other must give the
tokens of an uninterrupted run, because the serving checkpoint (params,
KV caches, token buffer, cursor) has the same leaves in both."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import storage as jstorage
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import storage as tstorage
from repro_torch.core.split_state import leaf_paths
from repro_torch.launch import serve as tserve
from repro_torch.models import Model

ARCH = "gemma3-1b"
# prompt longer than the window: the local layers' ring buffers wrap
SERVE = dict(n_requests=3, prompt_len=20, gen_len=12, ckpt_every=0, seed=13)
ATOL = 1e-4            # f32 logits; the sums run in another order


@pytest.fixture(autouse=True)
def private_stores(monkeypatch):
    """Both launchers' stores under the test's workdir: the default fast
    tier is shared per process under /dev/shm, where one test's checkpoint
    would become the next test's resume point."""
    monkeypatch.setattr(jserve, "default_store",
                        partial(jstorage.default_store, burst_buffer=False))
    monkeypatch.setattr(tserve, "default_store",
                        partial(tstorage.default_store, burst_buffer=False))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.dtype == "float32" and tcfg.vocab_size == 128 \
        and tcfg.window == 16
    jm, tm = JModel(jcfg), Model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _np(t):
    return t.detach().cpu().numpy()


def _specs(pairs):
    return [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for n, x in pairs]


def test_params_and_cache_trees_match_jax(models):
    jm, jparams, tm, tparams = models
    assert _specs(leaf_paths(tparams)) == _specs(jleaf_paths(jparams))
    assert _specs(leaf_paths(tm.abstract_params())) == \
        _specs(jleaf_paths(jparams))
    for dev in ("cpu", "meta"):
        got = tm.init_cache(3, 32, device=dev)
        assert _specs(leaf_paths(got)) == \
            _specs(jleaf_paths(jm.init_cache(3, 32)))


def test_prefill_and_decode_logits_match_jax(models):
    jm, jparams, tm, tparams = models
    tokens = np.random.default_rng(3).integers(0, 128, (2, 20),
                                               dtype=np.int32)
    cache_len = 26
    jlog, jcache = jm.prefill(jparams, jnp.asarray(tokens),
                              cache_len=cache_len)
    tlog, tcache = tm.prefill(tparams, torch.from_numpy(tokens),
                              cache_len=cache_len)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 128)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=ATOL)
    # the cache the serving checkpoint stores: same leaves, same layout
    jflat = dict(jleaf_paths(jcache))
    assert _specs(leaf_paths(tcache)) == _specs(jleaf_paths(jcache))
    for name, t in leaf_paths(tcache):
        np.testing.assert_allclose(_np(t), np.asarray(jflat[name]),
                                   atol=ATOL, err_msg=name)
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for _ in range(5):              # past the local window: slots wrap
        jlog, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tparams, tcache,
                                      torch.from_numpy(tok))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=ATOL)
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 25
    for name, t in leaf_paths(tcache):
        np.testing.assert_allclose(_np(t), np.asarray(
            dict(jleaf_paths(jcache))[name]), atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Each package's uninterrupted run (own weights from the seed)."""
    wd = tmp_path_factory.mktemp("full")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "default_store",
                   partial(jstorage.default_store, burst_buffer=False))
        mp.setattr(tserve, "default_store",
                   partial(tstorage.default_store, burst_buffer=False))
        j = jserve.run(ARCH, workdir=str(wd / "jax"), **SERVE)
        t = tserve.run(ARCH, workdir=str(wd / "port"), device="cpu", **SERVE)
    assert j["status"] == t["status"] == "completed"
    return j["tokens"], t["tokens"]


def test_jax_preempts_port_resumes_token_exact(tmp_path, uninterrupted):
    wd = str(tmp_path / "serve")
    pre = jserve.run(ARCH, workdir=wd, preempt_at=5, **SERVE)
    assert pre["status"] == "preempted" and pre["cursor"] == 5
    res = tserve.run(ARCH, workdir=wd, device="cpu", **SERVE)
    assert res["status"] == "completed" and res["restore_s"] >= 0
    np.testing.assert_array_equal(res["tokens"], uninterrupted[0])


def test_port_preempts_jax_resumes_token_exact(tmp_path, uninterrupted):
    wd = str(tmp_path / "serve")
    pre = tserve.run(ARCH, workdir=wd, preempt_at=5, device="cpu", **SERVE)
    assert pre["status"] == "preempted" and pre["cursor"] == 5
    assert pre["save_bytes"] > 0
    res = jserve.run(ARCH, workdir=wd, **SERVE)
    assert res["status"] == "completed"
    np.testing.assert_array_equal(res["tokens"], uninterrupted[1])


def test_port_preempt_and_resume_token_exact(tmp_path, uninterrupted):
    wd = str(tmp_path / "serve")
    pre = tserve.run(ARCH, workdir=wd, preempt_at=7, device="cpu",
                     **dict(SERVE, ckpt_every=4))
    assert pre["status"] == "preempted" and pre["cursor"] == 7
    np.testing.assert_array_equal(pre["tokens"][:, :7],
                                  uninterrupted[1][:, :7])
    assert (pre["tokens"][:, 7:] == -1).all()
    res = tserve.run(ARCH, workdir=wd, device="cpu", **SERVE)
    assert res["status"] == "completed" and res["cursor"] == 12
    np.testing.assert_array_equal(res["tokens"], uninterrupted[1])


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced(get_config(ARCH))
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg).init()
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.run(ARCH, workdir="unused", **SERVE)


def test_unported_families_raise(tmp_path):
    """Every family is ported (``tests/test_torch_families.py``): a
    pattern of SSM blocks builds, and what still raises is what the JAX
    launcher refuses too — serving an encoder, which has no decode path."""
    from repro_torch.configs import SSM
    cfg = dataclasses.replace(reduced(get_config(ARCH)), pattern=(SSM,),
                              ssm=reduced(get_config("mamba2-780m")).ssm)
    assert Model(cfg).stages[0].kinds == (SSM,)
    with pytest.raises(SystemExit, match="encoder"):
        tserve.run("hubert-xlarge", workdir=str(tmp_path), device="cpu",
                   **SERVE)
