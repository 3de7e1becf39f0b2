"""Serving checkpoints of the rest of the attention zoo across the two
packages: stablelm-1.6b (LayerNorm, 25% rotary, MHA), starcoder2-3b
(biases, GQA), gemma2-9b (local/global pair, softcaps; the prompt runs past
the reduced window of 16, so the local ring buffer wraps), chameleon-34b
(q/k norms) and kimi-k2-1t-a32b (a dense first layer, then top-k MoE with
a shared expert), each at ``reduced(cfg)``, which is what
``serve.run(full_config=False)`` serves.

Per config: both packages' uninterrupted runs (module-scoped, each with
its own weights from the seed); a run preempted by JAX and resumed by the
port, and one preempted by the port and resumed by JAX, each giving the
uninterrupted tokens of the package that preempted it token for token
(the serving checkpoint holds params, KV caches, token buffer and cursor
under the same leaf names in both); and the port preempted after a
periodic ``ckpt_every`` save, resumed to its own tokens. The port runs
with ``device="cpu"``: its kernel wrappers take their plain versions."""
from functools import partial

import numpy as np
import pytest

from repro.core import storage as jstorage
from repro.launch import serve as jserve
from repro_torch.configs import get_config, reduced
from repro_torch.core import storage as tstorage
from repro_torch.launch import serve as tserve

ZOO = ["stablelm-1.6b", "starcoder2-3b", "gemma2-9b", "chameleon-34b",
       "kimi-k2-1t-a32b"]
# test_torch_serve.py's traffic: 20-token prompts past the reduced window
SERVE = dict(n_requests=3, prompt_len=20, gen_len=12, ckpt_every=0, seed=13)
PREEMPT_AT = 5


def _stores(mp):
    """Both launchers' stores under the test's workdir: the default fast
    tier is shared per process under /dev/shm, where one run's checkpoint
    would become the next run's resume point."""
    mp.setattr(jserve, "default_store",
               partial(jstorage.default_store, burst_buffer=False))
    mp.setattr(tserve, "default_store",
               partial(tstorage.default_store, burst_buffer=False))


@pytest.fixture(autouse=True)
def private_stores(monkeypatch):
    _stores(monkeypatch)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """arch → (JAX's report, the port's report) of the uninterrupted run."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stores(mp)
        for arch in ZOO:
            wd = tmp_path_factory.mktemp(arch)
            out[arch] = (jserve.run(arch, workdir=str(wd / "jax"), **SERVE),
                         tserve.run(arch, workdir=str(wd / "port"),
                                    device="cpu", **SERVE))
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_uninterrupted_runs_complete(uninterrupted, arch):
    cfg = reduced(get_config(arch))
    if cfg.window:
        assert SERVE["prompt_len"] > cfg.window     # the ring wraps
    for rep in uninterrupted[arch]:
        toks = rep["tokens"]
        assert rep["status"] == "completed" and \
            rep["cursor"] == SERVE["gen_len"]
        assert toks.shape == (SERVE["n_requests"], SERVE["gen_len"])
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert uninterrupted[arch][1]["prefill_s"] >= 0


@pytest.mark.parametrize("arch", ZOO)
def test_jax_preempts_port_resumes_token_exact(tmp_path, uninterrupted,
                                               arch):
    wd = str(tmp_path / "serve")
    pre = jserve.run(arch, workdir=wd, preempt_at=PREEMPT_AT, **SERVE)
    assert pre["status"] == "preempted" and pre["cursor"] == PREEMPT_AT
    res = tserve.run(arch, workdir=wd, device="cpu", **SERVE)
    assert res["status"] == "completed" and res["restore_s"] >= 0
    np.testing.assert_array_equal(res["tokens"],
                                  uninterrupted[arch][0]["tokens"])


@pytest.mark.parametrize("arch", ZOO)
def test_port_preempts_jax_resumes_token_exact(tmp_path, uninterrupted,
                                               arch):
    wd = str(tmp_path / "serve")
    pre = tserve.run(arch, workdir=wd, preempt_at=PREEMPT_AT, device="cpu",
                     **SERVE)
    assert pre["status"] == "preempted" and pre["cursor"] == PREEMPT_AT
    assert pre["save_bytes"] > 0
    res = jserve.run(arch, workdir=wd, **SERVE)
    assert res["status"] == "completed"
    np.testing.assert_array_equal(res["tokens"],
                                  uninterrupted[arch][1]["tokens"])


@pytest.mark.parametrize("arch", ZOO)
def test_port_preempt_and_resume_token_exact(tmp_path, uninterrupted, arch):
    """A periodic save at token 4, the preempt's at 7, the resume from 7."""
    own = uninterrupted[arch][1]["tokens"]
    wd = str(tmp_path / "serve")
    pre = tserve.run(arch, workdir=wd, preempt_at=7, device="cpu",
                     **dict(SERVE, ckpt_every=4))
    assert pre["status"] == "preempted" and pre["cursor"] == 7
    np.testing.assert_array_equal(pre["tokens"][:, :7], own[:, :7])
    assert (pre["tokens"][:, 7:] == -1).all()
    res = tserve.run(arch, workdir=wd, device="cpu", **SERVE)
    assert res["status"] == "completed" and res["cursor"] == 12
    np.testing.assert_array_equal(res["tokens"], own)
