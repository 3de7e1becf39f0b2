"""The port's twins of three examples on the CPU — ``examples/
torch_quickstart.py``, ``torch_preempt_and_resume.py`` and
``torch_serve_with_cr.py`` — each run once through ``main(device="cpu")``
in a module fixture, with its original's assertions, and held against the
JAX package:

- quickstart: the JAX Trainer restores the twin's C/R workdir at step 20,
  with the twin's ``params_digest()``;
- preempt_and_resume: preempted at step 12, restored from 12, completed at
  30, as ``examples/preempt_and_resume.py`` prints; the JAX Trainer
  restores step 30 with the twin's digest;
- serve_with_cr: ``repro.launch.serve.run`` with the same arguments
  resumes the twin's preempted workdir (token 9) to the twin's
  uninterrupted tokens. Its own uninterrupted run is not compared: the
  port's ``Model.init`` draws other weights from the seed than JAX's.

Two subprocess checks: the four twins import neither ``jax`` nor
``repro``, and a twin run with no ``--device`` on a machine without a card
fails with ``resolve_device``'s error. The 8-rank elastic twin is in
``test_torch_example_elastic.py``. ~45 s alone at ``-n 6 --dist
loadfile``."""
import importlib.util
import os
import subprocess
import sys
import tempfile
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import reduced as jreduced
from repro.core import storage as jstorage
from repro.launch import serve as jserve
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.core import storage as tstorage
from repro_torch.launch import serve as tserve

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "preempt_and_resume", "serve_with_cr",
         "elastic_rescale")
SERVE = dict(n_requests=4, prompt_len=16, gen_len=24, ckpt_every=0, seed=7)


def load_twin(name: str):
    """``examples/torch_<name>.py`` as a module."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_twin(name: str, tmp: Path, *, private_stores: bool = False) -> dict:
    """``main(device="cpu")`` of a twin, its temp dirs under `tmp`; with
    `private_stores`, both serving launchers' fast tiers under the workdir
    (the default one is shared per process under /dev/shm, where one run's
    checkpoint would become the next run's resume point)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp))
        if private_stores:
            mp.setattr(jserve, "default_store",
                       partial(jstorage.default_store, burst_buffer=False))
            mp.setattr(tserve, "default_store",
                       partial(tstorage.default_store, burst_buffer=False))
        return load_twin(name).main(device="cpu")


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    return run_twin("quickstart", tmp_path_factory.mktemp("quickstart"))


@pytest.fixture(scope="module")
def preempt(tmp_path_factory):
    return run_twin("preempt_and_resume", tmp_path_factory.mktemp("preempt"))


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    return run_twin("serve_with_cr", tmp_path_factory.mktemp("serve"),
                    private_stores=True)


def _jax_restore(arch: str, workdir: str, **kw):
    t = JTrainer(jreduced(JCONFIGS[arch]), JTrainerConfig(workdir=workdir,
                                                          **kw))
    t.init_or_restore()
    out = (t.restored_from, t.params_digest())
    t.manager.close()
    return out


def test_quickstart_resume_is_bit_exact(quickstart):
    assert quickstart["digest"] == quickstart["ref_digest"]
    assert quickstart["restored_from"] == 10 and quickstart["step"] == 20
    assert quickstart["last_report"]["step"] == 20
    assert quickstart["check"] == {"ok": True, "digests_equal": True,
                                   "restored_from": 10, "step": 20}


def test_jax_trainer_restores_the_quickstart_checkpoint(quickstart):
    step, digest = _jax_restore(
        "gemma3-1b", quickstart["workdir"] + "/cr", batch=4, seq_len=64,
        ckpt_every=5, seed=42, log_every=5)
    assert step == 20
    assert digest == quickstart["digest"]


def test_preempt_twin_stops_at_12_and_completes_at_30(preempt):
    # examples/preempt_and_resume.py prints "job exited: preempted at step
    # 12", "restored from step 12", "finished: completed at step 30"
    assert tuple(preempt["preempted"]) == ("preempted", 12)
    assert preempt["restored_from"] == 12
    assert tuple(preempt["completed"]) == ("completed", 30)
    assert preempt["ckpt_metrics"]["commits"] == 1
    check = preempt["check"]
    assert check["ok"] and check["restored_from"] == 12
    assert (tuple(check["preempted"]), tuple(check["completed"])) == \
        (("preempted", 12), ("completed", 30))


def test_jax_trainer_restores_the_preempt_twins_last_step(preempt):
    step, digest = _jax_restore(
        "starcoder2-3b", preempt["workdir"], batch=4, seq_len=64,
        ckpt_every=50, seed=1, log_every=5)
    assert step == 30
    assert digest == preempt["digest"]


def test_serve_twin_resumes_token_exact(serving):
    full, pre, res = serving["full"], serving["preempted"], \
        serving["resumed"]
    assert full["status"] == res["status"] == "completed"
    assert pre["status"] == "preempted" and pre["cursor"] == 9
    np.testing.assert_array_equal(pre["tokens"][:, :9], full["tokens"][:, :9])
    np.testing.assert_array_equal(res["tokens"], full["tokens"])
    assert full["tokens"].shape == (4, 24)
    check = serving["check"]
    assert check["ok"] and check["tokens_equal"]
    assert check["preempted_at"] == 9


def test_jax_serving_resumes_the_serve_twins_checkpoint(serving,
                                                        monkeypatch):
    """The JAX launcher, with the twin's arguments, resumes the twin's
    preempted workdir (token 9: the twin's params, KV cache, tokens and
    cursor) to the twin's uninterrupted tokens. (Its own uninterrupted run
    decodes other tokens: each package's ``init`` draws its own weights
    from the seed.)"""
    monkeypatch.setattr(jserve, "default_store",
                        partial(jstorage.default_store, burst_buffer=False))
    resumed = jserve.run("stablelm-1.6b", workdir=serving["workdir"] + "/cr",
                         **SERVE)
    assert resumed["status"] == "completed"
    np.testing.assert_array_equal(resumed["tokens"],
                                  serving["full"]["tokens"])


def test_twins_import_neither_jax_nor_repro():
    code = ("import importlib.util, sys\n"
            f"for name in {TWINS!r}:\n"
            f"    path = {str(ROOT / 'examples')!r} + f'/torch_{{name}}.py'\n"
            "    spec = importlib.util.spec_from_file_location(name, path)\n"
            "    spec.loader.exec_module("
            "importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the no-card error; this machine has a card")
@pytest.mark.parametrize("name", TWINS)
def test_twin_without_a_card_fails(name, tmp_path):
    """No ``--device``: the card is asked for, and without one the twin
    exits non-zero with ``resolve_device``'s error before it runs."""
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not list(tmp_path.iterdir())
