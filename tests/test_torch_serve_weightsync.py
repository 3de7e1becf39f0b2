"""The port's ``serve --weight-sync`` hot swap on reduced gemma3-1b (the
counterpart of ``tests/test_system.py::test_serve_hot_swaps_published_
weights``): a publisher commits params from another seed, and a serving
run subscribed to its store must report the flipped step, produce other
tokens than the run without sync, produce exactly the tokens of a direct
loop that prefills with the run's own params and decodes with the
published ones, and leave the served params bit-equal to the published
set. A JAX-published set swaps in the same way; a set that misses a leaf
holds the served params."""
import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.core.weightsync import WeightPublisher as JPublisher
from repro.models import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import storage as tstorage
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.core.weightsync import WeightPublisher, assert_bitexact
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.train.steps import make_serve_fns

ARCH = "gemma3-1b"
SERVE = dict(n_requests=3, prompt_len=8, gen_len=12, ckpt_every=0, seed=13)


@pytest.fixture(autouse=True)
def private_store(monkeypatch):
    """The launcher's store under the test's workdir (the default fast
    tier is shared per process under /dev/shm)."""
    monkeypatch.setattr(tserve, "default_store",
                        partial(tstorage.default_store, burst_buffer=False))


def _serve(tmp_path, name, **kw):
    return tserve.run(ARCH, workdir=str(tmp_path / name), device="cpu",
                      **SERVE, **kw)


def _publish_port(root, params):
    mgr = CheckpointManager(TieredStore(Tier("fast", root)),
                            CheckpointPolicy(mode="incremental"),
                            device="cpu")
    WeightPublisher(mgr)
    mgr.save({"params": params}, 0, blocking=True)
    mgr.wait()
    mgr.close()


def _direct_loop(published):
    """Prefill with the run's initial params, decode with `published`."""
    model = Model(reduced(get_config(ARCH)))
    prefill_fn, decode_fn, _ = make_serve_fns(model)
    n, p, g = SERVE["n_requests"], SERVE["prompt_len"], SERVE["gen_len"]
    prompts = np.random.default_rng(SERVE["seed"]).integers(
        0, model.cfg.vocab_size, (n, p), dtype=np.int32)
    init = model.init(seed=SERVE["seed"], device="cpu")
    tok, cache = prefill_fn(init, torch.from_numpy(prompts), cache_len=p + g)
    out = np.full((n, g), -1, np.int32)
    out[:, 0] = tok.numpy()
    for c in range(1, g):
        tok, cache = decode_fn(published, cache,
                               torch.from_numpy(out[:, c - 1]))
        out[:, c] = tok.numpy()
    return out


def _served(rep) -> dict:
    return dict(leaf_paths({"params": rep["params"]}))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The run without sync (module-scoped: the autouse store patch is
    function-scoped, so it is applied here by hand)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tserve, "default_store",
               partial(tstorage.default_store, burst_buffer=False))
    try:
        rep = tserve.run(ARCH, workdir=str(tmp_path_factory.mktemp("base")),
                         device="cpu", **SERVE)
    finally:
        mp.undo()
    assert rep["status"] == "completed" and "weight_sync_step" not in rep
    return rep


def test_serve_hot_swaps_port_published_weights(tmp_path, base):
    published = Model(reduced(get_config(ARCH))).init(seed=99, device="cpu")
    _publish_port(tmp_path / "trainer", published)
    swapped = _serve(tmp_path, "swap", weight_sync=tmp_path / "trainer")
    assert swapped["status"] == "completed"
    assert swapped["weight_sync_step"] == 0
    assert not np.array_equal(swapped["tokens"], base["tokens"])
    np.testing.assert_array_equal(swapped["tokens"], _direct_loop(published))
    assert_bitexact(_served(swapped), {"params": published})
    ws = swapped["weight_sync"]
    assert ws["polls"] == SERVE["gen_len"] - 1 and ws["swaps"] == 1
    assert 0 < ws["flip_sync_s"] <= ws["sync_s"] and ws["swap_s"] > 0
    # the subscriber published its status back to the source, and closed
    status = json.loads((tmp_path / "trainer" / "_WS" / "subscribers" /
                         f"serve-{ARCH}.json").read_text())
    assert status["state"] == "live" and status["last_flipped_step"] == 0


def test_serve_hot_swaps_jax_published_weights(tmp_path, base):
    jparams = JModel(jreduced(jget_config(ARCH))).init(jax.random.PRNGKey(99))
    mgr = JManager(JStore(JTier("fast", tmp_path / "trainer")),
                   policy=JPolicy(mode="incremental"))
    JPublisher(mgr)
    mgr.save({"params": jparams}, 0, blocking=True)
    mgr.wait()
    mgr.close()
    published = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    swapped = _serve(tmp_path, "swap", weight_sync=tmp_path / "trainer",
                     weight_sync_name="edge-1")
    assert swapped["weight_sync_step"] == 0
    assert not np.array_equal(swapped["tokens"], base["tokens"])
    np.testing.assert_array_equal(swapped["tokens"], _direct_loop(published))
    assert_bitexact(_served(swapped), {"params": published})
    assert (tmp_path / "trainer" / "_WS" / "subscribers" /
            "edge-1.json").is_file()


def test_set_missing_a_leaf_holds_served_params(tmp_path, base):
    published = Model(reduced(get_config(ARCH))).init(seed=99, device="cpu")
    published.pop("final_norm")
    _publish_port(tmp_path / "trainer", published)
    held = _serve(tmp_path, "held", weight_sync=tmp_path / "trainer")
    assert held["status"] == "completed"
    assert held["weight_sync_step"] is None
    assert held["weight_sync"]["swaps"] == 0
    np.testing.assert_array_equal(held["tokens"], base["tokens"])


def test_cli_weight_sync_flag(tmp_path, capsys):
    published = Model(reduced(get_config(ARCH))).init(seed=99, device="cpu")
    _publish_port(tmp_path / "trainer", published)
    assert tserve.main(["--arch", ARCH, "--requests", "2", "--prompt-len",
                        "4", "--gen-len", "4", "--ckpt-every", "0",
                        "--workdir", str(tmp_path / "w"), "--device", "cpu",
                        "--weight-sync", str(tmp_path / "trainer")]) == 0
    out = capsys.readouterr().out
    assert "'weight_sync_step': 0" in out and "'params'" not in out
