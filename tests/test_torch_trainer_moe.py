"""The port's Trainer on a MoE config with Adafactor, on the CPU, held
against the JAX package at the reduced llama4-scout-17b-a16e (f32, d 64,
8 experts of 64, top-1 plus a shared expert, vocab 128): a preempt and a
resume under the checkpoint round's policy to the uninterrupted run's
``params_digest`` (the aux metrics in the history, the Adafactor state
restored whole); a JAX ``Trainer`` checkpoint resumed by the port; and, for
one state (the JAX Trainer's after four steps), the port's manifests and
CAS objects equal the JAX package's byte for byte, each package restoring
the other's checkpoint bit for bit. The kernel wrappers take their plain
versions (the tensors lie on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import policy as jpolicy
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_state, to_numpy_state
from repro_torch.core import policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.preempt import PreemptionGuard
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.train.loop import Trainer, TrainerConfig

ARCH = "llama4-scout-17b-a16e"
CFG = reduced(get_config(ARCH))
JCFG = jreduced(jget_config(ARCH))
# the checkpoint round's policy, as TrainerConfig fields
POL = dict(ckpt_mode="incremental", chunking="cdc", chunk_size=4096,
           codec="raw", params_codec="byteplane-rle", io_threads=4)
AUX = ("load_balance_loss", "router_z_loss", "drop_fraction")


def _trainer(path, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("seq_len", 32)
    kw.setdefault("log_every", 1)
    return Trainer(CFG, TrainerConfig(workdir=str(path), **kw),
                   device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" or \
        str(a.dtype) == "bfloat16" else a


def test_preempt_and_resume_with_adafactor(tmp_path):
    tA = _trainer(tmp_path / "a", ckpt_every=100, seed=7, **POL)
    tA.init_or_restore()
    assert set(tA.state["opt"]) == {"f", "count"}
    tA.fit(4)
    for h in tA.history:
        assert all(k in h for k in AUX), h
    assert all(np.isfinite(h["loss"]) for h in tA.history)
    tB = _trainer(tmp_path / "b", ckpt_every=2, seed=7, **POL)
    tB.init_or_restore()
    with PreemptionGuard() as guard:
        tB.fit(4, guard=guard, stop_after=3)
        guard.request()
        assert tB.fit(4, guard=guard)["status"] == "preempted"
    saved = to_numpy_state(tB.state)
    tC = _trainer(tmp_path / "b", ckpt_every=2, seed=7, **POL)
    tC.init_or_restore()
    assert tC.restored_from == 3
    got = dict(leaf_paths(to_numpy_state(tC.state)))
    for name, a in leaf_paths(saved):
        np.testing.assert_array_equal(_bits(got[name]), _bits(a),
                                      err_msg=name)
    tC.fit(4)
    assert tC.params_digest() == tA.params_digest()
    assert [h["loss"] for h in tC.history] == \
        [h["loss"] for h in tA.history][3:]
    assert [h["drop_fraction"] for h in tC.history] == \
        [h["drop_fraction"] for h in tA.history][3:]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer's four steps of reduced llama4-scout with Adafactor,
    checkpointed at step 4 under the checkpoint round's policy."""
    root = tmp_path_factory.mktemp("jax_moe")
    kw = dict(batch=4, seq_len=32, ckpt_every=4, log_every=100, seed=3,
              **POL)
    jt = JTrainer(JCFG, JTrainerConfig(workdir=str(root / "run"), **kw))
    jt.init_or_restore()
    jt.fit(4)
    state = jax.tree.map(np.asarray, jt.state)
    jt.manager.close()
    return root, kw, state


def test_port_resumes_jax_trainer_checkpoint(jax_run):
    root, kw, _ = jax_run
    jr = JTrainer(JCFG, JTrainerConfig(workdir=str(root / "run"), **kw))
    jr.init_or_restore()
    assert jr.restored_from == 4
    t = Trainer(CFG, TrainerConfig(workdir=str(root / "run"), **kw),
                device="cpu")
    t.init_or_restore()
    assert t.restored_from == 4
    assert t.data_state.to_json() == jr.data_state.to_json()
    assert t.params_digest() == jr.params_digest()
    ref = dict(jleaf_paths(jax.tree.map(np.asarray, jr.state)))
    for name, a in leaf_paths(to_numpy_state(t.state)):
        np.testing.assert_array_equal(_bits(a), _bits(ref[name]),
                                      err_msg=name)
    jr.manager.close()
    out = t.fit(6)
    assert out["status"] == "completed" and out["step"] == 6
    t.manager.close()


def _policy(mod):
    return mod.CheckpointPolicy(
        mode="incremental",
        chunking=mod.ChunkingPolicy(scheme="cdc", chunk_size=4096),
        pipeline=mod.PipelinePolicy(io_threads=8),
        durability=mod.DurabilityPolicy(keepalive_s=60.0),
        codec=mod.CodecPolicy(codec="raw", params_codec="byteplane-rle"))


def test_manifests_objects_and_restores_match_jax(jax_run, tmp_path):
    _, _, state = jax_run
    jmgr = JManager(JStore(JTier("fast", tmp_path / "jax")),
                    policy=_policy(jpolicy))
    tmgr = CheckpointManager(TieredStore(Tier("fast", tmp_path / "port")),
                             _policy(tpolicy), device="cpu")
    jrep = jmgr.save(jax.tree.map(jnp.asarray, state), 4)
    tstate = from_jax_state(state, "cpu")
    trep = tmgr.save(tstate, 4)
    jm, tm = jmgr.load_manifest(4), tmgr.load_manifest(4)
    assert tm["leaves"] == jm["leaves"]
    assert tmgr.chunks.digests_on_disk() == jmgr.chunks.digests_on_disk()
    assert trep["new_object_bytes"] == jrep["new_object_bytes"]
    names = set(tm["leaves"])
    assert "params/stage_0/b0/moe/router" in names
    assert "opt/f/stage_0/b0/moe/wg/v_row" in names
    assert tm["leaves"]["params/stage_0/b0/moe/router"]["shards"][0][
        "dtype"] == "float32"
    # each package restores the other's checkpoint bit for bit
    ref = dict(jleaf_paths(state))
    got, _ = CheckpointManager(TieredStore(Tier("fast", tmp_path / "jax")),
                               _policy(tpolicy), device="cpu").restore(
        tstate, step=4)
    for name, a in leaf_paths(to_numpy_state(got)):
        np.testing.assert_array_equal(_bits(a), _bits(ref[name]),
                                      err_msg=name)
    jgot, _ = JManager(JStore(JTier("fast", tmp_path / "port")),
                       policy=_policy(jpolicy)).restore(
        jax.tree.map(jnp.asarray, state), step=4)
    for name, a in jleaf_paths(jgot):
        np.testing.assert_array_equal(_bits(a), _bits(ref[name]),
                                      err_msg=name)
    jmgr.close()
    tmgr.close()
