"""The port's Trainer on the CPU, held against the JAX package's at the
reduced gemma3-1b (f32, vocab 128, window 16): the ports of
``test_train_integration.py`` (bit-exact resume, preempt and resume, async
checkpoints, streaming-restore resume, data-state restore), a preempt and
resume under the checkpoint round's policy through the device decode
route, a JAX ``Trainer`` checkpoint resumed by the port's to the same
``params_digest``, and the launcher. The kernel wrappers take their plain
versions (the tensors lie on the CPU)."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core.preempt import PreemptionGuard
from repro_torch.train.loop import Trainer, TrainerConfig

ARCH = "gemma3-1b"
CFG = reduced(get_config(ARCH))
JCFG = jreduced(jget_config(ARCH))
ROOT = Path(__file__).resolve().parents[1]


def _tcfg(tmp_path, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("seq_len", 32)
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("log_every", 100)
    return TrainerConfig(workdir=str(tmp_path / "run"), **kw)


def _trainer(tmp_path, **kw):
    return Trainer(CFG, _tcfg(tmp_path, **kw), device="cpu")


# ---------------------------------------------------------------------------
# the Trainer: ports of test_train_integration.py
# ---------------------------------------------------------------------------

def test_bit_exact_resume(tmp_path):
    """train N straight == train N/2 + ckpt + kill + restore + N/2."""
    tA = _trainer(tmp_path / "a", ckpt_every=100, seed=5)
    tA.init_or_restore()
    tA.fit(8)
    dA = tA.params_digest()
    tB = _trainer(tmp_path / "b", ckpt_every=4, async_ckpt=True, seed=5)
    tB.init_or_restore()
    tB.fit(8, stop_after=4)
    del tB  # "node failure"
    tB2 = _trainer(tmp_path / "b", ckpt_every=4, seed=5)
    tB2.init_or_restore()
    assert tB2.restored_from == 4
    tB2.fit(8)
    assert tB2.params_digest() == dA


def test_preemption_checkpoint_and_resume(tmp_path):
    t = _trainer(tmp_path, ckpt_every=100, seed=1)
    t.init_or_restore()
    with PreemptionGuard() as guard:
        t.fit(6, guard=guard, stop_after=2)
        guard.request()                    # SIGTERM analogue
        rep = t.fit(6, guard=guard)
    assert rep["status"] == "preempted"
    assert t.manager.latest_step() == rep["step"] == 2
    t2 = _trainer(tmp_path, ckpt_every=100, seed=1)
    t2.init_or_restore()
    assert t2.restored_from == rep["step"]
    out = t2.fit(6)
    assert out["status"] == "completed" and out["step"] == 6


def test_async_checkpoint_drains_and_is_valid(tmp_path):
    t = _trainer(tmp_path, ckpt_every=2, async_ckpt=True, seed=2)
    t.init_or_restore()
    t.fit(6)
    assert t.manager.counters.drained()    # sent == received (P4)
    assert t.manager.latest_step() == 6
    t2 = _trainer(tmp_path, seed=2)
    t2.init_or_restore()
    assert t2.params_digest() == t.params_digest()


def test_streaming_restore_bit_exact_resume(tmp_path):
    tA = _trainer(tmp_path / "a", ckpt_every=100, seed=5)
    tA.init_or_restore()
    tA.fit(8)
    dA = tA.params_digest()
    tB = _trainer(tmp_path / "b", ckpt_every=4, seed=5)
    tB.init_or_restore()
    tB.fit(8, stop_after=4)
    del tB
    tB2 = _trainer(tmp_path / "b", ckpt_every=4, seed=5,
                   streaming_restore=True)
    tB2.init_or_restore()
    assert tB2.restored_from == 4
    assert tB2._restore_stream is not None     # tail still streaming
    assert tB2.state is None                   # fit() crosses the gate
    out = tB2.fit(8)
    assert out["status"] == "completed" and out["step"] == 8
    assert tB2.params_digest() == dA


def test_trainer_restores_data_state(tmp_path):
    t = _trainer(tmp_path, ckpt_every=3, seed=4)
    t.init_or_restore()
    t.fit(3)
    counts = t.data_state.source_counts
    t2 = _trainer(tmp_path, seed=4)
    t2.init_or_restore()
    assert t2.data_state.step == 3
    assert t2.data_state.source_counts == counts


def test_preempt_resume_through_device_decode_routes(tmp_path):
    """The checkpoint round's policy (incremental CDC, byteplane-rle
    params): the resume restores every params leaf through the K4 route
    (its plain version here) and ends bit-exact with the straight run."""
    pol = dict(ckpt_mode="incremental", chunking="cdc", chunk_size=4096,
               codec="raw", params_codec="byteplane-rle", io_threads=4)
    tA = _trainer(tmp_path / "a", ckpt_every=100, seed=7, log_every=1,
                  **pol)
    tA.init_or_restore()
    tA.fit(4, stop_after=4)
    tB = _trainer(tmp_path / "b", ckpt_every=2, seed=7, **pol)
    tB.init_or_restore()
    with PreemptionGuard() as guard:
        tB.fit(4, guard=guard, stop_after=3)
        guard.request()
        assert tB.fit(4, guard=guard)["status"] == "preempted"
    tC = _trainer(tmp_path / "b", ckpt_every=2, seed=7, log_every=1, **pol)
    assert tC.manager._restore.device_decode
    tC.init_or_restore()
    assert tC.restored_from == 3
    tC.fit(4)
    assert tC.params_digest() == tA.params_digest()
    assert [h["loss"] for h in tC.history] == \
        [h["loss"] for h in tA.history][3:]


# ---------------------------------------------------------------------------
# across the packages, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pol", [
    {},                                             # full mode, default codec
    dict(ckpt_mode="incremental", chunking="cdc", chunk_size=4096,
         codec="raw", params_codec="byteplane-rle"),
    dict(ckpt_mode="incremental", codec="raw", params_codec="int8"),
], ids=["full", "cdc-byteplane-rle", "int8"])
def test_port_resumes_jax_trainer_checkpoint(tmp_path, pol):
    """A JAX Trainer checkpoint restored by the port's Trainer (through the
    device decode routes' plain versions) gives the params_digest of the
    same checkpoint restored by the JAX Trainer, and the run goes on."""
    kw = dict(batch=4, seq_len=32, ckpt_every=4, log_every=100, seed=3,
              **pol)
    jt = JTrainer(JCFG, JTrainerConfig(workdir=str(tmp_path / "run"), **kw))
    jt.init_or_restore()
    jt.fit(4)
    jt.manager.close()
    jr = JTrainer(JCFG, JTrainerConfig(workdir=str(tmp_path / "run"), **kw))
    jr.init_or_restore()
    assert jr.restored_from == 4
    if pol.get("params_codec") != "int8":
        assert jr.params_digest() == jt.params_digest()
    t = Trainer(CFG, TrainerConfig(workdir=str(tmp_path / "run"), **kw),
                device="cpu")
    t.init_or_restore()
    assert t.restored_from == 4
    assert t.data_state.to_json() == jr.data_state.to_json()
    assert t.params_digest() == jr.params_digest()
    out = t.fit(6)
    assert out["status"] == "completed" and out["step"] == 6


def test_train_launcher_runs_and_resumes_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--steps", "4", "--ckpt-every", "2", "--batch", "2",
           "--seq-len", "24", "--workdir", str(tmp_path / "w"),
           "--device", "cpu", "--ckpt-mode", "incremental",
           "--params-codec", "int8"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    first = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "status=completed step=4" in first.stdout
    cmd[cmd.index("--steps") + 1] = "6"
    second = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "restored step 4" in second.stderr
    assert "status=completed step=6" in second.stdout
