"""The port's checkpoint inspector (``repro_torch.launch.inspect_ckpt``):
``tests/test_inspector_chaos.py`` on the port's manager and inspector
(the chaos drill on reduced gemma3-1b, the arch the port registers), then
the two inspectors on the same directories — a healthy, an in-flight, a
chunked, a v6-policy and a damaged checkpoint written by EACH package:
``inspect(..., verify=True)`` and ``main([... "--verify", "--json"])``
must give the reference's report and exit code. The in-flight rounds'
``age_s`` is the one time-dependent field; it is compared only for being
set or not."""
import json
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_ckpt_policy
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.launch import inspect_ckpt as jinspect_mod
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_state
from repro_torch.core import atomic, cas
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.errors import AbortedError
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.launch import inspect_ckpt as inspect_mod
from repro_torch.launch.inspect_ckpt import inspect
from repro_torch.train.loop import Trainer, TrainerConfig

QUIET = dict(out=lambda *a: None)
W = np.random.default_rng(0).standard_normal((32, 16), dtype=np.float32)


def _state(w=W):
    return from_jax_state({"params": {"w": w},
                           "step": np.asarray(1, np.int32)}, device="cpu")


def _mgr(root, **flat):
    flat.setdefault("keepalive_s", 60.0)
    return CheckpointManager(TieredStore(Tier("f", root)),
                             CheckpointPolicy().with_overrides(**flat),
                             device="cpu")


def _lines(into):
    return dict(out=lambda *a: into.append(" ".join(str(x) for x in a)))


# ---------------------------------------------------------------------------
# tests/test_inspector_chaos.py on the port
# ---------------------------------------------------------------------------

def test_inspector_reports_healthy_checkpoint(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, replicas=2)
    mgr.save(_state(), 3, extra={"arch": "x", "config_digest": "abc"})
    rep = inspect(mgr.store.root, verify=True, **QUIET)
    assert rep["ok"] and rep["shards_bad"] == 0
    assert rep["latest"] == 3 and rep["steps"] == [3]


def test_inspector_shows_in_flight_round_with_age_and_step(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2)
    mgr.save(_state(), 1)
    stage = atomic.staging_dir(mgr.store.root, 2)
    stage.mkdir(parents=True)
    atomic.mark_pending(stage, {"step": 2, "t": time.time()})
    lines = []
    rep = inspect(mgr.store.root, **_lines(lines))
    assert rep["pending_rounds"][0]["step"] == 2
    assert rep["pending_rounds"][0]["age_s"] is not None
    assert rep["pending_rounds"][0]["age_s"] < 60
    assert any("in-flight round: step 2" in ln for ln in lines)
    bare = mgr.store.root / "step_00000003.tmp-deadbeef"
    bare.mkdir()
    rep2 = inspect(mgr.store.root, **QUIET)
    kinds = {(r["step"], r["age_s"] is None) for r in rep2["pending_rounds"]}
    assert (2, False) in kinds and (None, True) in kinds


def test_inspector_detects_corruption_and_replica_recovery(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, replicas=2)
    mgr.save(_state(), 3)
    prim = next(p for p in mgr.store.root.rglob("shard-*.bin")
                if not p.name.endswith(".r1"))
    data = bytearray(prim.read_bytes())
    data[-1] ^= 0xFF
    prim.write_bytes(bytes(data))
    rep = inspect(mgr.store.root, verify=True, **QUIET)
    assert rep["shards_bad"] == 0
    assert any("Corrupt" in p or "crc" in p.lower() for p in rep["problems"])
    mgr2 = _mgr(tmp_path / "n", n_writers=2, replicas=1)
    mgr2.save(_state(), 3)
    prim = next(iter(mgr2.store.root.rglob("shard-00000.bin")))
    prim.write_bytes(b"garbage")
    rep2 = inspect(mgr2.store.root, verify=True, **QUIET)
    assert not rep2["ok"] and rep2["shards_bad"] >= 1


def test_inspector_reports_chunked_checkpoint_and_dedup(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunk_size=512)
    state = _state()
    mgr.save(state, 1)
    mgr.save(state, 2)
    rep = inspect(mgr.store.root, verify=True, **QUIET)
    assert rep["ok"] and rep["shards_bad"] == 0
    assert rep["mode"] == "incremental"
    assert rep["dedup"]["chunks"] > 0
    assert rep["cas"]["orphans"] == 0 and rep["cas"]["missing"] == 0
    assert rep["cas"]["ref_drift"] == 0
    assert rep["cas"]["references"] == 2 * rep["cas"]["objects"]
    hist = rep["chunk_hist"]["fixed"]
    assert hist["p50"] <= 512 and hist["chunks"] > 0
    assert hist["configured"] == {"size": 512}


def test_inspector_chunk_histogram_vs_cdc_bounds(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunking="cdc", chunk_size=512)
    w = np.random.default_rng(1).standard_normal((128, 128), np.float32)
    mgr.save(from_jax_state({"params": {"w": w}}, device="cpu"), 1)
    lines = []
    rep = inspect(mgr.store.root, **_lines(lines))
    hist = rep["chunk_hist"]["cdc"]
    assert hist["configured"] == {"min": mgr._chunker.min_size,
                                  "avg": mgr._chunker.avg_size,
                                  "max": mgr._chunker.max_size}
    assert mgr._chunker.min_size <= hist["p50"] <= mgr._chunker.max_size
    assert hist["p10"] <= hist["p50"] <= hist["p90"]
    assert any("cdc chunk sizes:" in ln for ln in lines)


def test_inspector_prints_v6_policy_block(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunking="cdc", chunk_size=1024, io_threads=4,
               persist_queue_depth=2)
    mgr.save(_state(), 1)
    lines = []
    rep = inspect(mgr.store.root, **_lines(lines))
    assert rep["ok"]
    assert rep["policy"]["chunking"]["scheme"] == "cdc"
    assert rep["policy"]["pipeline"]["persist_queue_depth"] == 2
    assert any("policy: mode=incremental" in ln for ln in lines)
    assert any("chunking=cdc@1K" in ln and "persist_queue=2" in ln
               for ln in lines)


def test_inspector_policy_not_recorded_for_old_manifests(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunk_size=512)
    mgr.save(_state(), 1)
    mpath = mgr.store.root / "step_00000001" / atomic.MANIFEST
    m = json.loads(mpath.read_text())
    m["format"] = 5
    m.pop("policy")
    mpath.write_text(json.dumps(m))
    lines = []
    rep = inspect(mgr.store.root, **_lines(lines))
    assert rep["ok"]
    assert "policy" not in rep
    assert any("policy: not recorded (v≤5)" in ln for ln in lines)


def test_inspector_corrupted_policy_block_warns_not_crashes(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunk_size=512)
    mgr.save(_state(), 1)
    mpath = mgr.store.root / "step_00000001" / atomic.MANIFEST
    for garbage in ({"mode": "bogus"}, [1, 2, 3], "zzz",
                    {"chunking": {"chunk_size": -5}}, None):
        m = json.loads(mpath.read_text())
        m["policy"] = garbage
        mpath.write_text(json.dumps(m))
        lines = []
        rep = inspect(mgr.store.root, verify=True, **_lines(lines))
        assert rep["ok"] and rep["shards_bad"] == 0
        assert "policy_error" in rep
        assert any("policy block unreadable" in ln for ln in lines)


def test_verify_deep_pass_skips_step_covered_digests(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunk_size=512)
    mgr.save(_state(), 1)
    rep = inspect(mgr.store.root, verify=True, **QUIET)
    assert rep["ok"]
    assert rep["cas"]["deep_reads"] == 0
    mgr.save(_state(W + 1.0), 2)
    rep = inspect(mgr.store.root, step=2, verify=True, **QUIET)
    assert rep["ok"]
    assert 0 < rep["cas"]["deep_reads"] < rep["cas"]["objects"]
    m = mgr.load_manifest(2)
    digests = {d for rec in m["leaves"].values() for s in rec["shards"]
               for d in s.get("chunks", [])}
    victim = mgr.store.root / cas.object_rel(sorted(digests)[0])
    victim.write_bytes(b"\xff" * victim.stat().st_size)
    rep = inspect(mgr.store.root, step=2, verify=True, **QUIET)
    assert not rep["ok"] and rep["shards_bad"] >= 1


def test_inspector_flags_missing_chunk_and_orphans(tmp_path):
    mgr = _mgr(tmp_path, n_writers=2, mode="incremental", codec="raw",
               chunk_size=512)
    mgr.save(_state(), 1)
    objs = sorted(mgr.store.root.glob("_CAS/objects/*/*.obj"))
    objs[0].unlink()
    orphan = mgr.store.root / "_CAS/objects/zz" / ("f" * 32 + ".obj")
    orphan.parent.mkdir(parents=True, exist_ok=True)
    orphan.write_bytes(b"junk")
    rep = inspect(mgr.store.root, verify=True, **QUIET)
    assert not rep["ok"]
    assert rep["cas"]["missing"] == 1
    assert rep["cas"]["orphans"] == 1
    assert rep["shards_bad"] >= 1


def test_chaos_drill(tmp_path):
    """Random faults every round; after every event a committed
    checkpoint exists, the latest restores, and training continues from
    it (reduced gemma3-1b, the reference drill's protocol)."""
    cfg = reduced(get_config("gemma3-1b"))
    rng = random.Random(1234)
    tcfg = TrainerConfig(workdir=str(tmp_path), batch=2, seq_len=16,
                         ckpt_every=2, log_every=1000, seed=3,
                         replicas=2, n_writers=3)

    def trainer():
        return Trainer(cfg, tcfg, device="cpu").init_or_restore()

    t = trainer()
    t.fit(2)
    target = 2
    for _ in range(5):
        event = rng.choice(["rank_failure", "corrupt_primary",
                            "staging_litter", "none"])
        if event == "rank_failure":
            t.manager.coordinator.inject_failure(rng.randrange(3))
        elif event == "corrupt_primary":
            prims = [p for p in t.manager.store.root.rglob("shard-*.bin")
                     if not p.name.endswith(".r1")]
            if prims:
                rng.choice(prims).write_bytes(b"\x00" * 16)
        elif event == "staging_litter":
            d = t.manager.store.root / "step_99999999.tmp-dead"
            (d / "_META").mkdir(parents=True, exist_ok=True)
            (d / "_META" / "PENDING").write_text("{}")
        target += 2
        try:
            t.fit(target)
        except AbortedError:
            pass
        finally:
            t.manager.coordinator._inject_fail.clear()
        steps = atomic.list_committed_steps(t.manager.store.root)
        assert steps, "no committed checkpoint survived"
        t.manager.close()
        t2 = trainer()
        assert t2.restored_from == steps[-1]
        t2.fit(t2.py_step + 1, stop_after=1)
        t2.manager.close()
        t = trainer()
        target = t.py_step
    rep = inspect(t.manager.store.root, verify=True, **QUIET)
    t.manager.close()
    assert rep["steps"], rep


# ---------------------------------------------------------------------------
# the two inspectors on checkpoints written by each package
# ---------------------------------------------------------------------------

BF16 = np.asarray(jnp.asarray(W * 3, jnp.bfloat16))


def _np_state(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((32, 16), np.float32),
                       "emb": BF16},
            "opt": {"m": np.arange(512, dtype=np.float32).reshape(32, 16)},
            "step": np.asarray(seed, np.int32)}


class _Writer:
    def __init__(self, port: bool):
        self.port = port

    def mgr(self, root, **flat):
        if self.port:
            return _mgr(root, **flat)
        return JManager(JStore(JTier("f", root)),
                        policy=make_ckpt_policy(**flat))

    def state(self, seed=0):
        st = _np_state(seed)
        if self.port:
            return from_jax_state(st, device="cpu")
        return jax.tree.map(jnp.asarray, st)


def _healthy(w, root):
    w.mgr(root, n_writers=2, replicas=2).save(
        w.state(), 3, extra={"arch": "x", "config_digest": "abc"})


def _in_flight(w, root):
    w.mgr(root, n_writers=2).save(w.state(), 1)
    stage = atomic.staging_dir(root, 2)
    stage.mkdir(parents=True)
    atomic.mark_pending(stage, {"step": 2, "t": time.time()})
    (root / "step_00000003.tmp-deadbeef").mkdir()


def _chunked(w, root):
    mgr = w.mgr(root, n_writers=2, mode="incremental", codec="raw",
                params_codec="byteplane-rle", chunking="cdc",
                chunk_size=256)
    mgr.save(w.state(0), 1)
    mgr.save(w.state(1), 2)


def _v6_policy(w, root):
    w.mgr(root, n_writers=2, mode="incremental", codec="raw",
          chunking="cdc", chunk_size=1024, io_threads=4,
          persist_queue_depth=2).save(w.state(), 1)


def _damaged(w, root):
    mgr = w.mgr(root, n_writers=2, mode="incremental", codec="raw",
                chunk_size=512)
    mgr.save(w.state(0), 1)
    mgr.save(w.state(1), 2)
    objs = sorted(root.glob("_CAS/objects/*/*.obj"))
    objs[0].unlink()
    victim = objs[-1]
    victim.write_bytes(b"\xff" * victim.stat().st_size)
    orphan = root / "_CAS/objects/zz" / ("f" * 32 + ".obj")
    orphan.parent.mkdir(parents=True, exist_ok=True)
    orphan.write_bytes(b"junk")


KINDS = {"healthy": _healthy, "in_flight": _in_flight, "chunked": _chunked,
         "v6_policy": _v6_policy, "damaged": _damaged}


def _timeless(rep: dict) -> dict:
    """The report without its time-dependent field: ``age_s`` of each
    in-flight round becomes whether it is known."""
    rep = json.loads(json.dumps(rep, default=str))
    for r in rep.get("pending_rounds", []):
        r["age_s"] = r["age_s"] is not None
    return rep


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_reports_equal_the_reference(tmp_path, capsys, kind, writer):
    root = tmp_path / "ckpt"
    KINDS[kind](_Writer(writer == "port"), root)
    got = inspect_mod.inspect(root, verify=True, **QUIET)
    want = jinspect_mod.inspect(root, verify=True, **QUIET)
    assert _timeless(got) == _timeless(want)
    assert got["ok"] == (kind != "damaged")
    if kind in ("chunked", "damaged"):
        got1 = inspect_mod.inspect(root, step=1, verify=True, **QUIET)
        want1 = jinspect_mod.inspect(root, step=1, verify=True, **QUIET)
        assert _timeless(got1) == _timeless(want1)
    argv = [str(root), "--verify", "--json"]
    rc, out = _cli(inspect_mod, argv, capsys)
    jrc, jout = _cli(jinspect_mod, argv, capsys)
    assert rc == jrc == (1 if kind == "damaged" else 0)
    assert _timeless(out) == _timeless(jout)
    argv = [str(root), "--health", "--subscribers", "--json"]
    assert _cli(inspect_mod, argv, capsys) == _cli(jinspect_mod, argv, capsys)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scrub_reports_equal_the_reference(tmp_path, capsys, writer):
    """``--scrub`` heals the same damage to the same report whichever
    package wrote the store and whichever package scrubs it."""
    reps = {}
    for scrubber, mod in (("port", inspect_mod), ("jax", jinspect_mod)):
        root = tmp_path / scrubber / "fast"
        slow = tmp_path / scrubber / "slow"
        w = _Writer(writer == "port")
        mgr = w.mgr(root, n_writers=2, mode="incremental", codec="raw",
                    chunk_size=512)
        mgr.save(w.state(0), 1)
        mgr.close()
        objs = sorted(root.glob("_CAS/objects/*/*.obj"))
        slow_obj = slow / objs[0].relative_to(root)
        slow_obj.parent.mkdir(parents=True)
        slow_obj.write_bytes(objs[0].read_bytes())
        raw = bytearray(objs[0].read_bytes())
        raw[0] ^= 0x01
        objs[0].write_bytes(bytes(raw))
        argv = [str(root), "--slow-root", str(slow), "--json"]
        assert mod.main(argv + ["--verify"]) == 1
        capsys.readouterr()
        rc, out = _cli(mod, argv + ["--scrub"], capsys)
        assert rc == 0 and out["scrub"]["healed"] == 1
        assert mod.main(argv + ["--verify"]) == 0
        capsys.readouterr()
        reps[scrubber] = out
    assert reps["port"] == reps["jax"]
