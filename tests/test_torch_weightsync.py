"""WeightSync in the port (``repro_torch.core.weightsync``), held against
``tests/test_weightsync.py``: the announce at commit and a failing hook,
a sync bit-exact with ``restore``, the delta-only second sync, peer
fan-out, the subscriber's kill points, torn-set readers, faulted pulls,
the remote fault kinds, breaker-aware drains and the published status —
plus the two packages crossed: a port subscriber syncs from a JAX
publisher's store and a JAX subscriber from a port publisher, each set bit
for bit the other package's restore of that step. States are made from a
numpy seed; the shadow set holds host tensors (bf16 as ``torch.bfloat16``,
compared through an int16 view)."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.core.weightsync import WeightPublisher as JPublisher
from repro.core.weightsync import WeightSubscriber as JSubscriber
from repro_torch.convert import from_jax_state
from repro_torch.core import resilience
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.faults import FaultPlane, FaultyTier, wrap_store
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.storage import RemoteTier, Tier, TieredStore
from repro_torch.core.weightsync import (ANNOUNCE_REL, SUBSCRIBERS_DIR,
                                         WeightPublisher, WeightSubscriber,
                                         assert_bitexact, build_fleet)

FROZEN = np.random.default_rng(11).standard_normal((64, 8), dtype=np.float32)


def _np_state(step: int) -> dict:
    rng = np.random.default_rng(step)
    return {
        "params": {"emb": rng.standard_normal((48, 16), dtype=np.float32),
                   "w0": np.arange(4096, dtype=np.float32) + step,
                   "frozen": FROZEN.copy()},
        "opt": {"m": np.full((256,), float(step), np.float32)},
        "step": np.asarray(step, np.int32),
    }


def _state(step: int) -> dict:
    return from_jax_state(_np_state(step), device="cpu")


def _abstract(state):
    if isinstance(state, dict):
        return {k: _abstract(v) for k, v in state.items()}
    return torch.empty_like(state, device="meta")


def _policy(io_threads=2, **kw):
    return CheckpointPolicy().with_overrides(
        mode="incremental", chunk_size=2048, io_threads=io_threads,
        io_retries=2, io_backoff_ms=1.0, io_deadline_s=10.0,
        keepalive_s=60.0, **kw)


def _store(tmp_path):
    return TieredStore(Tier("fast", tmp_path / "fast"),
                       Tier("slow", tmp_path / "slow"))


def _mgr(store, io_threads=2):
    return CheckpointManager(store, _policy(io_threads), device="cpu")


def _params_filter(n):
    return n.startswith("params/")


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

def test_publisher_announces_at_commit(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    pub = WeightPublisher(mgr)
    mgr.save(_state(0), 0, blocking=True)
    mgr.wait()
    assert pub.last_announced_step == 0
    ann = json.loads(store.fast.read_file(ANNOUNCE_REL).decode())
    assert ann["step"] == 0 and ann["manifest"]["step"] == 0
    assert ann["step_dir"] == "step_00000000"
    assert (store.slow.root / ANNOUNCE_REL).exists()
    mgr.save(_state(1), 1, blocking=True)
    mgr.wait()
    ann = json.loads(store.fast.read_file(ANNOUNCE_REL).decode())
    assert ann["step"] == 1 and ann["seq"] == 2
    mgr.close()


def test_publisher_failure_never_aborts_save(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    pub = WeightPublisher(mgr)

    def boom(step, manifest):
        raise RuntimeError("announcement plane on fire")

    mgr.on_commit.insert(0, boom)
    mgr.save(_state(0), 0, blocking=True)       # must not raise
    mgr.wait()
    assert mgr.latest_step() == 0
    assert pub.last_announced_step == 0         # later hooks still ran
    mgr.close()


# ---------------------------------------------------------------------------
# subscriber: correctness + delta + fan-out
# ---------------------------------------------------------------------------

def test_sync_is_bitexact_with_restore(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    state = _state(0)
    mgr.save(state, 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "cache0", name="r0",
                           policy=_policy())
    st = sub.sync()
    assert st["state"] == "live" and st["last_flipped_step"] == 0
    step, arrays = sub.current()
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in arrays.values())
    restored, _ = mgr.restore(_abstract(state), step=0)
    assert_bitexact(arrays, restored)
    assert_bitexact(arrays, state)
    assert arrays["step"].shape == () and arrays["step"].dtype == torch.int32
    sub.close()
    mgr.close()


def test_assert_bitexact_rejects_one_flipped_bit_and_coverage():
    state = _state(0)
    arrays = {"params/" + k: v.clone() for k, v in state["params"].items()}
    assert_bitexact(arrays, state, leaf_filter=_params_filter)
    arrays["params/emb"].view(torch.int32)[3, 5] ^= 1
    with pytest.raises(AssertionError, match="payload bytes differ"):
        assert_bitexact(arrays, state, leaf_filter=_params_filter)
    with pytest.raises(AssertionError, match="leaf set mismatch"):
        assert_bitexact(arrays, state)
    arrays["params/emb"] = state["params"]["emb"].double()
    with pytest.raises(AssertionError, match="shape/dtype"):
        assert_bitexact(arrays, state, leaf_filter=_params_filter)


def test_second_sync_pulls_only_the_delta(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    s0 = _state(0)
    mgr.save(s0, 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "cache0", name="r0",
                           policy=_policy(), leaf_filter=_params_filter)
    sub.sync()
    full_wire = sub.counters["wire_bytes"]
    assert full_wire > 0
    s1 = {"params": {"emb": s0["params"]["emb"] + 1.0,
                     "w0": s0["params"]["w0"],
                     "frozen": s0["params"]["frozen"]},
          "opt": {"m": s0["opt"]["m"]},
          "step": torch.tensor(1, dtype=torch.int32)}
    mgr.save(s1, 1, blocking=True)
    mgr.wait()
    sub.sync()
    delta_wire = sub.counters["wire_bytes"] - full_wire
    assert 0 < delta_wire < full_wire / 2
    step, arrays = sub.current()
    assert step == 1
    assert_bitexact(arrays, s1, leaf_filter=_params_filter)
    before = sub.counters["wire_bytes"]
    sub.sync()
    assert sub.counters["wire_bytes"] == before
    sub.close()
    mgr.close()


def test_peer_fanout_spares_the_source(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    state = _state(0)
    mgr.save(state, 0, blocking=True)
    mgr.wait()
    fleet = build_fleet(store, tmp_path / "fleet", 4, fanout=3,
                        policy=_policy(), leaf_filter=_params_filter)
    for sub in fleet:
        sub.sync()
    assert fleet[0].counters["source_bytes"] > 0
    assert fleet[0].counters["peer_bytes"] == 0
    for sub in fleet[1:]:
        assert sub.counters["source_bytes"] == 0
        assert sub.counters["peer_bytes"] > 0
        _, arrays = sub.current()
        assert_bitexact(arrays, state, leaf_filter=_params_filter)
    peer = fleet[0].as_peer_tier()
    with pytest.raises(OSError):
        peer.write_file("x", b"nope")
    for sub in fleet:
        sub.close()
    mgr.close()


def test_non_incremental_announcement_degrades(tmp_path):
    store = _store(tmp_path)
    mgr = CheckpointManager(store, _policy().with_overrides(mode="full"),
                            device="cpu")
    WeightPublisher(mgr)
    mgr.save(_state(0), 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "c", name="r0",
                           policy=_policy())
    st = sub.sync()
    assert st["state"] == "init"
    assert "incremental" in (st["last_error"] or "")
    assert sub.counters["sync_failures"] == 1
    sub.close()
    mgr.close()


# ---------------------------------------------------------------------------
# subscriber: crash points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["ws_mid_pull", "ws_before_flip",
                                   "ws_after_flip"])
def test_subscriber_killed_then_resumes_bitexact(tmp_path, point):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    state = _state(0)
    mgr.save(state, 0, blocking=True)
    mgr.wait()
    cache = tmp_path / "cache0"
    sub = WeightSubscriber(store, cache, name="r0", policy=_policy(1),
                           crash=CrashInjector(point))
    with pytest.raises(CrashPoint):
        sub.sync()
    if point == "ws_mid_pull":
        assert sub.current() == (None, {})
    pulled_before = sub.cache_residency()["chunks"]
    sub2 = WeightSubscriber(store, cache, name="r0", policy=_policy(1))
    st = sub2.sync()
    assert st["state"] == "live" and st["last_flipped_step"] == 0
    step, arrays = sub2.current()
    assert_bitexact(arrays, state)
    assert sub2.counters["chunks_pulled"] + pulled_before == \
        sub2.cache_residency()["chunks"]
    if point in ("ws_before_flip", "ws_after_flip"):
        assert sub2.counters["wire_bytes"] == 0
    sub.close()
    sub2.close()
    mgr.close()


def test_readers_never_see_a_torn_set_across_flips(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    states = {s: {"params": {"w": torch.full((2048,), float(s))},
                  "step": torch.tensor(s, dtype=torch.int32)}
              for s in range(4)}
    mgr.save(states[0], 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "c", name="r0",
                           policy=_policy())
    sub.sync()
    stop = threading.Event()
    torn: list = []

    def reader():
        while not stop.is_set():
            step, arrays = sub.current()
            if step is None:
                continue
            w = arrays["params/w"]
            s = arrays["step"]
            if not (bool((w == float(step)).all()) and int(s) == step):
                torn.append((step, float(w[0]), int(s)))

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for s in range(1, 4):
            mgr.save(states[s], s, blocking=True)
            mgr.wait()
            sub.sync()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not torn
    assert sub.flipped_step == 3
    sub.close()
    mgr.close()


# ---------------------------------------------------------------------------
# subscriber: fault plane → degraded hold-last-good
# ---------------------------------------------------------------------------

def test_faulted_pull_holds_last_good_then_recovers(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    s0 = _state(0)
    mgr.save(s0, 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "c", name="r0",
                           policy=_policy(1), leaf_filter=_params_filter)
    sub.sync()
    assert sub.state == "live"
    s1 = _state(1)
    mgr.save(s1, 1, blocking=True)
    mgr.wait()
    plane = FaultPlane(seed=7)
    plane.add("read", "eio", tier="*", match=".obj", count=-1)
    wrap_store(sub.store, plane)
    st = sub.sync()
    assert st["state"] == "degraded"
    assert sub.counters["sync_failures"] == 1
    step, arrays = sub.current()
    assert step == 0
    assert_bitexact(arrays, s0, leaf_filter=_params_filter)
    plane.clear()
    st = sub.sync()
    assert st["state"] == "live" and st["last_flipped_step"] == 1
    _, arrays = sub.current()
    assert_bitexact(arrays, s1, leaf_filter=_params_filter)
    sub.close()
    mgr.close()


def test_bitrot_on_peer_falls_through_to_source(tmp_path):
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    state = _state(0)
    mgr.save(state, 0, blocking=True)
    mgr.wait()
    fleet = build_fleet(store, tmp_path / "fleet", 2, policy=_policy(1),
                        leaf_filter=_params_filter)
    fleet[0].sync()
    plane = FaultPlane(seed=3)
    plane.add("read", "bitrot", tier=f"ws-peer-{fleet[0].name}",
              match=".obj", count=-1)
    wrap_store(fleet[1].store, plane)
    st = fleet[1].sync()
    assert st["state"] == "live"
    assert fleet[1].counters["pull_corrupt"] > 0
    assert fleet[1].counters["source_bytes"] > 0
    _, arrays = fleet[1].current()
    assert_bitexact(arrays, state, leaf_filter=_params_filter)
    for sub in fleet:
        sub.close()
    mgr.close()


# ---------------------------------------------------------------------------
# remote fault kinds + classification
# ---------------------------------------------------------------------------

def _remote(tmp_path, **kw):
    return RemoteTier("object-store", tmp_path / "remote", **kw)


def test_truncated_get_faults_multipart_read(tmp_path):
    remote = _remote(tmp_path, part_bytes=1024)
    payload = bytes(range(256)) * 16
    remote.write_file("obj", payload)
    plane = FaultPlane(seed=1)
    plane.add("read_range", "truncated_get", tier="object-store", nth=2)
    ft = FaultyTier(remote, plane)
    buf = bytearray(len(payload))
    assert ft.read_into("obj", memoryview(buf)) is False
    assert remote.io_counters.get("truncated_get", 0) == 1
    buf = bytearray(len(payload))
    assert ft.read_into("obj", memoryview(buf)) is True
    assert bytes(buf) == payload
    assert [f[3] for f in plane.fired()] == ["truncated_get"]


def test_stale_head_faults_and_classification(tmp_path):
    remote = _remote(tmp_path, part_bytes=1024)
    remote.write_file("obj", b"x" * 2048)
    plane = FaultPlane(seed=1)
    plane.add("read_into", "stale_head", tier="object-store", nth=1)
    plane.add("read_file", "stale_head", tier="object-store", nth=1)
    ft = FaultyTier(remote, plane)
    buf = bytearray(2048)
    assert ft.read_into("obj", memoryview(buf)) is False
    assert remote.io_counters.get("stale_head", 0) == 1
    with pytest.raises(resilience.RemoteInconsistencyError) as ei:
        ft.read_file("obj")
    assert resilience.is_transient(ei.value)
    assert not resilience.is_tier_full(ei.value)
    assert ei.value.kind == "stale_head"
    plane.add("read_file", "stale_head", tier="object-store", nth=1)
    out = resilience.retry_io(
        lambda: ft.read_file("obj"),
        resilience.RetryPolicy(retries=2, backoff_ms=0.1))
    assert out == b"x" * 2048


def test_remote_read_file_mismatch_is_typed_transient(tmp_path):
    class Shrinking(RemoteTier):
        def read_range(self, rel, dest, offset):
            super().read_range(rel, dest, offset)
            return False

    t = Shrinking("object-store", tmp_path / "r2", part_bytes=64)
    t.write_file("obj", b"y" * 256)
    with pytest.raises(resilience.RemoteInconsistencyError) as ei:
        t.read_file("obj")
    assert resilience.is_transient(ei.value)


# ---------------------------------------------------------------------------
# breaker-aware drain scheduling
# ---------------------------------------------------------------------------

def test_drain_defers_while_breaker_open_then_flushes(tmp_path):
    fast = Tier("fast", tmp_path / "fast")
    slow = Tier("slow", tmp_path / "slow")
    store = TieredStore(fast, slow, drain_async=True)
    (fast.root / "step_00000001").mkdir(parents=True)
    (fast.root / "step_00000001" / "f").write_bytes(b"a" * 128)
    (fast.root / "step_00000002").mkdir(parents=True)
    (fast.root / "step_00000002" / "f").write_bytes(b"b" * 128)
    health = store.health_for(slow)
    for _ in range(health.breaker.threshold):
        health.record_error("drain_write")
    assert not health.allow()
    store.drain_step("step_00000001")
    assert not (slow.root / "step_00000001" / "f").exists()
    assert store._drain_pending
    assert health.counters.get("drain_deferred") == 1
    health.record_ok("drain_write")
    assert health.allow()
    store.drain_step("step_00000002")
    store.wait_drained()
    assert (slow.root / "step_00000001" / "f").read_bytes() == b"a" * 128
    assert (slow.root / "step_00000002" / "f").read_bytes() == b"b" * 128
    assert not store._drain_pending


def test_wait_drained_forces_deferred_copies(tmp_path):
    fast = Tier("fast", tmp_path / "fast")
    slow = Tier("slow", tmp_path / "slow")
    store = TieredStore(fast, slow, drain_async=True)
    (fast.root / "step_00000001").mkdir(parents=True)
    (fast.root / "step_00000001" / "f").write_bytes(b"z" * 64)
    health = store.health_for(slow)
    for _ in range(health.breaker.threshold):
        health.record_error("drain_write")
    store.drain_step("step_00000001")
    assert not (slow.root / "step_00000001" / "f").exists()
    assert not health.allow()
    store.wait_drained()
    assert (slow.root / "step_00000001" / "f").read_bytes() == b"z" * 64


# ---------------------------------------------------------------------------
# inspector surface
# ---------------------------------------------------------------------------

def test_subscriber_status_published_for_inspector(tmp_path):
    from repro.launch.inspect_ckpt import run_subscribers as jrun_subscribers
    from repro_torch.launch.inspect_ckpt import run_subscribers
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    mgr.save(_state(0), 0, blocking=True)
    mgr.wait()
    sub = WeightSubscriber(store, tmp_path / "c", name="edge-7",
                           policy=_policy())
    sub.sync()
    rel = f"{SUBSCRIBERS_DIR}/edge-7.json"
    doc = json.loads(store.fast.read_file(rel).decode())
    assert doc["name"] == "edge-7"
    assert doc["last_flipped_step"] == 0
    assert doc["cache_chunks"] > 0

    quiet = dict(out=lambda *_: None)
    rep = run_subscribers(store.fast.root, **quiet)
    assert rep["ok"] and rep["announce"]["step"] == 0
    assert [s["name"] for s in rep["subscribers"]] == ["edge-7"]
    assert rep == jrun_subscribers(store.fast.root, **quiet)
    mgr.save(_state(1), 1, blocking=True)
    mgr.wait()
    rep = run_subscribers(store.fast.root, **quiet)
    assert not rep["ok"] and rep["announce"]["step"] == 1
    assert rep == jrun_subscribers(store.fast.root, **quiet)
    sub.sync()
    rep = run_subscribers(store.fast.root, **quiet)
    assert rep["ok"]
    sub.close()
    mgr.close()


# ---------------------------------------------------------------------------
# the two packages crossed
# ---------------------------------------------------------------------------

def _bf16_np_state(step: int) -> dict:
    """A state with bf16 params (the served dtype) for the crossed
    cases: bf16 crosses as its uint16 bits under ``codec.BF16``."""
    st = _np_state(step)
    st["params"]["emb"] = np.asarray(
        jnp.asarray(st["params"]["emb"], jnp.bfloat16))
    return st


def _jpolicy():
    return JPolicy().with_overrides(
        mode="incremental", chunk_size=2048, io_threads=2, keepalive_s=60.0)


def test_port_subscriber_syncs_from_jax_publisher(tmp_path):
    np_state = _bf16_np_state(0)
    jstore = JStore(JTier("fast", tmp_path / "fast"),
                    JTier("slow", tmp_path / "slow"))
    jmgr = JManager(jstore, policy=_jpolicy())
    jpub = JPublisher(jmgr)
    jmgr.save(jax.tree.map(jnp.asarray, np_state), 0, blocking=True)
    jmgr.wait()
    ann = json.loads((tmp_path / "fast" / ANNOUNCE_REL).read_text())

    sub = WeightSubscriber(_store(tmp_path), tmp_path / "cache",
                           name="port", policy=_policy())
    st = sub.sync()
    assert st["state"] == "live" and st["last_flipped_step"] == 0
    _, arrays = sub.current()
    assert arrays["params/emb"].dtype == torch.bfloat16
    jrestored, _ = jmgr.restore(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                     np_state), step=0)
    assert_bitexact(arrays, from_jax_state(
        jax.tree.map(np.asarray, jrestored), device="cpu"))
    # the port's publisher writes the reference's announcement keys
    pstore = _store(tmp_path / "port")
    pmgr = _mgr(pstore)
    pann = WeightPublisher(pmgr).announce(0, ann["manifest"])
    assert sorted(pann) == sorted(ann)
    assert jpub.last_announced_step == 0
    sub.close()
    pmgr.close()
    jmgr.close()


def test_jax_subscriber_syncs_from_port_publisher(tmp_path):
    np_state = _bf16_np_state(1)
    store = _store(tmp_path)
    mgr = _mgr(store)
    WeightPublisher(mgr)
    state = from_jax_state(np_state, device="cpu")
    mgr.save(state, 1, blocking=True)
    mgr.wait()

    jsub = JSubscriber(JStore(JTier("fast", tmp_path / "fast"),
                              JTier("slow", tmp_path / "slow")),
                       tmp_path / "jcache", name="jax", policy=_jpolicy())
    st = jsub.sync()
    assert st["state"] == "live" and st["last_flipped_step"] == 1
    _, jarrays = jsub.current()
    assert str(jarrays["params/emb"].dtype) == "bfloat16"
    restored, _ = mgr.restore(_abstract(state), step=1)
    got = from_jax_state(dict(jarrays), device="cpu")
    assert_bitexact(got, restored)
    assert_bitexact(got, state)
    jsub.close()
    mgr.close()
