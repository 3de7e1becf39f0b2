"""The fault-injection matrix in the port (``repro_torch.core.faults``),
held against ``tests/test_fault_matrix.py``: every point of its ``POINTS``
× ``IO_AXES`` × ``CHUNKINGS`` (imported from that module, so the two
cannot drift) runs through the port's ``CheckpointManager`` and through
the JAX package's, on the same state (the reference's ``_state`` carried
across by ``convert.from_jax_state``) under the same seeded
``FaultPlane`` schedule. Per point the two must agree on the outcome —
commit, abort or degraded (and the serial engine's ``serial_save``), the
surfaced drain error, the scrub's heal — and on the sites the plane
fired; each package's checkpoints restore bit-exact and its CAS passes
fsck after GC. On three points (a transient write, bit-rot, a full fast
tier) the port's manifests and CAS objects are byte-identical to the JAX
package's, and each package restores the other's checkpoint.

Also ported: the seeded random schedule (``FAULT_MATRIX_SEED``), the
scrubber (heal from replica and from the slow tier, the last copy kept,
preemption, a crash mid-heal), the degraded commit, the serial engine's
fail-fast, ``read_into`` accounting, the replica probe, and the retry /
deadline / breaker primitives."""
import collections
import os

import jax
import numpy as np
import pytest
import torch

import test_fault_matrix as ref
from repro.core import faults as jfaults
from repro.core.errors import AbortedError as JAbortedError
from repro.core.errors import CkptError as JCkptError
from repro.core.errors import SpaceError as JSpaceError
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro_torch.convert import from_jax_state
from repro_torch.core import cas, resilience
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.errors import AbortedError, CkptError, SpaceError
from repro_torch.core.faults import FaultPlane, FaultyTier, wrap_store
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.preempt import PreemptionGuard
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore

SEED = int(os.environ.get("FAULT_MATRIX_SEED", "7"))
assert SEED == ref.SEED
# one transient write, one bit-rot, one full fast tier
BYTE_POINTS = ("w-eio-1", "w-bitrot-replica", "w-enospc-persistent")


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def _tstate(seed: int) -> dict:
    """The reference's ``_state(seed)``, bit for bit, as tensors."""
    return from_jax_state(jax.tree.map(np.asarray, ref._state(seed)),
                          device="cpu")


def _abstract(state):
    if isinstance(state, dict):
        return {k: _abstract(v) for k, v in state.items()}
    return torch.empty_like(state, device="meta")


def _assert_restores(mgr, step, expect):
    restored, _ = mgr.restore(_abstract(expect), step=step)
    for (name, a), (_, b) in zip(leaf_paths(expect), leaf_paths(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


def _policy(**flat):
    flat.setdefault("keepalive_s", 60.0)
    return CheckpointPolicy().with_overrides(**flat)


def _mgr(store, io_threads, chunking, mode="incremental", replicas=1):
    """The reference's ``_mgr``, flat kwarg for flat kwarg."""
    return CheckpointManager(store, _policy(
        n_writers=2, codec="raw", mode=mode, chunk_size=512,
        chunking=chunking, retain=2, max_retries=0, replicas=replicas,
        io_threads=io_threads, io_retries=2, io_backoff_ms=1.0,
        io_deadline_s=10.0), device="cpu")


def _plane_store(tmp_path, plane=None):
    plane = plane if plane is not None else FaultPlane(seed=SEED)
    store = TieredStore(Tier("fast", tmp_path / "fast"),
                        Tier("slow", tmp_path / "slow"))
    return wrap_store(store, plane), plane


class _Side:
    """One package's half of a matrix point: its store and plane types,
    its manager, its states and its restore check."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.Plane, self.wrap = FaultPlane, wrap_store
            self.Tier, self.Store = Tier, TieredStore
            self.mgr = _mgr
            self.state = _tstate
            self.restores = _assert_restores
            self.errors = {"abort": AbortedError, "space": SpaceError,
                           "ckpt": CkptError}
        else:
            self.Plane, self.wrap = jfaults.FaultPlane, jfaults.wrap_store
            self.Tier, self.Store = JTier, JStore
            self.mgr = ref._mgr
            self.state = ref._state
            self.restores = ref._assert_restores
            self.errors = {"abort": JAbortedError, "space": JSpaceError,
                           "ckpt": JCkptError}


def _sites(fired) -> collections.Counter:
    """What a schedule fired: each firing's op, tier, kind and spec key.
    Paths are left out: which object takes the nth matching write or read
    is a race between the writer ranks and pool workers, run to run,
    within either package."""
    return collections.Counter((op, tier, kind, key)
                               for op, tier, _rel, kind, key in fired)


def _drive(side: _Side, tmp_path, point, io_threads, chunking) -> dict:
    """``test_fault_matrix``'s protocol on one package; returns what it
    observed."""
    serial = io_threads == 1
    plane = side.Plane(seed=SEED)
    store = side.wrap(side.Store(side.Tier("fast", tmp_path / "fast"),
                                 side.Tier("slow", tmp_path / "slow")),
                      plane)
    mgr = side.mgr(store, io_threads, chunking,
                   mode=point.get("mode", "incremental"),
                   replicas=point.get("replicas", 1))
    seen = {"policy": mgr.policy.to_dict()}
    states = {1: side.state(1), 2: side.state(2)}
    mgr.save(states[1], 1)
    store.wait_drained()

    for kw in point.get("save", []):
        plane.add(**kw)
    expect_serial = point.get("serial_save", "ok")
    drain_err = False
    seen["outcome"] = "commit"
    if serial and expect_serial != "ok":
        with pytest.raises(side.errors[expect_serial]):
            mgr.save(states[2], 2)
        assert plane.fired(), "serial round aborted without a fired fault"
        seen["outcome"] = expect_serial
        seen["save_fired"] = plane.fired()
        plane.clear()
        mgr.save(states[2], 2)
    else:
        try:
            rep = mgr.save(states[2], 2)
        except OSError:
            assert serial and point.get("drain_err_serial"), point["name"]
            drain_err, rep = True, None
        if rep is not None and not serial:
            if point.get("degraded"):
                assert rep["degraded"] is True
                assert mgr.load_manifest(2).get("degraded") is True
                assert plane.fired()
                seen["outcome"] = "degraded"
            else:
                assert not rep.get("degraded"), point["name"]
    try:
        store.wait_drained()
    except OSError:
        drain_err = True
    assert drain_err == bool(serial and point.get("drain_err_serial")), \
        point["name"]
    seen["drain_err"] = drain_err
    assert mgr.latest_step() == 2
    seen.setdefault("save_fired", plane.fired())
    plane.clear()

    if point.get("scrub"):
        srep = mgr.scrub()["scrub"]
        assert srep["quarantined"] >= 1, srep
        assert srep["healed"] >= 1, srep
        assert srep["unrecoverable"] == 0, srep
        assert mgr.chunks.quarantine_entries()
        seen["scrub"] = {k: srep[k] for k in ("quarantined", "healed",
                                              "unrecoverable")}
    if point.get("cold"):
        ref._wipe_fast(store)

    for kw in point.get("restore", []):
        plane.add(**kw)
    seen["restore_raised"] = False
    if serial and point.get("serial_restore_raises"):
        with pytest.raises((OSError, side.errors["ckpt"])):
            side.restores(mgr, 2, states[2])
        seen["restore_raised"] = True
        plane.clear()
    side.restores(mgr, 2, states[2])
    side.restores(mgr, 1, states[1])
    seen["restore_fired"] = plane.fired()
    plane.clear()

    mgr.gc()
    fsck = mgr.chunks.fsck(mgr._live_chunk_refs())
    assert fsck["ok"], (point["name"], fsck)
    seen["manifest"] = mgr.load_manifest(2)
    mgr.close()
    return seen


def _objects(root):
    """{storage-relative path → bytes} of every CAS object under `root`."""
    objs = root / cas.OBJECTS_DIR
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(objs.glob(f"*/*{cas.OBJ_SUFFIX}*"))}


@pytest.mark.parametrize("chunking", ref.CHUNKINGS)
@pytest.mark.parametrize("io_threads", ref.IO_AXES)
@pytest.mark.parametrize("point", ref.POINTS, ids=lambda p: p["name"])
def test_fault_matrix(tmp_path, point, io_threads, chunking):
    got = _drive(_Side(port=True), tmp_path / "port", point, io_threads,
                 chunking)
    want = _drive(_Side(port=False), tmp_path / "jax", point, io_threads,
                  chunking)
    assert got["policy"] == want["policy"]
    for key in ("outcome", "drain_err", "restore_raised"):
        assert got[key] == want[key], (point["name"], key)
    assert got.get("scrub") == want.get("scrub")
    assert bool(got["manifest"].get("degraded")) == \
        bool(want["manifest"].get("degraded"))
    assert _sites(got["save_fired"]) == _sites(want["save_fired"])
    assert _sites(got["restore_fired"]) == _sites(want["restore_fired"])
    if point["name"] in BYTE_POINTS and point.get("mode") != "full":
        _assert_byte_identical_and_crossed(tmp_path, got, want)


def _assert_byte_identical_and_crossed(tmp_path, got, want):
    for a, b in ((got["manifest"], want["manifest"]),):
        assert a["leaves"] == b["leaves"]
        assert a.get("degraded") == b.get("degraded")
        assert a["format"] == b["format"]
    for tier in ("fast", "slow"):
        assert _objects(tmp_path / "port" / tier) == \
            _objects(tmp_path / "jax" / tier), tier
    # each package restores the other's checkpoint
    port = TieredStore(Tier("fast", tmp_path / "jax" / "fast"),
                       Tier("slow", tmp_path / "jax" / "slow"))
    mgr = _mgr(port, 4, "fixed")
    for s in (1, 2):
        _assert_restores(mgr, s, _tstate(s))
    mgr.close()
    jstore = JStore(JTier("fast", tmp_path / "port" / "fast"),
                    JTier("slow", tmp_path / "port" / "slow"))
    jmgr = ref._mgr(jstore, 4, "fixed")
    for s in (1, 2):
        ref._assert_restores(jmgr, s, ref._state(s))
    jmgr.close()


# ---------------------------------------------------------------------------
# randomized schedule — replayable chaos (FAULT_MATRIX_SEED)
# ---------------------------------------------------------------------------

def test_random_schedule_matches_reference_byte_for_byte():
    """With the same seed both packages draw the same schedule and the
    same bit-rot offsets."""
    for seed in (SEED, 0, 1234):
        a = FaultPlane.random_schedule(seed, n=6)
        b = jfaults.FaultPlane.random_schedule(seed, n=6)
        assert [repr(s) for s in a.specs] == [repr(s) for s in b.specs]
        assert [a.rot_offset(4096) for _ in range(8)] == \
            [b.rot_offset(4096) for _ in range(8)]


def test_randomized_schedule_replayable(tmp_path):
    plane = FaultPlane.random_schedule(SEED, n=6)
    store, _ = _plane_store(tmp_path, plane)
    mgr = _mgr(store, io_threads=4, chunking="cdc")
    states = {1: _tstate(1), 2: _tstate(2), 3: _tstate(3)}
    for s in (1, 2, 3):
        assert mgr.save(states[s], s)["step"] == s
    store.wait_drained()
    for s in (1, 2, 3):
        _assert_restores(mgr, s, states[s])
    mgr.gc()
    fsck = mgr.chunks.fsck(mgr._live_chunk_refs())
    assert fsck["ok"], (SEED, [s.key for s in plane.specs], fsck)
    mgr.close()


def test_wrap_store_replaces_tiers_by_identity(tmp_path):
    store = TieredStore(Tier("fast", tmp_path / "f"),
                        Tier("slow", tmp_path / "s"))
    inner = store.fast
    plane = FaultPlane()
    assert wrap_store(store, plane) is store
    assert isinstance(store.fast, FaultyTier) and store.fast.inner is inner
    assert store.tiers()[0] is store.fast
    assert store.health_for(store.fast) is store.health_for(store.tiers()[0])
    wrap_store(store, plane)                 # idempotent: no double wrap
    assert store.fast.inner is inner
    store.fast.bw_bytes_per_s = 123.0        # attribute writes delegate
    assert inner.bw_bytes_per_s == 123.0


# ---------------------------------------------------------------------------
# scrubber: heal, refuse-last-copy, preemption, crash convergence
# ---------------------------------------------------------------------------

def _live_primaries(mgr, tier):
    live = mgr._live_chunk_refs()
    out = []
    for digest, n in sorted(live.items()):
        if n <= 0:
            continue
        p = tier.root / cas.object_rel(digest)
        if p.is_file():
            out.append((digest, p))
    return out


def test_scrub_heals_bitrot_from_replica(tmp_path):
    store, _ = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed", replicas=2)
    state = _tstate(1)
    mgr.save(state, 1)
    store.wait_drained()
    digest, p = _live_primaries(mgr, store.fast)[0]
    ref._corrupt(p)
    rep = mgr.scrub()["scrub"]
    assert rep["quarantined"] == 1 and rep["unrecoverable"] == 0
    assert rep["healed"] >= 1
    entries = mgr.chunks.quarantine_entries()
    assert [e[2] for e in entries] == [digest]
    assert cas.chunk_digest(p.read_bytes()) == digest
    qpath = store.fast.root / entries[0][1]
    assert cas.chunk_digest(qpath.read_bytes()) != digest
    _assert_restores(mgr, 1, state)
    again = mgr.scrub()["scrub"]
    assert again["quarantined"] == 0 and again["healed"] == 0
    assert again["clean"] == again["scanned"]
    mgr.gc()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    mgr.close()


def test_scrub_never_quarantines_last_copy(tmp_path):
    store = TieredStore(Tier("fast", tmp_path / "fast"))
    mgr = _mgr(store, io_threads=4, chunking="fixed")
    mgr.save(_tstate(1), 1)
    digest, p = _live_primaries(mgr, store.fast)[0]
    ref._corrupt(p)
    rep = mgr.scrub()["scrub"]
    assert rep["unrecoverable"] == 1 and rep["quarantined"] == 0
    assert p.is_file(), "last surviving copy must stay in place"
    assert not mgr.chunks.quarantine_entries()
    mgr.close()


def test_scrub_heals_from_slow_tier(tmp_path):
    store, _ = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed")
    state = _tstate(1)
    mgr.save(state, 1)
    store.wait_drained()
    digest, p = _live_primaries(mgr, store.fast)[0]
    ref._corrupt(p)
    rep = mgr.scrub()["scrub"]
    assert rep["quarantined"] == 1 and rep["healed"] >= 1
    assert rep["unrecoverable"] == 0
    assert cas.chunk_digest(p.read_bytes()) == digest
    _assert_restores(mgr, 1, state)
    mgr.close()


def test_scrub_preemption_defers_and_converges(tmp_path):
    store, _ = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed", replicas=2)
    state = _tstate(1)
    mgr.save(state, 1)
    store.wait_drained()
    primaries = _live_primaries(mgr, store.fast)
    assert len(primaries) >= 6
    for _d, p in primaries[:3]:
        ref._corrupt(p)

    with PreemptionGuard() as guard:
        polls = [0]

        def stop():
            polls[0] += 1
            if polls[0] == 3:
                guard.request()
            return guard.should_preempt

        rep = mgr.scrub(should_stop=stop)["scrub"]
    assert rep["deferred"] > 0
    assert rep["scanned"] < len(primaries)
    for tier_name, _qrel, digest, replica, _size in \
            mgr.chunks.quarantine_entries():
        tier = next(t for t in store.tiers() if t.name == tier_name)
        assert (tier.root / cas.object_rel(digest, replica)).is_file()
    healed_total = rep["healed"]
    rep2 = mgr.scrub()["scrub"]
    healed_total += rep2["healed"]
    assert rep2["deferred"] == 0
    assert healed_total == 3
    rep3 = mgr.scrub()["scrub"]
    assert rep3["quarantined"] == 0 and rep3["healed"] == 0
    _assert_restores(mgr, 1, state)
    mgr.close()


def test_scrub_converges_after_crash_mid_heal(tmp_path):
    store, _ = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed", replicas=2)
    state = _tstate(1)
    mgr.save(state, 1)
    store.wait_drained()
    digest, p = _live_primaries(mgr, store.fast)[0]
    ref._corrupt(p)
    with pytest.raises(CrashPoint):
        mgr.scrub(crash=CrashInjector("scrub_after_quarantine"))
    assert not p.is_file(), "crash window: quarantined but not healed"
    entries = mgr.chunks.quarantine_entries()
    assert [e[2] for e in entries] == [digest]
    _assert_restores(mgr, 1, state)
    rep = mgr.scrub()["scrub"]
    assert rep["healed"] >= 1 and rep["unrecoverable"] == 0
    assert cas.chunk_digest(p.read_bytes()) == digest
    rep2 = mgr.scrub()["scrub"]
    assert rep2["quarantined"] == 0 and rep2["healed"] == 0
    mgr.gc()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    mgr.close()


def test_scrub_report_persisted_for_the_inspector(tmp_path):
    import json
    store, _ = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed")
    mgr.save(_tstate(1), 1)
    store.wait_drained()
    ref._corrupt(_live_primaries(mgr, store.fast)[0][1])
    rep = mgr.scrub(sample=4, seed=3)["scrub"]
    saved = json.loads((store.fast.root / cas.SCRUB_FILE).read_text())
    assert saved["seed"] == 3 and saved["scanned"] == rep["scanned"] <= 4
    mgr.close()


# ---------------------------------------------------------------------------
# degraded-mode commit + health surfaces
# ---------------------------------------------------------------------------

def test_degraded_save_commits_and_is_inspectable(tmp_path):
    store, plane = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="fixed")
    state = _tstate(2)
    plane.add(op="write", kind="erofs", tier="fast", match=".obj",
              count=-1)
    rep = mgr.save(state, 2)
    assert rep["degraded"] is True
    assert mgr.load_manifest(2).get("degraded") is True
    assert mgr.chunks.degraded_writes > 0
    plane.clear()
    _assert_restores(mgr, 2, state)
    health = store.health_report()
    assert health["slow"]["counters"].get("degraded_writes", 0) > 0
    assert health["fast"]["breaker"]["state"] in ("closed", "open")
    mgr.gc()
    assert (store.fast.root / cas.HEALTH_FILE).is_file()
    mgr.close()


def test_serial_engine_stays_failfast_on_tier_full(tmp_path):
    store, plane = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=1, chunking="fixed")
    plane.add(op="write", kind="enospc", tier="fast", match=".obj",
              count=-1)
    with pytest.raises(AbortedError):
        mgr.save(_tstate(2), 2)
    assert mgr.chunks.degraded_writes == 0
    plane.clear()
    mgr.save(_tstate(2), 2)
    assert mgr.load_manifest(2).get("degraded") is None
    mgr.close()


def test_on_commit_hook_sees_the_degraded_manifest(tmp_path):
    store, plane = _plane_store(tmp_path)
    mgr = _mgr(store, io_threads=4, chunking="cdc")
    seen = []
    mgr.on_commit.append(lambda step, m: seen.append((step, m.get(
        "degraded"))))
    mgr.save(_tstate(1), 1)
    plane.add(op="free", kind="full", tier="fast", count=-1)
    mgr.save(_tstate(2), 2)
    assert seen == [(1, None), (2, True)]
    mgr.close()


# ---------------------------------------------------------------------------
# read_into accounting, replica probe economy
# ---------------------------------------------------------------------------

def test_read_into_distinguishes_missing_from_damage(tmp_path):
    tier = Tier("t", tmp_path)
    buf = bytearray(8)
    assert tier.read_into("absent.obj", buf) is False
    assert tier.io_counters.get("read_missing") == 1
    assert not tier._warned_reads

    tier.write_file("short.obj", b"1234")
    assert tier.read_into("short.obj", buf) is False
    assert tier.read_into("short.obj", buf) is False
    assert tier.io_counters.get("short_read") == 2
    assert len(tier._warned_reads) == 1

    plane = FaultPlane()
    plane.add(op="read_into", kind="eio", tier="t", match="short.obj")
    wrapped = FaultyTier(tier, plane)
    tier.write_file("short.obj", bytes(8))
    assert wrapped.read_into("short.obj", buf) is False
    assert tier.io_counters.get("read_error") == 1
    assert wrapped.read_into("short.obj", buf) is True


def test_single_replica_skips_dead_replica_probe(tmp_path):
    store = TieredStore(Tier("fast", tmp_path / "fast"))
    mgr = _mgr(store, io_threads=4, chunking="fixed")
    data = b"x" * 600
    digest = cas.chunk_digest(data)
    assert mgr.chunks.put(digest, data) > 0
    primary = store.fast.root / cas.object_rel(digest)
    legacy = store.fast.root / cas.object_rel(digest, 1)
    assert primary.is_file() and not legacy.exists()
    legacy.parent.mkdir(parents=True, exist_ok=True)
    legacy.write_bytes(data)
    ref._corrupt(primary)
    assert mgr.chunks.exists(digest) is True
    assert mgr.chunks.get(digest) == data
    primary.unlink()
    assert mgr.chunks.exists(digest) is False
    assert mgr.chunks.get(digest) == data
    mgr.close()


# ---------------------------------------------------------------------------
# resilience primitives (no IO): retry, deadline, breaker
# ---------------------------------------------------------------------------

def test_retry_absorbs_transient_and_respects_budget():
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise OSError(5, "Input/output error")
        return "ok"

    sleeps = []
    pol = resilience.RetryPolicy(retries=2, backoff_ms=1.0, deadline_s=None)
    assert resilience.retry_io(flaky, pol, sleep=sleeps.append) == "ok"
    assert calls[0] == 3 and len(sleeps) == 2
    assert all(0.001 <= s <= 0.1 for s in sleeps)
    calls[0] = 0
    with pytest.raises(OSError):
        resilience.retry_io(
            flaky, resilience.RetryPolicy(retries=1, backoff_ms=1.0,
                                          deadline_s=None),
            sleep=lambda _s: None)
    assert calls[0] == 2


def test_retry_fails_fast_on_permanent_and_without_policy():
    def eperm():
        raise PermissionError(1, "Operation not permitted")
    with pytest.raises(PermissionError):
        resilience.retry_io(
            eperm, resilience.RetryPolicy(retries=5, backoff_ms=1.0),
            sleep=lambda _s: None)
    calls = [0]

    def once():
        calls[0] += 1
        raise OSError(5, "io")
    with pytest.raises(OSError):
        resilience.retry_io(once, None)
    assert calls[0] == 1


def test_deadline_cuts_retries_short():
    now = [0.0]
    dl = resilience.Deadline(1.0, clock=lambda: now[0])

    def always():
        now[0] += 0.6
        raise OSError(5, "io")
    with pytest.raises(OSError):
        resilience.retry_io(
            always, resilience.RetryPolicy(retries=99, backoff_ms=1.0),
            deadline=dl, sleep=lambda _s: None)
    assert now[0] <= 1.3


def test_circuit_breaker_lifecycle():
    now = [0.0]
    br = resilience.CircuitBreaker(threshold=3, cooldown_s=30.0,
                                   clock=lambda: now[0])
    assert br.state == "closed" and br.allow()
    for _ in range(2):
        br.record_error()
    assert br.state == "closed"
    br.record_ok()
    br.record_error()
    br.record_error()
    assert br.state == "closed"
    br.record_error()
    assert br.state == "open" and not br.allow() and br.trips == 1
    now[0] += 31.0
    assert br.state == "half-open" and br.allow()
    br.record_error()
    assert br.state == "open"
    now[0] += 31.0
    br.record_ok()
    assert br.state == "closed" and br.allow()


def test_fault_classification():
    assert resilience.is_transient(OSError(5, "io"))
    assert resilience.is_transient(OSError(28, "nospc"))
    assert resilience.is_tier_full(OSError(28, "nospc"))
    assert resilience.is_tier_full(OSError(30, "rofs"))
    assert not resilience.is_tier_full(OSError(5, "io"))
    assert not resilience.is_transient(PermissionError(1, "eperm"))
    assert not resilience.is_transient(ValueError("not IO at all"))
