"""The port's staged pipeline engines held to
``tests/test_save_restore_path.py``: the rank-wide ``SaveSession`` queue
(cross-payload pipelining, scan-ahead, the serial engine, error and abort
joins, dedup, the batched fsync), ``SavePlan``, the direct-placement
fixed-chunking read with its fallbacks, ``PersistStage`` (errors, the
fast-flush flag, the bounded multi-round queue, the byte budget) and the
manager's queue depth and byte budget, each with the reference test's own
assertions on the port's result.

Where the reference defines bytes, the JAX package's ``ChunkStore`` takes
the same payloads: digests, lengths, crc and the CAS objects must be the
same. ``SavePlan.manifest_shards`` is keyed by item index in the port (a
sharded save merges every process's records by index) where the reference
keys it by leaf name; the manifest table both build from it is the same."""
import threading
import time
import zlib

import numpy as np
import pytest

import test_torch_checkpoint_engine as eng
from repro.core import cas as jcas
from repro.core import save_path as jsave
from repro.core.cdc import GearChunker as JGearChunker
from repro.core.elastic import ShardRange as JShardRange
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro_torch.core import cas
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.cdc import GearChunker
from repro_torch.core.cdc_scan import MIN_ACCEL_BYTES
from repro_torch.core.elastic import ShardRange
from repro_torch.core.save_path import (PayloadTicket, PersistStage,
                                        SavePlan, SaveSession,
                                        estimate_snapshot_bytes)
from repro_torch.core.storage import Tier, TieredStore


def _chunks(tmp_path, io_threads=4, chunk_size=128, replicas=1):
    store = TieredStore(Tier("fast", tmp_path / f"cs{io_threads}"))
    return cas.ChunkStore(store, chunk_size=chunk_size, replicas=replicas,
                          io_threads=io_threads)


def _jchunks(tmp_path, io_threads=1, chunk_size=128, replicas=1):
    store = JStore(JTier("fast", tmp_path / f"ref{io_threads}"))
    return jcas.ChunkStore(store, chunk_size=chunk_size, replicas=replicas,
                           io_threads=io_threads)


def _objects(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted((root / "_CAS" / "objects").rglob("*.obj"))}


# ---------------------------------------------------------------------------
# SaveSession: rank-wide cross-payload submission queue
# ---------------------------------------------------------------------------

def test_session_matches_put_payload_reference(tmp_path, rng):
    """The port's streaming session gives the digests, byte accounting and
    crc of the reference's one-payload-at-a-time engine, and writes the
    same objects."""
    payloads = [rng.bytes(500), rng.bytes(128), b"", rng.bytes(1000)]
    ref = _jchunks(tmp_path / "ref", io_threads=1)
    want = []
    for p in payloads:
        digests, new = ref.put_payload(p)
        want.append((digests, new, zlib.crc32(p) & 0xFFFFFFFF))

    cs = _chunks(tmp_path / "ses", io_threads=4)
    session = SaveSession(cs)
    tickets = [session.submit_payload(p) for p in payloads]
    session.barrier()
    got = [session.result(t) for t in tickets]
    assert got == want
    for p, (digests, _, _) in zip(payloads, got):
        assert bytes(cs.read_payload(digests, len(p))) == p
    assert _objects(tmp_path / "ses" / "cs4") == \
        _objects(tmp_path / "ref" / "ref1")
    cs.close()
    ref.close()


def test_session_pipelines_across_payload_boundaries(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=64)
    gate = threading.Event()
    orig = cs.store_chunk
    stalled = []

    def slow_store(digest, data, crash=None, dirs=None, dirs_lock=None):
        if not stalled:
            stalled.append(digest)
            gate.wait(timeout=10)
        return orig(digest, data, crash or cas.NO_CRASH, dirs, dirs_lock)

    cs.store_chunk = slow_store
    session = SaveSession(cs, window=8)
    a = session.submit_payload(rng.bytes(64 * 2))
    b = session.submit_payload(rng.bytes(64 * 2))
    assert not a.done and not b.done
    gate.set()
    session.barrier()
    da, _, _ = session.result(a)
    db, _, _ = session.result(b)
    assert len(da) == 2 and len(db) == 2
    cs.close()


def test_session_scan_ahead_defers_and_matches_serial(tmp_path, rng):
    """With the accelerated scan (its plain version on the CPU) a payload's
    scan dispatches at submit time and its chunks feed the pool only when
    the next payload arrives; the digests, lengths and crc equal the
    reference's serial engine's."""
    payloads = [rng.bytes(MIN_ACCEL_BYTES + 13), rng.bytes(MIN_ACCEL_BYTES)]
    jck = JGearChunker(1 << 18, scan_backend="jnp")
    ref = _jchunks(tmp_path / "ref", io_threads=1, chunk_size=1 << 18)
    want = []
    for p in payloads:
        lens: list = []
        digests, new = ref.put_payload(p, chunker=jck, lens_out=lens)
        want.append((digests, lens, zlib.crc32(p) & 0xFFFFFFFF))

    ck = GearChunker(1 << 18, scan_backend="jnp", device="cpu")
    cs = _chunks(tmp_path / "ses", io_threads=4, chunk_size=1 << 18)
    session = SaveSession(cs, chunker=ck)
    t1 = session.submit_payload(payloads[0])
    assert not t1.submitted
    t2 = session.submit_payload(payloads[1])
    assert t1.submitted
    session.barrier()
    for t, (digests, lens, crc) in zip((t1, t2), want):
        d, _, c = session.result(t)
        assert (d, t.lens, c) == (digests, lens, crc)
    assert sum(t1.lens) == len(payloads[0])
    cs.close()
    ref.close()


def test_session_serial_engine_is_put_payload(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=1)
    session = SaveSession(cs)
    payload = rng.bytes(300)
    ticket = session.submit_payload(payload)
    assert ticket.done
    digests, new, crc = session.result(ticket)
    assert crc == (zlib.crc32(payload) & 0xFFFFFFFF)
    assert bytes(cs.read_payload(digests, len(payload))) == payload
    jref = _jchunks(tmp_path, io_threads=1)
    assert jref.put_payload(payload) == (digests, new)
    cs.close()
    jref.close()


def test_session_error_joins_all_in_flight(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=64)
    session = SaveSession(cs, crash=CrashInjector("cas_mid_batch"))
    with pytest.raises(CrashPoint):
        session.submit_payload(rng.bytes(64 * 40))
        session.barrier()
    assert not session._pending
    cs.close()


def test_session_caller_abort_joins_in_flight(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=64)
    gate = threading.Event()
    started = threading.Event()
    orig = cs.store_chunk

    def slow(digest, data, crash=None, dirs=None, dirs_lock=None):
        started.set()
        gate.wait(timeout=10)
        return orig(digest, data, crash or cas.NO_CRASH, dirs, dirs_lock)

    cs.store_chunk = slow
    session = SaveSession(cs, window=8)
    session.submit_payload(rng.bytes(64 * 4))
    assert started.wait(5)
    done = []
    t = threading.Thread(
        target=lambda: (session.abort(), done.append(1)), daemon=True)
    t.start()
    t.join(0.3)
    assert not done
    gate.set()
    t.join(10)
    assert done and not session._pending
    cs.close()


def test_session_dedup_accounting(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=64)
    payload = rng.bytes(64 * 3)
    session = SaveSession(cs)
    t1 = session.submit_payload(payload)
    t2 = session.submit_payload(payload)
    session.barrier()
    d1, n1, c1 = session.result(t1)
    d2, n2, c2 = session.result(t2)
    assert d1 == d2 and c1 == c2
    assert n1 == 64 * 3 and n2 == 0
    cs.close()


def test_session_batched_dirs_fsynced_once(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=64)
    session = SaveSession(cs)
    session.submit_payload(rng.bytes(64 * 8))
    session.flush()
    assert session.dirs
    session.barrier()
    assert not session.dirs
    cs.close()


# ---------------------------------------------------------------------------
# SavePlan
# ---------------------------------------------------------------------------

def _items(n, shard_range=ShardRange):
    return [(f"params/w{i}", shard_range((0,), (4,)),
             np.arange(4, dtype=np.float32)) for i in range(n)]


def _specs(n):
    return [(f"params/w{i}", (4,), "float32") for i in range(n)]


def test_save_plan_round_robin_and_replicas():
    """Each rank gets two primaries and two buddy replicas; every record
    has two replica files. The port keys ``manifest_shards`` by item index
    (by design), so the records are read through its own layout, and the
    manifest table built from them equals the reference's."""
    plan = SavePlan.build(_items(4), alive=[0, 1], incremental=False,
                          replicas=2, leaf_codec=lambda n: "raw")
    for r in (0, 1):
        work = plan.per_rank[r]
        assert sum(1 for w in work if not w[5]) == 2
        assert sum(1 for w in work if w[5]) == 2
    recs = list(plan.manifest_shards.values())
    assert sorted(plan.manifest_shards) == [0, 1, 2, 3]
    assert len(recs) == 4
    assert all(len(s["replicas"]) == 2 for s in recs)
    jplan = jsave.SavePlan.build(_items(4, JShardRange), alive=[0, 1],
                                 incremental=False, replicas=2,
                                 leaf_codec=lambda n: "raw")
    assert plan.manifest_leaves(_specs(4), None) == \
        jplan.manifest_leaves(_specs(4), None)
    def work(p):
        return [[(i, name, rng.start, rng.stop, fname, rep)
                 for i, name, rng, _, fname, rep in p.per_rank[r]]
                for r in (0, 1)]
    assert work(plan) == work(jplan)


def test_save_plan_incremental_skips_file_records():
    plan = SavePlan.build(_items(3), alive=[0], incremental=True,
                          replicas=2, leaf_codec=lambda n: "raw")
    assert plan.manifest_shards == {}
    assert plan.shard_order == {f"params/w{i}": [i] for i in range(3)}


# ---------------------------------------------------------------------------
# direct-placement restore (fixed chunking)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 127, 128, 129, 128 * 7 + 3])
def test_read_payload_fixed_matches_join_path(tmp_path, rng, size):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=128)
    jref = _jchunks(tmp_path, io_threads=1, chunk_size=128)
    payload = rng.bytes(size)
    digests, _ = cs.put_payload(payload)
    assert jref.put_payload(payload)[0] == digests
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    direct = cs.read_payload_fixed(digests, size, 128, crc)
    assert bytes(direct) == payload
    cs.close()
    jref.close()


def _damaged(tmp_path, rng, n_chunks, damage):
    cs = _chunks(tmp_path, io_threads=4, chunk_size=128, replicas=2)
    payload = rng.bytes(128 * n_chunks)
    digests, _ = cs.put_payload(payload)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    damage(tmp_path / "cs4", digests)
    return cs, payload, digests, crc


def test_read_payload_fixed_heals_corrupt_primary(tmp_path, rng):
    def flip(root, digests):
        victim = root / cas.object_rel(digests[1])
        data = bytearray(victim.read_bytes())
        data[0] ^= 0xFF
        victim.write_bytes(bytes(data))

    cs, payload, digests, crc = _damaged(tmp_path, rng, 4, flip)
    got = cs.read_payload_fixed(digests, len(payload), 128, crc)
    assert bytes(got) == payload
    cs.close()


def test_read_payload_fixed_short_object_falls_back(tmp_path, rng):
    def truncate(root, digests):
        victim = root / cas.object_rel(digests[0])
        victim.write_bytes(victim.read_bytes()[:50])

    cs, payload, digests, crc = _damaged(tmp_path, rng, 3, truncate)
    got = cs.read_payload_fixed(digests, len(payload), 128, crc)
    assert bytes(got) == payload
    cs.close()


def test_read_payload_fixed_serial_engine_uses_join_path(tmp_path, rng):
    cs = _chunks(tmp_path, io_threads=1, chunk_size=128)
    payload = rng.bytes(128 * 2 + 5)
    digests, _ = cs.put_payload(payload)
    got = cs.read_payload_fixed(digests, len(payload), 128,
                                zlib.crc32(payload) & 0xFFFFFFFF)
    assert isinstance(got, bytes)
    assert got == payload
    cs.close()


# ---------------------------------------------------------------------------
# PersistStage
# ---------------------------------------------------------------------------

def test_persist_stage_propagates_error_once():
    stage = PersistStage()
    handled = []

    def boom():
        raise RuntimeError("persist died")

    stage.submit(boom, on_error=handled.append)
    with pytest.raises(RuntimeError, match="persist died"):
        stage.wait()
    stage.wait()
    assert len(handled) == 1


def test_persist_stage_fast_flush_flag():
    stage = PersistStage()
    assert not stage.fast_flush_requested
    stage.request_fast_flush()
    assert stage.fast_flush_requested


def test_payload_ticket_empty_payload():
    t = PayloadTicket(0, 0)
    assert t.done and t.digests == [] and t.crc == 0


def test_persist_stage_runs_queued_rounds_in_order():
    stage = PersistStage(depth=3)
    order = []
    gate = threading.Event()
    stage.submit(lambda: (gate.wait(10), order.append(1)), on_error=print)
    stage.submit(lambda: order.append(2), on_error=print)
    stage.submit(lambda: order.append(3), on_error=print)
    assert stage.inflight == 3 and stage.active
    time.sleep(0.05)
    assert order == []
    gate.set()
    stage.wait()
    assert order == [1, 2, 3]
    assert stage.inflight == 0 and not stage.active


def test_persist_stage_depth_bounds_admission():
    stage = PersistStage(depth=2)
    gate = threading.Event()
    stage.admit()
    stage.submit(lambda: gate.wait(10), on_error=print, reserved=True)
    stage.admit()
    stage.submit(lambda: None, on_error=print, reserved=True)
    blocked = []
    t = threading.Thread(target=lambda: (stage.admit(),
                                         blocked.append(True)),
                         daemon=True)
    t.start()
    t.join(0.2)
    assert t.is_alive() and not blocked
    gate.set()
    t.join(5)
    assert blocked
    stage.release()
    stage.wait()


def test_persist_stage_byte_budget_blocks_third_round():
    stage = PersistStage(depth=8, host_bytes_budget=200)
    gate = threading.Event()
    for _ in range(2):
        stage.admit(100)
        stage.submit(lambda: gate.wait(10), on_error=print, nbytes=100,
                     reserved=True)
    assert stage.inflight_bytes == 200
    blocked = []
    t = threading.Thread(target=lambda: (stage.admit(100),
                                         blocked.append(True),
                                         stage.release(100)),
                         daemon=True)
    t.start()
    t.join(0.2)
    assert t.is_alive() and not blocked
    gate.set()
    t.join(5)
    assert blocked
    stage.wait()
    assert stage.admit(10_000) == pytest.approx(0.0, abs=0.2)
    stage.release(10_000)


def test_persist_stage_release_on_failed_snapshot_frees_the_slot():
    stage = PersistStage(depth=1)
    stage.admit(50)
    stage.release(50)
    assert stage.admit(50) < 0.1
    stage.release(50)


# ---------------------------------------------------------------------------
# the manager's persist queue
# ---------------------------------------------------------------------------

def _queue_flat(**kw):
    kw.setdefault("codec", "raw")
    kw.setdefault("n_writers", 1)
    kw.setdefault("mode", "incremental")
    kw.setdefault("chunk_size", 4096)
    kw.setdefault("io_threads", 4)
    return kw


def _queue_mgr(tmp_path, **kw):
    return eng.mgr_at(tmp_path / "q", **_queue_flat(**kw))


def _np_state(seed, kib=64):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((kib * 256,),
                                                dtype=np.float32)}}


def _slow_store(mgr, gate, entered=None):
    orig = mgr.chunks.store_chunk

    def slow(digest, data, crash=None, dirs=None, dirs_lock=None):
        if entered is not None:
            entered.set()
        gate.wait(10)
        return orig(digest, data, crash or cas.NO_CRASH, dirs, dirs_lock)

    mgr.chunks.store_chunk = slow


def test_manager_queue_depth2_admits_round_while_prior_persists(tmp_path):
    """Depth 2: the second async save is admitted while round 1 persists;
    both commit, restore bit-exact, and hold the reference's bytes."""
    mgr = _queue_mgr(tmp_path, persist_queue_depth=2)
    gate = threading.Event()
    entered = threading.Event()
    _slow_store(mgr, gate, entered)
    s1, s2 = _np_state(1), _np_state(2)
    mgr.save(eng.torch_state(s1), 1, blocking=False)
    assert entered.wait(5)
    t0 = time.monotonic()
    mgr.save(eng.torch_state(s2), 2, blocking=False)
    assert time.monotonic() - t0 < 5.0
    assert mgr._persist.inflight == 2
    gate.set()
    mgr.wait()
    for step, st in ((1, s1), (2, s2)):
        restored, _ = mgr.restore(eng.abstract(eng.torch_state(st)),
                                  step=step)
        eng.assert_bits(restored, st)
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    jm = eng.jmgr_at(tmp_path / "ref", **_queue_flat(persist_queue_depth=2))
    for step, st in ((1, s1), (2, s2)):
        jm.save(eng.jax_state(st), step, blocking=False)
    jm.wait()
    eng.assert_same_store(mgr.store.root, jm.store.root)
    mgr.close()
    jm.close()


def test_manager_byte_budget_blocks_third_snapshot(tmp_path):
    s = {n: _np_state(n) for n in (1, 2, 3)}
    per_round = estimate_snapshot_bytes(eng.torch_state(s[1]))
    assert per_round == jsave.estimate_snapshot_bytes(eng.jax_state(s[1]))
    mgr = _queue_mgr(tmp_path, persist_queue_depth=3,
                     host_bytes_budget=2 * per_round)
    snapshots = []
    orig_snap = mgr._snapshot
    mgr._snapshot = lambda state: (snapshots.append(1),
                                   orig_snap(state))[1]
    gate = threading.Event()
    _slow_store(mgr, gate)
    mgr.save(eng.torch_state(s[1]), 1, blocking=False)
    mgr.save(eng.torch_state(s[2]), 2, blocking=False)
    assert len(snapshots) == 2
    third_done = threading.Event()
    t = threading.Thread(
        target=lambda: (mgr.save(eng.torch_state(s[3]), 3, blocking=False),
                        third_done.set()), daemon=True)
    t.start()
    t.join(0.3)
    assert t.is_alive() and len(snapshots) == 2
    gate.set()
    assert third_done.wait(30)
    assert len(snapshots) == 3
    mgr.wait()
    assert sorted(s_ for s_ in (1, 2, 3)
                  if (mgr.store.root / f"step_{s_:08d}").exists()) == \
        [1, 2, 3]
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    mgr.close()


def test_serial_engine_policy_pins_queue_depth_to_one(tmp_path):
    mgr = _queue_mgr(tmp_path, io_threads=1, persist_queue_depth=4)
    assert mgr._persist.depth == 1
    mgr.close()


def test_estimate_snapshot_bytes_counts_every_leaf():
    st = eng.np_state()
    assert estimate_snapshot_bytes(eng.torch_state(st)) == \
        sum(a.nbytes for _, a in eng.leaf_paths(st)) == \
        jsave.estimate_snapshot_bytes(eng.jax_state(st))
