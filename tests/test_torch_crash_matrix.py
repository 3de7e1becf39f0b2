"""The crash matrix on the port's commit/GC protocol, held against
``tests/test_crash_matrix.py``: its ``POINTS`` × ``MODE_AXES`` and
``OVERLAP_POINTS`` (imported from that module, so the two cannot drift),
at ``CRASH_MATRIX_IO_THREADS`` as there, on the reference's states carried
across by ``convert.from_jax_state``. After every simulated crash every
committed step restores bit-exact, ``latest_step`` names the newest
committed step, one recovery GC leaves the CAS clean under fsck, and the
next save commits. Also the repeated-crash history, the queued round
behind a crashed one, the preempt fast-flush and the abort of an
overlapped round."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import test_crash_matrix as ref
from repro_torch.convert import from_jax_state
from repro_torch.core import atomic
from repro_torch.core import cas as cas_mod
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.errors import AbortedError
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.preempt import PreemptionGuard
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore

IO_THREADS = ref.IO_THREADS


def _store(tmp_path):
    return TieredStore(Tier("fast", tmp_path / "fast"))


def _state(seed: int) -> dict:
    """The reference's ``_state(seed)``, bit for bit, as tensors."""
    return from_jax_state(jax.tree.map(np.asarray, ref._state(seed)),
                          device="cpu")


def _abstract(state):
    if isinstance(state, dict):
        return {k: _abstract(v) for k, v in state.items()}
    return torch.empty_like(state, device="meta")


def _bits(t):
    view = {torch.float32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def _assert_restores(mgr, step, expect):
    restored, _ = mgr.restore(_abstract(expect), step=step)
    for (name, a), (_, b) in zip(leaf_paths(expect), leaf_paths(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


def _policy(**flat):
    flat.setdefault("keepalive_s", 60.0)
    return CheckpointPolicy().with_overrides(**flat)


@pytest.mark.parametrize("mode,chunking", ref.MODE_AXES)
@pytest.mark.parametrize("point", ref.POINTS)
def test_crash_matrix(tmp_path, mode, chunking, point):
    def mk(**kw):
        return CheckpointManager(_store(tmp_path), _policy(
            n_writers=2, codec="raw", mode=mode, chunk_size=512,
            chunking=chunking, retain=1, max_retries=0,
            io_threads=IO_THREADS, **kw), device="cpu")

    states = {1: _state(1), 2: _state(2)}
    mk().save(states[1], 1)
    try:
        mk().save(states[2], 2, crash=CrashInjector(point))
        crashed = False
    except (CrashPoint, AbortedError):
        crashed = True

    mgr = mk()
    mgr.gc()
    committed = atomic.list_committed_steps(mgr.store.root)
    assert committed, "no committed checkpoint survived the crash"
    assert committed[0] >= 1 and committed[-1] <= 2
    latest = mgr.latest_step()
    assert latest == committed[-1]
    for s in committed:
        _assert_restores(mgr, s, states[s])
    fsck = mgr.chunks.fsck(mgr._live_chunk_refs())
    assert fsck["ok"], (point, mode, fsck)
    if mode == "full" and not crashed:
        assert fsck["objects"] == 0
    nxt = latest + 1
    states[nxt] = _state(nxt)
    assert mgr.save(states[nxt], nxt)["step"] == nxt
    _assert_restores(mgr, nxt, states[nxt])
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]


@pytest.mark.parametrize("mode,chunking", ref.MODE_AXES)
def test_repeated_crashes_then_recovery(tmp_path, mode, chunking):
    def mk():
        return CheckpointManager(_store(tmp_path), _policy(
            n_writers=2, codec="raw", mode=mode, chunk_size=512,
            chunking=chunking, retain=2, max_retries=0,
            io_threads=IO_THREADS), device="cpu")

    mk().save(_state(0), 1)
    good = {1: _state(0)}
    step = 2
    for point in ["cas_mid_batch", "cas_before_batch_fsync",
                  "rank0_after_chunk_write", "before_manifest",
                  "before_latest_write", "mid_gc_sweep"]:
        nxt = _state(step)
        try:
            mk().save(nxt, step, crash=CrashInjector(point))
            good[step] = nxt
        except (CrashPoint, AbortedError):
            pass
        mgr = mk()
        committed = atomic.list_committed_steps(mgr.store.root)
        assert committed
        newest = committed[-1]
        if newest in good:
            _assert_restores(mgr, newest, good[newest])
        mgr.gc()
        assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
        step += 1
    mgr = mk()
    final = _state(99)
    mgr.save(final, step)
    _assert_restores(mgr, step, final)
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]


# ---------------------------------------------------------------------------
# overlapped (async-persist) rounds
# ---------------------------------------------------------------------------

def _mk_overlap(tmp_path, **kw):
    kw.setdefault("retain", 1)
    kw.setdefault("io_threads", IO_THREADS)
    return CheckpointManager(_store(tmp_path), _policy(
        n_writers=2, codec="raw", mode="incremental", chunk_size=512,
        max_retries=0, **kw), device="cpu")


@pytest.mark.parametrize("point", ref.OVERLAP_POINTS)
def test_crash_matrix_overlapped_persist(tmp_path, point):
    states = {1: _state(1), 2: _state(2)}
    _mk_overlap(tmp_path).save(states[1], 1)
    mgr = _mk_overlap(tmp_path)
    rep = mgr.save(states[2], 2, blocking=False, crash=CrashInjector(point))
    assert rep["async"] and rep["step"] == 2
    try:
        mgr.wait()
        crashed = False
    except (CrashPoint, AbortedError):
        crashed = True
    if point not in ("cas_mid_batch", "cas_before_batch_fsync"):
        assert crashed, f"{point} never fired on the persist stage"
    assert mgr.counters.drained()

    rec = _mk_overlap(tmp_path)
    rec.gc()
    committed = atomic.list_committed_steps(rec.store.root)
    assert committed, "no committed checkpoint survived the crash"
    latest = rec.latest_step()
    assert latest == committed[-1]
    for s in committed:
        _assert_restores(rec, s, states[s])
    fsck = rec.chunks.fsck(rec._live_chunk_refs())
    assert fsck["ok"], (point, fsck)
    nxt = latest + 1
    states[nxt] = _state(nxt)
    assert rec.save(states[nxt], nxt)["step"] == nxt
    _assert_restores(rec, nxt, states[nxt])
    assert rec.chunks.fsck(rec._live_chunk_refs())["ok"]


def test_crash_in_queued_round_leaks_nothing_and_later_round_lands(
        tmp_path):
    mgr = _mk_overlap(tmp_path, persist_queue_depth=2, retain=8,
                      io_threads=max(IO_THREADS, 2))
    states = {1: _state(1), 2: _state(2), 3: _state(3)}
    mgr.save(states[1], 1)
    gate = threading.Event()
    orig = mgr.chunks.store_chunk

    def slow(digest, data, crash=None, dirs=None, dirs_lock=None):
        gate.wait(10)
        return orig(digest, data, crash or cas_mod.NO_CRASH, dirs,
                    dirs_lock)

    mgr.chunks.store_chunk = slow
    mgr.save(states[2], 2, blocking=False,
             crash=CrashInjector("before_manifest"))
    mgr.save(states[3], 3, blocking=False)
    gate.set()
    with pytest.raises(CrashPoint):
        mgr.wait()
    mgr.wait()
    assert mgr.counters.drained()
    mgr2 = _mk_overlap(tmp_path / "p", persist_queue_depth=2,
                       io_threads=max(IO_THREADS, 2))
    mgr2.save(states[1], 1)
    mgr2.save(states[2], 2, blocking=False,
              crash=CrashInjector("before_manifest"))
    deadline = time.monotonic() + 10
    while mgr2._persist.active and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(CrashPoint):
        mgr2.save(states[3], 3, blocking=False)

    rec = _mk_overlap(tmp_path, persist_queue_depth=2, retain=8)
    rec.gc()
    committed = atomic.list_committed_steps(rec.store.root)
    assert committed == [1, 3]
    assert rec.latest_step() == 3
    for s in committed:
        _assert_restores(rec, s, states[s])
    assert rec.chunks.fsck(rec._live_chunk_refs())["ok"]


def test_preempt_during_persist_fast_flush(tmp_path):
    mgr = _mk_overlap(tmp_path)
    states = {1: _state(1), 2: _state(2)}
    mgr.save(states[1], 1)
    guard = PreemptionGuard()
    guard.add_callback(mgr.request_fast_flush)
    guard.request()
    rep = mgr.save(states[2], 2, blocking=False)
    assert rep["async"]
    mgr.wait()
    assert mgr.last_report["step"] == 2
    assert mgr.last_gc_report == {"skipped": True, "reason": "fast-flush"}
    _assert_restores(mgr, 2, states[2])
    assert mgr.latest_step() == 2
    assert not mgr._persist.fast_flush_requested
    states[3] = _state(3)
    mgr.save(states[3], 3, blocking=False)
    mgr.wait()
    assert mgr.last_gc_report.get("reason") != "fast-flush"
    assert mgr.last_gc_report["steps_dropped"]
    mgr.gc()
    assert atomic.list_committed_steps(mgr.store.root) == [3]
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    _assert_restores(mgr, 3, states[3])


def test_abort_of_overlapped_round_leaks_nothing(tmp_path):
    mgr = _mk_overlap(tmp_path)
    states = {1: _state(1)}
    mgr.save(states[1], 1)
    baseline = mgr.chunks.fsck(mgr._live_chunk_refs())["objects"]
    for r in range(2):
        mgr.coordinator.inject_failure(r)
    with pytest.raises(AbortedError):
        mgr.save(_state(2), 2, blocking=False)
        mgr.wait()
    assert mgr.counters.drained()
    assert not list(mgr.store.root.glob("*.tmp-*"))
    assert mgr.latest_step() == 1
    mgr.gc()
    fsck = mgr.chunks.fsck(mgr._live_chunk_refs())
    assert fsck["ok"]
    assert fsck["objects"] == baseline
    _assert_restores(mgr, 1, states[1])
