"""Checkpoint coordinator — the DMTCP-coordinator analogue, production-
hardened per the paper: KeepAlive heartbeats (lost TCP packets / network
quiescence), explicit locks around every shared structure (the paper's
missing-locks races), two-phase commit, straggler detection, and failure
injection for tests.

Ranks here are writer workers (threads standing in for per-host writer
agents); the protocol — REGISTER → PREPARE(write shards) → ACK → COMMIT /
ABORT — is transport-independent, exactly as MANA's coordinator protocol is
MPI-independent.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from enum import Enum

from .errors import AbortedError, warn


class RankState(Enum):
    IDLE = "idle"
    PREPARING = "preparing"
    PREPARED = "prepared"
    FAILED = "failed"


@dataclass
class RankInfo:
    rank: int
    state: RankState = RankState.IDLE
    last_heartbeat: float = field(default_factory=time.monotonic)
    bytes_written: int = 0
    files: list = field(default_factory=list)
    chunks: Counter = field(default_factory=Counter)   # CAS digests referenced
    node: str = ""          # rank-to-node mapping (paper's debug instrumentation)


class Round:
    """One two-phase-commit checkpoint round."""

    def __init__(self, step: int, participants, overlapped: bool = False):
        self.step = step
        self.participants = set(participants)
        # True when the round persists in the background (async save) —
        # the training thread has already moved on past the snapshot
        self.overlapped = overlapped
        self.aborted = False
        self.abort_reason = ""
        self.prepared = set()
        self.failed = set()
        # CAS refcount delta accumulated from prepared ranks; published
        # atomically iff the round COMMITs (abort publishes nothing, so an
        # aborted round's chunk objects are orphans for the next GC sweep —
        # never counted references).
        self.chunk_refs: Counter = Counter()

    def done(self):
        return self.aborted or self.prepared >= self.participants


class CheckpointCoordinator:
    def __init__(self, n_ranks: int, *, keepalive_s: float = 10.0,
                 straggler_factor: float = 3.0, node_fmt: str = "nid{:05d}",
                 clock=time.monotonic):
        self.n_ranks = n_ranks
        self.keepalive_s = keepalive_s
        self.straggler_factor = straggler_factor
        # injectable monotonic clock: every keepalive/straggler decision
        # reads THIS, so timing tests advance a fake clock instead of
        # sleeping real wall-clock (which flakes on slow CI hosts)
        self._clock = clock
        self._lock = threading.Lock()          # paper: no unlocked shared state
        self._cv = threading.Condition(self._lock)
        self.ranks = {r: RankInfo(r, node=node_fmt.format(r))
                      for r in range(n_ranks)}
        for ri in self.ranks.values():
            ri.last_heartbeat = self._clock()
        self.round: Round | None = None
        self.history: list = []
        self.metrics = {"rounds": 0, "commits": 0, "aborts": 0,
                        "keepalive_timeouts": 0, "stragglers_flagged": 0}
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        # failure injection (tests)
        self._inject_fail: set = set()
        self._inject_delay: dict = {}

    # ------------------------------------------------------------------
    # failure injection API (tests / chaos drills)
    # ------------------------------------------------------------------
    def inject_failure(self, rank: int):
        with self._lock:
            self._inject_fail.add(rank)

    def inject_delay(self, rank: int, seconds: float):
        with self._lock:
            self._inject_delay[rank] = seconds

    # ------------------------------------------------------------------
    # rank-side API (called from writer threads)
    # ------------------------------------------------------------------
    def heartbeat(self, rank: int):
        with self._lock:
            self.ranks[rank].last_heartbeat = self._clock()

    def rank_begin(self, rank: int):
        with self._lock:
            delay = self._inject_delay.get(rank, 0.0)
            fail = rank in self._inject_fail
            self.ranks[rank].state = RankState.PREPARING
            self.ranks[rank].last_heartbeat = self._clock()
        if delay:
            time.sleep(delay)
        if fail:
            raise RuntimeError(f"injected failure on rank {rank}")

    def rank_prepared(self, rank: int, *, nbytes: int, files: list,
                      chunks=None):
        """`chunks`: digest→refcount Counter of every CAS chunk the rank's
        shards reference this round (dedup hits included — refcounts track
        references, not writes)."""
        with self._cv:
            ri = self.ranks[rank]
            ri.state = RankState.PREPARED
            ri.bytes_written = nbytes
            ri.files = files
            ri.chunks = Counter(chunks or {})
            ri.last_heartbeat = self._clock()
            if self.round and not self.round.aborted:
                self.round.prepared.add(rank)
                self.round.chunk_refs.update(ri.chunks)
            self._cv.notify_all()

    def rank_failed(self, rank: int, reason: str):
        with self._cv:
            self.ranks[rank].state = RankState.FAILED
            if self.round:
                self.round.failed.add(rank)
                self.round.aborted = True
                self.round.abort_reason = f"rank {rank}: {reason}"
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # coordinator-side API
    # ------------------------------------------------------------------
    def begin_round(self, step: int, participants=None,
                    overlapped: bool = False) -> Round:
        """participants: rank ids taking part (retry rounds exclude ranks
        declared dead — the node-failure recovery path). ``overlapped``
        marks a round whose persist runs behind training compute."""
        with self._lock:
            assert self.round is None or self.round.done(), \
                "previous round still active"
            if participants is None:
                participants = range(self.n_ranks)
            self.round = Round(step, participants, overlapped=overlapped)
            for ri in self.ranks.values():
                ri.state = RankState.IDLE
                ri.last_heartbeat = self._clock()
            self.metrics["rounds"] += 1
        self._start_monitor()
        return self.round

    def wait_all_prepared(self, timeout: float | None = None) -> bool:
        """Barrier for phase 1. Returns True iff every rank acked PREPARED."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self.round.done():
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self.round.aborted = True
                    self.round.abort_reason = "phase-1 barrier timeout"
                    break
                self._cv.wait(remaining if remaining is None
                              else min(remaining, 0.1))
            ok = not self.round.aborted
        self._stop_monitor()
        return ok

    def finish_round(self, committed: bool, publish_refs=None):
        """COMMIT/ABORT. On COMMIT, `publish_refs` (if given) is invoked
        under the coordinator lock with the round's aggregated chunk-ref
        delta — the single atomic refcount publication point. On ABORT the
        delta is dropped: an abort leaks no references."""
        with self._lock:
            r = self.round
            self.metrics["commits" if committed else "aborts"] += 1
            if r.overlapped:
                self.metrics["overlapped_rounds"] = \
                    self.metrics.get("overlapped_rounds", 0) + 1
            self.history.append({
                "step": r.step, "committed": committed,
                "reason": r.abort_reason, "overlapped": r.overlapped,
                "bytes": sum(ri.bytes_written for ri in self.ranks.values()),
                "chunk_refs": sum(r.chunk_refs.values()),
            })
            self.round = None
            if committed and publish_refs is not None:
                self.metrics["ref_publishes"] = \
                    self.metrics.get("ref_publishes", 0) + 1
                publish_refs(dict(r.chunk_refs))

    def abort_reason(self) -> str:
        with self._lock:
            return self.round.abort_reason if self.round else ""

    def raise_if_aborted(self):
        with self._lock:
            if self.round and self.round.aborted:
                raise AbortedError("checkpoint round aborted",
                                   step=self.round.step,
                                   reason=self.round.abort_reason)

    # ------------------------------------------------------------------
    # keepalive monitor (paper: TCP KeepAlive fix for silent disconnects)
    # ------------------------------------------------------------------
    def _start_monitor(self):
        self._stop.clear()
        self._monitor = threading.Thread(target=self._watch, daemon=True)
        self._monitor.start()

    def _stop_monitor(self):
        self._stop.set()
        if self._monitor:
            self._monitor.join()
            self._monitor = None

    def _watch(self):
        t0 = self._clock()
        while not self._stop.is_set():
            # the poll cadence is real time (the monitor must keep waking),
            # but every timeout decision reads the injectable clock
            time.sleep(min(self.keepalive_s / 20, 0.05))
            now = self._clock()
            with self._cv:
                if self.round is None or self.round.done():
                    return
                for ri in self.ranks.values():
                    if ri.state == RankState.PREPARING and \
                            now - ri.last_heartbeat > self.keepalive_s:
                        self.metrics["keepalive_timeouts"] += 1
                        self.round.failed.add(ri.rank)
                        self.round.aborted = True
                        self.round.abort_reason = (
                            f"keepalive timeout on rank {ri.rank} "
                            f"({ri.node})")
                        self._cv.notify_all()
                        return
                # straggler flagging: a rank much slower than the median
                done = [r for r in self.ranks.values()
                        if r.state == RankState.PREPARED]
                if 0 < len(done) < self.n_ranks:
                    elapsed = now - t0
                    if elapsed > self.straggler_factor * max(
                            self.keepalive_s / 10, 0.05) and done:
                        lagging = [r.rank for r in self.ranks.values()
                                   if r.state == RankState.PREPARING]
                        if lagging:
                            self.metrics["stragglers_flagged"] += len(lagging)
                            warn("CKPT_W_STRAGGLER",
                                 "slow writer ranks detected",
                                 ranks=lagging[:8], elapsed=round(elapsed, 3))
                            t0 = now  # don't spam
