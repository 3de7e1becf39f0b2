"""Typed IO-failure handling for the tiered store — the paper's
production-hardening lesson applied to storage: a flaky filesystem, a
filling burst buffer or a slow metadata server must degrade a checkpoint
round, not abort it.

Three small primitives, consumed by ``storage``/``cas``/``save_path``/
``restore_path``:

  * **classification** — ``is_transient`` / ``is_tier_full`` split
    ``OSError`` into errors worth retrying on the SAME tier (EIO, EAGAIN,
    EBUSY, NFS staleness, timeouts), errors that condemn the tier for
    this round (ENOSPC / EDQUOT / EROFS — retrying a full disk is just a
    slower failure; the caller fails over to the next tier), and
    everything else (permanent: raise immediately);
  * **bounded retry** — ``retry_io`` with decorrelated-jitter backoff
    (AWS-style: ``sleep ~ U(base, 3·prev)``, capped) under a
    ``Deadline`` budget, so a round's aggregate retry stall is bounded
    by ``DurabilityPolicy.io_deadline_s`` rather than
    retries × sites × backoff;
  * **per-tier circuit breaker** — ``CircuitBreaker`` opens after a run
    of consecutive errors and readers/writers deprioritize (never hard-
    skip) the tier until a half-open probe succeeds; ``TierHealth``
    aggregates the breaker with per-op error/retry counters for
    ``inspect_ckpt --health``.

The serial (``io_threads=1``) engine never constructs a retry policy —
it keeps the serial engine's fail-fast semantics byte-for-byte; every helper here
treats ``policy=None`` as "call the function once, raise what it
raises".
"""
from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass

# errors worth retrying against the SAME tier: the device may answer the
# next attempt (EIO covers the flaky-NFS / dying-disk reads the paper's
# production runs hit; ESTALE/EREMOTEIO are their NFS spellings)
TRANSIENT_ERRNOS = frozenset(
    e for e in (errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
                errno.ETIMEDOUT, getattr(errno, "ESTALE", None),
                getattr(errno, "EREMOTEIO", None))
    if e is not None)

# errors that condemn the tier for the rest of the round: retrying a
# full or read-only filesystem is just a slower failure — the caller
# should fail over to the next tier instead
TIER_FULL_ERRNOS = frozenset(
    e for e in (errno.ENOSPC, getattr(errno, "EDQUOT", None), errno.EROFS)
    if e is not None)


class RemoteInconsistencyError(OSError):
    """An object store answered, but inconsistently: a multipart ranged
    GET came back short (``truncated_get``) or the HEAD-advertised size
    disagreed with the GET body (``stale_head`` — read-after-overwrite
    staleness). Both are the remote-tier spellings of "ask again": the
    object itself is content-addressed and immutable, so a re-issued
    request against a healed replica returns the right bytes. Typed as
    ``OSError(EIO)`` so every existing errno-based classifier already
    treats it as transient; carried as its own class so callers (and
    tests) can tell a remote protocol inconsistency from a dying local
    disk."""

    def __init__(self, msg: str, *, rel: str | None = None,
                 kind: str = "inconsistent"):
        super().__init__(errno.EIO, msg)
        self.rel = rel
        self.kind = kind


def is_transient(exc: BaseException) -> bool:
    """True for errors a bounded same-tier retry may absorb. ENOSPC is
    deliberately included: transient space pressure (a concurrent GC or
    eviction freeing the burst buffer) is common, and the retry budget
    bounds the cost when it is not transient — callers that can fail
    over check ``is_tier_full`` AFTER retries are exhausted."""
    return isinstance(exc, OSError) and \
        (exc.errno in TRANSIENT_ERRNOS or exc.errno in TIER_FULL_ERRNOS)


def is_tier_full(exc: BaseException) -> bool:
    """True when the error condemns the TIER (full / quota / read-only),
    i.e. failing over to the next tier is the productive response."""
    return isinstance(exc, OSError) and exc.errno in TIER_FULL_ERRNOS


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded same-tier retry: up to `retries` re-attempts, decorrelated
    jitter starting at `backoff_ms`, all attempts of a round sharing one
    `deadline_s` IO budget (see ``ChunkStore.begin_io_window``)."""
    retries: int = 2
    backoff_ms: float = 5.0
    deadline_s: float = 30.0

    @classmethod
    def from_durability(cls, durability) -> "RetryPolicy":
        return cls(retries=int(durability.io_retries),
                   backoff_ms=float(durability.io_backoff_ms),
                   deadline_s=float(durability.io_deadline_s))


class Deadline:
    """Monotonic time budget shared across every retry loop of one round
    — the aggregate stall bound. ``budget_s=None`` never expires."""

    def __init__(self, budget_s: float | None,
                 clock=time.monotonic):
        self._clock = clock
        self._until = None if budget_s is None else clock() + float(budget_s)

    def remaining(self) -> float:
        if self._until is None:
            return float("inf")
        return self._until - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0


# jitter source for the backoff — nondeterministic on purpose (it decides
# only how long to sleep, never what happens), so concurrent writers
# hitting the same sick tier don't retry in lockstep
_jitter = random.Random()


def retry_io(fn, policy: RetryPolicy | None, *, deadline: Deadline | None
             = None, health: "TierHealth | None" = None, op: str = "io",
             classify=is_transient, sleep=time.sleep):
    """Run `fn`, retrying transient ``OSError`` up to ``policy.retries``
    times with decorrelated-jitter backoff, never sleeping past
    `deadline`. ``policy=None`` (the serial engine) calls `fn` exactly
    once. Only ``OSError`` is ever caught — injected crash points,
    corruption errors and everything typed stay fail-fast. `health`
    records each attempt's outcome for the per-tier counters/breaker."""
    if policy is None:
        return fn()
    if deadline is None:
        deadline = Deadline(policy.deadline_s)
    base = max(float(policy.backoff_ms), 0.0) / 1000.0
    prev = base
    attempt = 0
    while True:
        try:
            out = fn()
        except OSError as e:
            if health is not None:
                health.record_error(op)
            if not classify(e) or attempt >= int(policy.retries) \
                    or deadline.expired():
                raise
            attempt += 1
            if health is not None:
                health.note_retry(op)
            # decorrelated jitter: sleep ~ U(base, 3·prev), capped at
            # 100× base and at the remaining deadline budget
            prev = _jitter.uniform(base, max(prev * 3.0, base))
            prev = min(prev, base * 100.0 if base else 0.0)
            pause = min(prev, max(deadline.remaining(), 0.0))
            if pause > 0:
                sleep(pause)
            continue
        if health is not None:
            health.record_ok(op)
        return out


class CircuitBreaker:
    """Consecutive-failure breaker with a cooldown + half-open probe.

    ``allow()`` answers "should this tier be PREFERRED right now" —
    callers deprioritize an open tier (try the others first), they never
    hard-skip it, so a store whose every tier is sick still serves the
    last-resort read. After `cooldown_s` the breaker half-opens: traffic
    is allowed again, one success closes it, one failure re-arms the
    cooldown."""

    def __init__(self, threshold: int = 8, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive = 0
        self._opened_at: float | None = None
        self._trips = 0

    def record_ok(self):
        with self._lock:
            self._consecutive = 0
            self._opened_at = None

    def record_error(self):
        with self._lock:
            self._consecutive += 1
            if self._consecutive >= self.threshold:
                if self._opened_at is None:
                    self._trips += 1
                # an error while open (or half-open) re-arms the cooldown
                self._opened_at = self._clock()

    def allow(self) -> bool:
        return self.state != "open"

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._clock() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips


class TierHealth:
    """Per-tier error accounting: op-keyed ok/error/retry counters plus
    the circuit breaker. One instance per tier, owned by the
    ``TieredStore`` (``health_for``); snapshots feed ``_CAS/health.json``
    and ``inspect_ckpt --health``."""

    def __init__(self, name: str, breaker: CircuitBreaker | None = None):
        self.name = name
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._lock = threading.Lock()
        self._counters: dict = {}

    def _bump(self, key: str):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + 1

    def record_ok(self, op: str):
        self._bump(f"{op}_ok")
        self.breaker.record_ok()

    def record_error(self, op: str):
        self._bump(f"{op}_errors")
        self.breaker.record_error()

    def note_retry(self, op: str):
        self._bump(f"{op}_retries")

    def note(self, key: str):
        """Free-form event counter (e.g. degraded failover writes)."""
        self._bump(key)

    def allow(self) -> bool:
        return self.breaker.allow()

    @property
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> dict:
        return {"counters": self.counters,
                "breaker": {"state": self.breaker.state,
                            "trips": self.breaker.trips,
                            "threshold": self.breaker.threshold,
                            "cooldown_s": self.breaker.cooldown_s}}
