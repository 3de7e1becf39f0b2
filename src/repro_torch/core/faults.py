"""Deterministic storage fault injection — the IO counterpart of the
crash matrix (``atomic.CrashInjector``).

The crash injector kills the PROCESS at named points; this plane makes
the STORAGE misbehave underneath a process that keeps running — the
failure modes the paper's production runs actually hit (flaky Lustre
reads, a filling DataWarp allocation, bit-rot between write and
restart) and that a fail-fast stack turns into aborted rounds.

Every fault site is addressable by ``(op, tier, match, nth)``:

  * ``op``     — ``"read"`` (any read entry: ``read_file`` or
    ``read_into``), ``"read_file"`` / ``"read_into"`` (that entry only),
    ``"write"`` (``write_file``, including the CAS tmp writes), or
    ``"free"`` (``free_bytes`` — capacity preflight);
  * ``tier``   — tier name, or ``"*"`` for any tier;
  * ``match``  — substring of the storage-relative path (``""`` = all);
  * ``nth``    — the 1-based index of the matching call that fires, and
    ``count`` how many consecutive matching calls keep firing
    (``count=-1`` = every one from `nth` on — a persistent fault).

A ``FaultPlane`` holds the schedule and a seeded RNG (bit-rot offsets,
randomized schedules), so every failure a test or bench observes is
replayable from ``(seed, schedule)`` alone. ``FaultyTier`` wraps a
``storage.Tier`` and applies the schedule; ``wrap_store`` wraps every
tier of a ``TieredStore`` in place.

Fault kinds:

  ``eio``          read/write raises ``OSError(EIO)`` (``read_into``
                   honours the Tier contract: counts + returns False)
  ``enospc``       write raises ``OSError(ENOSPC)`` (transient when
                   ``count`` is small, a full tier when persistent)
  ``erofs``        write raises ``OSError(EROFS)`` — tier went read-only
  ``short_write``  a truncated prefix lands, THEN the write errors —
                   the torn write a caller can see and retry
  ``torn_write``   a truncated prefix lands silently — the torn write
                   only a scrub or an end-to-end check can see
  ``bitrot``       write: the file is written fully, then ONE byte (at a
                   seeded offset) is flipped on disk; read: the returned
                   bytes are flipped in memory (transient corruption)
  ``latency``      the op sleeps ``latency_s`` first, then proceeds
  ``vanish``       read: the file is deleted before the read proceeds
  ``full``         ``free_bytes`` reports 0 (capacity preflight fails)
  ``truncated_get``  remote ranged GET (``read_range``) returns short: a
                   prefix of the part lands, then False — the multipart
                   truncation an S3 connection reset produces
  ``stale_head``   remote HEAD/GET disagreement: ``read_into`` sees a
                   size mismatch (counts + False), ``read_file`` raises
                   the typed transient ``RemoteInconsistencyError`` —
                   read-after-overwrite staleness
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass, field

FAULT_KINDS = ("eio", "enospc", "erofs", "short_write", "torn_write",
               "bitrot", "latency", "vanish", "full",
               "truncated_get", "stale_head")
READ_OPS = ("read", "read_file", "read_into")
# read_range is NOT folded under the "read" alias: a multipart GET would
# advance a generic read spec's match counter once per PART, silently
# reshaping every existing schedule — per-part faults are addressed
# explicitly by op="read_range"
_OPS = ("read", "read_file", "read_into", "read_range", "write", "free")


@dataclass
class FaultSpec:
    """One addressable fault site. Mutable on purpose: the plane tracks
    per-spec match/fire counts here so a schedule is also its own
    replay log."""
    op: str
    kind: str
    tier: str = "*"
    match: str = ""
    nth: int = 1
    count: int = 1              # consecutive firings; -1 = persistent
    latency_s: float = 0.005
    matched: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {self.op!r}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if int(self.nth) < 1:
            raise ValueError("nth is 1-based and must be >= 1")

    @property
    def key(self) -> tuple:
        return (self.op, self.tier, self.match, self.nth)


class FaultPlane:
    """A seeded, replayable fault schedule shared by every ``FaultyTier``
    of a store. Thread-safe: writer ranks and pool workers poll it
    concurrently."""

    def __init__(self, specs=(), seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.specs: list[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s)
            for s in specs]
        self.log: list[tuple] = []      # (op, tier, rel, kind, key)

    def add(self, op: str, kind: str, **kw) -> FaultSpec:
        spec = FaultSpec(op=op, kind=kind, **kw)
        with self._lock:
            self.specs.append(spec)
        return spec

    def clear(self):
        with self._lock:
            self.specs.clear()

    def poll(self, ops, tier: str, rel: str) -> FaultSpec | None:
        """Advance match counters for every spec matching ``(ops, tier,
        rel)`` and return the first spec inside its firing window. One
        call = one matched IO, whichever op alias it arrives under."""
        if isinstance(ops, str):
            ops = (ops,)
        hit = None
        with self._lock:
            for spec in self.specs:
                if spec.op not in ops:
                    continue
                if spec.tier != "*" and spec.tier != tier:
                    continue
                if spec.match and spec.match not in rel:
                    continue
                spec.matched += 1
                if hit is not None:
                    continue        # counters advance; first hit wins
                past = spec.matched - spec.nth
                if past >= 0 and (spec.count < 0 or past < spec.count):
                    spec.fired += 1
                    hit = spec
                    self.log.append((spec.op, tier, rel, spec.kind,
                                     spec.key))
        return hit

    def fired(self) -> list:
        with self._lock:
            return list(self.log)

    def rot_offset(self, n: int) -> int:
        """Seeded byte offset for a bit-rot fault over an n-byte file."""
        with self._lock:
            return self.rng.randrange(n) if n > 0 else 0

    # a catalog of recoverable fault shapes for randomized chaos runs:
    # every entry targets the fast tier with a bounded window, so a store
    # with a slow tier (and the pipelined engine's retries) must always
    # converge to a bit-exact restore
    RANDOM_CATALOG = (
        ("write", "eio"), ("write", "enospc"), ("write", "short_write"),
        ("write", "latency"), ("read", "eio"), ("read", "short_write"),
        ("read", "bitrot"), ("read", "latency"), ("read", "vanish"),
    )

    @classmethod
    def random_schedule(cls, seed: int, n: int = 4,
                        tier: str = "fast", match: str = ".obj") \
            -> "FaultPlane":
        """A deterministic function of `seed`: `n` transient faults drawn
        from ``RANDOM_CATALOG`` at randomized positions — the chaos-smoke
        schedule. Replaying the seed replays the exact schedule."""
        rng = random.Random(int(seed))
        plane = cls(seed=int(seed))
        for _ in range(max(int(n), 1)):
            op, kind = rng.choice(cls.RANDOM_CATALOG)
            if op == "read" and kind == "short_write":
                kind = "eio"        # short_write is a write-side kind
            plane.add(op, kind, tier=tier, match=match,
                      nth=rng.randint(1, 12), count=rng.randint(1, 2),
                      latency_s=0.002)
        return plane


def _eio(rel):
    return OSError(errno.EIO, "injected EIO", rel)


class FaultyTier:
    """Transparent fault-applying wrapper around a ``storage.Tier`` (or
    ``RemoteTier``). Everything not overridden delegates to the wrapped
    tier — including attribute writes, so policy adoption
    (``store.remote.part_bytes = ...``) keeps working. Composes under
    ``TieredStore`` by identity: ``wrap_store`` REPLACES ``store.fast``/
    ``slow``/``remote``, so ``tier is store.fast`` checks hold."""

    def __init__(self, tier, plane: FaultPlane):
        self.__dict__["_inner"] = tier
        self.__dict__["_plane"] = plane

    @property
    def inner(self):
        return self._inner

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def __setattr__(self, name, value):
        setattr(self.__dict__["_inner"], name, value)

    # --- faulted ops ---------------------------------------------------
    def free_bytes(self) -> int:
        spec = self._plane.poll("free", self._inner.name, "")
        if spec is not None and spec.kind == "full":
            return 0
        return self._inner.free_bytes()

    def preflight(self, required_bytes: int, *, headroom: float = 1.1):
        # re-dispatch through the WRAPPER's free_bytes (the inner bound
        # method would bypass the "full" fault)
        from .storage import Tier
        return Tier.preflight(self, required_bytes, headroom=headroom)

    def write_file(self, rel: str, data: bytes, *, atomic: bool = False):
        inner = self._inner
        spec = self._plane.poll("write", inner.name, rel)
        if spec is None:
            return inner.write_file(rel, data, atomic=atomic)
        k = spec.kind
        if k == "latency":
            time.sleep(spec.latency_s)
            return inner.write_file(rel, data, atomic=atomic)
        if k == "eio":
            raise _eio(rel)
        if k == "enospc":
            raise OSError(errno.ENOSPC, "injected ENOSPC", rel)
        if k == "erofs":
            raise OSError(errno.EROFS, "injected EROFS", rel)
        if k == "short_write":
            # a visible torn write: half the bytes land, then the error
            inner.write_file(rel, bytes(data[:len(data) // 2]))
            raise _eio(rel)
        if k == "torn_write":
            # a SILENT torn write under the final name — only a scrub or
            # an end-to-end integrity check can see it
            return inner.write_file(rel, bytes(data[:len(data) // 2]))
        if k == "bitrot":
            path = inner.write_file(rel, data, atomic=atomic)
            self._flip_byte_on_disk(path)
            return path
        # enospc-family kinds that only make sense elsewhere fall through
        return inner.write_file(rel, data, atomic=atomic)

    def read_file(self, rel: str) -> bytes:
        inner = self._inner
        spec = self._plane.poll(("read_file", "read"), inner.name, rel)
        if spec is None:
            return inner.read_file(rel)
        k = spec.kind
        if k == "latency":
            time.sleep(spec.latency_s)
            return inner.read_file(rel)
        if k == "eio":
            raise _eio(rel)
        if k == "vanish":
            inner.delete_file(rel)
            return inner.read_file(rel)     # raises FileNotFoundError
        if k == "stale_head":
            from .resilience import RemoteInconsistencyError
            inner._note_read_failure(rel, "injected stale HEAD",
                                     "stale_head")
            raise RemoteInconsistencyError(
                f"injected stale HEAD: {rel}", rel=rel, kind="stale_head")
        data = inner.read_file(rel)
        if k in ("short_write", "torn_write", "truncated_get"):
            return data[:len(data) // 2]    # short READ: truncated bytes
        if k == "bitrot" and data:
            buf = bytearray(data)
            buf[self._plane.rot_offset(len(buf))] ^= 0x01
            return bytes(buf)
        return data

    def _inner_read_into(self, rel: str, dest) -> bool:
        # a remote inner tier re-dispatches through the WRAPPER's
        # ``read_range`` (same trick as ``preflight``): each part of the
        # multipart GET polls the plane, so op="read_range" faults
        # (truncated_get) actually fire mid-object
        if hasattr(self._inner, "read_range"):
            from .storage import RemoteTier
            return RemoteTier.read_into(self, rel, dest)
        return self._inner.read_into(rel, dest)

    def read_range(self, rel: str, dest, offset: int) -> bool:
        inner = self._inner
        spec = self._plane.poll("read_range", inner.name, rel)
        if spec is None:
            return inner.read_range(rel, dest, offset)
        k = spec.kind
        if k == "latency":
            time.sleep(spec.latency_s)
            return inner.read_range(rel, dest, offset)
        if k == "eio":
            inner._note_read_failure(rel, "injected EIO", "read_error")
            return False
        if k == "truncated_get":
            # the part's prefix actually lands in dest, then the GET
            # "connection" dies — short bytes visible, length honest
            half = memoryview(dest)[:len(dest) // 2]
            if len(half):
                inner.read_range(rel, half, offset)
            inner._note_read_failure(
                rel, f"injected truncated GET at offset {offset}",
                "truncated_get")
            return False
        if k == "vanish":
            inner.delete_file(rel)
            return inner.read_range(rel, dest, offset)
        return inner.read_range(rel, dest, offset)

    def read_into(self, rel: str, dest) -> bool:
        inner = self._inner
        spec = self._plane.poll(("read_into", "read"), inner.name, rel)
        if spec is None:
            return self._inner_read_into(rel, dest)
        k = spec.kind
        if k == "latency":
            time.sleep(spec.latency_s)
            return self._inner_read_into(rel, dest)
        if k == "eio":
            # honour the Tier contract (False, never raise) but keep the
            # failure VISIBLE through the same counters/logging a real
            # EIO inside read_into would hit
            inner._note_read_failure(rel, "injected EIO", "read_error")
            return False
        if k == "stale_head":
            # HEAD advertised one size, the object is another: detected
            # before any part is fetched — counts + False, never raises
            inner._note_read_failure(rel, "injected stale HEAD",
                                     "stale_head")
            return False
        if k == "vanish":
            inner.delete_file(rel)
            return self._inner_read_into(rel, dest)
        ok = self._inner_read_into(rel, dest)
        if not ok:
            return False
        if k in ("short_write", "torn_write"):
            inner._note_read_failure(rel, "injected short read",
                                     "short_read")
            return False                    # bytes landed, length "lied"
        if k == "bitrot" and len(dest):
            dest[self._plane.rot_offset(len(dest))] ^= 0x01
        return ok

    def _flip_byte_on_disk(self, path):
        try:
            size = os.path.getsize(path)
            if size <= 0:
                return
            off = self._plane.rot_offset(size)
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0x01]))
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass


def wrap_store(store, plane: FaultPlane):
    """Wrap every mounted tier of `store` in a ``FaultyTier`` sharing
    `plane`, in place. Returns `store` for chaining."""
    for name in ("fast", "slow", "remote"):
        tier = getattr(store, name, None)
        if tier is not None and not isinstance(tier, FaultyTier):
            setattr(store, name, FaultyTier(tier, plane))
    peers = getattr(store, "peers", None)
    if peers:
        store.peers = [p if isinstance(p, FaultyTier)
                       else FaultyTier(p, plane) for p in peers]
    return store
