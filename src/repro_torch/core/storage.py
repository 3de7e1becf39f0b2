"""Tiered checkpoint storage: burst buffer (fast, node-local) + scratch
(slow, shared) — the Cori DataWarp-vs-Lustre hierarchy from the paper's
Fig 2 — plus an optional cold OBJECT-STORE tier (``RemoteTier``) behind
S3-style request latency and multipart ranged GETs, so cold restarts can
pull straight from object storage with no staged local copy.

On this box the "burst buffer" is /dev/shm (RAM-backed, real), "scratch"
is disk behind a token-bucket bandwidth throttle, and the "object store"
is a local directory behind per-request latency + the same token bucket,
so the paper's measured hierarchy (>20× checkpoint, ~2.5× restart) is
reproducible deterministically.

Also implements the paper's P8: capacity preflight with a coded warning/error
instead of a mid-write failure.
"""
from __future__ import annotations

import os
import secrets
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .errors import SpaceError, warn


@dataclass
class Tier:
    name: str
    root: Path
    bw_bytes_per_s: float | None = None     # None = unthrottled
    capacity_bytes: int | None = None       # None = filesystem free space

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._bucket = 0.0
        self._last = time.monotonic()
        self._used = 0
        # read-failure accounting: a dying disk must be VISIBLE (one
        # rate-limited warn per (kind, rel)) instead of silently absorbed
        # by the verified-fallback path; counters feed the health report
        self.io_counters: dict = {}
        self._warned_reads: set = set()

    # --- capacity ---
    def free_bytes(self) -> int:
        if self.capacity_bytes is not None:
            return max(self.capacity_bytes - self._used, 0)
        st = os.statvfs(self.root)
        return st.f_bavail * st.f_frsize

    def preflight(self, required_bytes: int, *, headroom: float = 1.1):
        """Paper P8: warn at <2× requirement, fail below the requirement."""
        free = self.free_bytes()
        need = int(required_bytes * headroom)
        if free < need:
            raise SpaceError("insufficient space for checkpoint image",
                             tier=self.name, free=free, required=need)
        if free < 2 * need:
            warn("CKPT_W_SPACE", "checkpoint space headroom below 2x",
                 tier=self.name, free=free, required=need)

    # --- throttled IO ---
    def _throttle(self, nbytes: int):
        if not self.bw_bytes_per_s:
            return
        with self._lock:
            now = time.monotonic()
            self._bucket = min(self._bucket + (now - self._last)
                               * self.bw_bytes_per_s, self.bw_bytes_per_s)
            self._last = now
            self._bucket -= nbytes
            deficit = -self._bucket
        if deficit > 0:
            time.sleep(deficit / self.bw_bytes_per_s)

    def write_file(self, rel: str, data: bytes, *, atomic: bool = False):
        """`atomic=True` writes through a tmp name + rename so a torn write
        can never be mistaken for a complete file (drain copies use this —
        readers trust slow-tier files by existence)."""
        path = self.root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        dst = path.with_name(
            path.name + f".tmp-{secrets.token_hex(4)}") if atomic else path
        try:
            # overwrite frees the old bytes: charging len(data) on top of
            # the prior charge would drift _used upward every rewrite
            # (LATEST, _CAS/refs.json) until a capacity-capped tier hits
            # false CKPT_W_SPACE warnings and spurious SpaceError preflights
            prior = path.stat().st_size
        except OSError:
            prior = 0
        chunk = 4 << 20
        with open(dst, "wb") as f:
            for i in range(0, len(data), chunk):
                piece = data[i:i + chunk]
                self._throttle(len(piece))
                f.write(piece)
            f.flush()
            os.fsync(f.fileno())
        if atomic:
            os.rename(dst, path)
        with self._lock:
            self._used = max(self._used + len(data) - prior, 0)
        return path

    def read_file(self, rel: str) -> bytes:
        path = self.root / rel
        data = path.read_bytes()
        self._throttle(len(data))
        return data

    def read_into(self, rel: str, dest: memoryview) -> bool:
        """Direct-placement read: fill `dest` from the file without an
        intermediate bytes object. True iff the file length matched the
        destination exactly; False on a mismatch (truncated or over-long
        object) AND on any OSError — a vanished/unreadable file must send
        the caller to the verified-fallback path, never crash a restore
        pool worker. The False paths are NOT conflated though: a missing
        file (normal tier fallthrough) only bumps ``read_missing``, while
        a short read or a real IO error is counted separately and warned
        once per ``(kind, rel)`` — a dying disk stays visible even when
        every read is absorbed downstream. Bytes actually read pay the
        token bucket BEFORE the return either way (like ``read_file``),
        so short reads cannot bypass the bandwidth model the io-sweep
        A/B depends on."""
        path = self.root / rel
        n = 0
        try:
            with open(path, "rb") as f:
                n = f.readinto(dest) or 0
                ok = n == len(dest) and not f.read(1)
        except FileNotFoundError:
            # expected during tier fallthrough — count, never warn
            with self._lock:
                self.io_counters["read_missing"] = \
                    self.io_counters.get("read_missing", 0) + 1
            return False
        except OSError as e:
            self._throttle(n)
            self._note_read_failure(rel, f"{e.__class__.__name__}: {e}",
                                    "read_error")
            return False
        self._throttle(n)
        if not ok:
            self._note_read_failure(
                rel, f"length mismatch: read {n}, wanted {len(dest)}",
                "short_read")
        return ok

    def _note_read_failure(self, rel: str, detail: str, kind: str):
        """Count a non-missing read failure and warn ONCE per
        ``(kind, rel)`` (dedup set capped so a sweep over a corrupt tree
        cannot grow it unboundedly)."""
        key = (kind, rel)
        with self._lock:
            self.io_counters[kind] = self.io_counters.get(kind, 0) + 1
            if key in self._warned_reads:
                return
            if len(self._warned_reads) < 256:
                self._warned_reads.add(key)
        warn("CKPT_W_READ", f"tier read failed ({kind})",
             tier=self.name, rel=rel, detail=detail)

    def sweep_tmp_litter(self) -> int:
        """Remove orphaned ``.tmp-*`` FILES under this tier's root — the
        litter a crash inside an ``atomic=True`` write (or
        ``atomic_write_bytes``) leaves behind, which no commit path ever
        revisits. Staging *directories* (``step_*.tmp-*/``) are skipped:
        ``atomic.gc_staging`` owns those wholesale. Returns files removed.

        Callers must ensure no atomic write is in flight on this tier
        (``run_maintenance`` runs post-drain on the persist thread)."""
        removed = 0
        for p in self.root.rglob("*.tmp-*"):
            if not p.is_file():
                continue
            if any(".tmp-" in part for part in
                   p.relative_to(self.root).parts[:-1]):
                continue        # inside a staging dir: gc_staging territory
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
        return removed

    def delete_file(self, rel: str) -> int:
        """Remove a file, returning the bytes freed (0 if absent)."""
        path = self.root / rel
        try:
            nbytes = path.stat().st_size
            path.unlink()
        except FileNotFoundError:
            return 0
        with self._lock:
            self._used = max(self._used - nbytes, 0)
        return nbytes


DEFAULT_REMOTE_PART_BYTES = 8 << 20
DEFAULT_REMOTE_LATENCY_S = 0.0


@dataclass
class RemoteTier(Tier):
    """S3-style cold object store, simulated on a local directory: every
    request (GET / ranged GET / HEAD) pays ``request_latency_s`` before any
    bytes flow, bytes pay the inherited token bucket, and reads larger than
    ``part_bytes`` are issued as MULTIPART ranged GETs (each part its own
    request) — the access model of `aws s3api get-object --range` that a
    cold restart streams against.

    PUTs are always atomic (an object either exists in full or not at
    all — there are no torn objects in an object store), whatever the
    caller passed for ``atomic``."""
    request_latency_s: float = DEFAULT_REMOTE_LATENCY_S
    part_bytes: int = DEFAULT_REMOTE_PART_BYTES

    def __post_init__(self):
        super().__post_init__()
        if int(self.part_bytes) <= 0:
            raise ValueError("part_bytes must be positive")

    def _request(self):
        if self.request_latency_s > 0:
            time.sleep(self.request_latency_s)

    def write_file(self, rel: str, data: bytes, *, atomic: bool = True):
        self._request()                     # one PUT round-trip
        return super().write_file(rel, data, atomic=True)

    def read_range(self, rel: str, dest: memoryview, offset: int) -> bool:
        """ONE ranged GET: fill `dest` from `offset`. False on any OSError
        or short read (the verified-fallback contract of ``read_into``)."""
        self._request()
        n = 0
        try:
            with open(self.root / rel, "rb") as f:
                f.seek(offset)
                n = f.readinto(dest) or 0
        except FileNotFoundError:
            with self._lock:
                self.io_counters["read_missing"] = \
                    self.io_counters.get("read_missing", 0) + 1
            return False
        except OSError as e:
            self._note_read_failure(rel, f"{e.__class__.__name__}: {e}",
                                    "read_error")
            return False
        self._throttle(n)
        if n != len(dest):
            self._note_read_failure(
                rel, f"ranged GET short: read {n}, wanted {len(dest)} "
                     f"at offset {offset}", "short_read")
        return n == len(dest)

    def read_into(self, rel: str, dest: memoryview) -> bool:
        """Whole-object direct placement as multipart ranged GETs. A size
        mismatch is detected from the object stat (the HEAD every GET
        response carries) before any part is fetched."""
        path = self.root / rel
        try:
            size = path.stat().st_size
        except FileNotFoundError:
            with self._lock:
                self.io_counters["read_missing"] = \
                    self.io_counters.get("read_missing", 0) + 1
            return False
        except OSError as e:
            self._note_read_failure(rel, f"{e.__class__.__name__}: {e}",
                                    "read_error")
            return False
        mv = memoryview(dest)
        if size != len(mv):
            self._note_read_failure(
                rel, f"size mismatch: object {size}, wanted {len(mv)}",
                "short_read")
            return False
        for off in range(0, len(mv), int(self.part_bytes)):
            if not self.read_range(rel, mv[off:off + int(self.part_bytes)],
                                   off):
                return False
        return True

    def read_file(self, rel: str) -> bytes:
        from .resilience import RemoteInconsistencyError
        size = (self.root / rel).stat().st_size   # raises if absent
        buf = bytearray(size)
        if not self.read_into(rel, memoryview(buf)):
            # typed (EIO) so retry_io / is_transient re-issue the GET
            # instead of treating a stale HEAD as a permanent error
            raise RemoteInconsistencyError(
                f"remote object changed mid-read: {rel}", rel=rel,
                kind="stale_head")
        return bytes(buf)


def mirror_to_tier(src: Tier, dst: Tier) -> int:
    """Copy every committed file under `src` to `dst` (atomic writes;
    ``.tmp-*`` litter and staging dirs skipped) — the stand-in for the
    out-of-band sync (`aws s3 sync`) that populates a ``RemoteTier`` from
    a drained checkpoint root. Returns files copied."""
    copied = 0
    for p in sorted(src.root.rglob("*")):
        if not p.is_file() or ".tmp-" in str(p.relative_to(src.root)):
            continue
        dst.write_file(str(p.relative_to(src.root)), p.read_bytes(),
                       atomic=True)
        copied += 1
    return copied


class TieredStore:
    """Writes land on the fast tier; committed checkpoints drain to the slow
    tier in the background (real burst-buffer semantics). Reads prefer fast,
    then slow, then the cold ``remote`` object-store tier — a cold restart
    with an empty burst buffer resolves every read straight off the remote
    tier's ranged GETs, no staged local copy."""

    def __init__(self, fast: Tier, slow: Tier | None = None,
                 drain_async: bool = True, io_executor=None,
                 remote: Tier | None = None, peers=()):
        self.fast = fast
        self.slow = slow
        self.remote = remote
        # read-only sibling caches (weightsync peer fan-out): resolved
        # after fast but before slow/remote, so a subscriber prefers a
        # rack-local replica over hammering the shared store. Never
        # written, never drained, never swept.
        self.peers = list(peers)
        self.drain_async = drain_async
        # optional ChunkIOExecutor: drain copies fan out over it so the
        # read side (fast tier) overlaps the throttled write side (slow
        # tier). CheckpointManager shares its chunk pool here.
        self.io_executor = io_executor
        self._drainer: threading.Thread | None = None
        self._drain_err = None
        # drains deferred because the slow tier's breaker was open:
        # (step_dir_name, rels) jobs held back — never dropped — until
        # the breaker half-opens or ``wait_drained`` forces them through
        self._drain_pending: list = []
        # resilience plumbing (wired by CheckpointManager): io_retry is a
        # resilience.RetryPolicy on the pipelined engine, None on the
        # serial engine (fail-fast — serial-baseline purity); _health maps tier name
        # → TierHealth, created lazily so bare stores cost nothing
        self.io_retry = None
        self._health: dict = {}
        self._health_lock = threading.Lock()

    @property
    def root(self) -> Path:
        return self.fast.root

    def health_for(self, tier) -> "resilience_mod.TierHealth":
        """The (lazily created) ``TierHealth`` for a mounted tier; accepts
        the tier object or its name."""
        from . import resilience as resilience_mod
        name = tier if isinstance(tier, str) else tier.name
        with self._health_lock:
            h = self._health.get(name)
            if h is None:
                h = self._health[name] = resilience_mod.TierHealth(name)
            return h

    def health_report(self) -> dict:
        """Snapshot of every mounted tier's health: breaker state + error/
        retry counters (including the tier-level read-failure counters from
        ``_note_read_failure``) — the payload of ``_CAS/health.json``."""
        report = {}
        for t in self.tiers():
            snap = self.health_for(t).snapshot()
            for k, v in getattr(t, "io_counters", {}).items():
                snap["counters"][k] = snap["counters"].get(k, 0) + v
            report[t.name] = snap
        return report

    def apply_pipeline_policy(self, pipeline) -> "TieredStore":
        """Adopt a ``PipelinePolicy``'s drain mode. ``async_drain=None``
        (the default) leaves the store as constructed — the policy only
        overrides what it explicitly sets, so a store built with
        ``drain_async=False`` isn't silently flipped by a default
        policy."""
        if getattr(pipeline, "async_drain", None) is not None:
            self.drain_async = bool(pipeline.async_drain)
        return self

    def apply_restore_policy(self, restore) -> "TieredStore":
        """Adopt a ``RestorePolicy``'s remote-read shape (multipart ranged
        GET size) onto the remote tier, if one is mounted."""
        part = getattr(restore, "remote_part_bytes", None)
        if self.remote is not None and part:
            self.remote.part_bytes = int(part)
        return self

    def tiers(self):
        return [t for t in (self.fast, *self.peers, self.slow, self.remote)
                if t is not None]

    def _drain_one(self, step_dir_name: str, rels):
        """Copy ONE committed step dir (plus its CAS objects) fast→slow.
        Runs on the drainer thread (or inline for sync/forced drains)."""
        src = self.fast.root / step_dir_name

        def _slow_write(rel, data):
            if self.io_retry is None:
                self.slow.write_file(rel, data, atomic=True)
                return
            from . import resilience
            resilience.retry_io(
                lambda: self.slow.write_file(rel, data, atomic=True),
                self.io_retry, health=self.health_for(self.slow),
                op="drain_write")

        def _copy_extra(rel):
            f = self.fast.root / rel
            if f.is_file() and not (self.slow.root / rel).exists():
                _slow_write(rel, f.read_bytes())

        def _copy_step(p):
            rel = str(Path(step_dir_name) / p.relative_to(src))
            _slow_write(rel, p.read_bytes())

        # a drain killed mid-write leaves .tmp- litter in slow-tier
        # step dirs that nothing else walks (gc_staging covers the
        # fast root, the CAS sweep covers _CAS) — purge it here,
        # off the save path; drains are serialized so no live tmp
        # file can be hit
        for t in self.slow.root.glob("step_*/**/*.tmp-*"):
            try:
                t.unlink()
            except OSError:
                pass
        step_files = [p for p in sorted(src.rglob("*")) if p.is_file()]
        ex = self.io_executor
        if ex is not None and not ex.serial:
            # two batches with a barrier between them: CAS objects
            # must be fully landed before the step dir (and its
            # manifest) can reference them on the slow tier
            ex.map_ordered(_copy_extra, rels)
            ex.map_ordered(_copy_step, step_files)
        else:
            for rel in rels:
                _copy_extra(rel)
            for p in step_files:
                _copy_step(p)

    def _run_drain_jobs(self, jobs):
        try:
            for step_dir_name, rels in jobs:
                self._drain_one(step_dir_name, rels)
        except Exception as e:  # noqa
            self._drain_err = e

    def drain_step(self, step_dir_name: str, extra_files=()):
        """Copy a committed checkpoint dir fast→slow (throttled) on ONE
        background thread, preceded by `extra_files` (CAS chunk objects
        live outside step directories). All copies are atomic writes, so a
        killed drain never leaves a torn file under a trusted name.

        Breaker-aware: if the slow tier's circuit breaker is OPEN (a run
        of consecutive drain-write failures), the copy is DEFERRED — held
        on a pending queue, never dropped — and retried on the next drain
        (by which time the breaker has half-opened) or forced through by
        ``wait_drained``/``evict_fast``. Deprioritize, never skip: a sick
        scratch filesystem delays durability, it must not silently lose
        the slow-tier copy a later eviction assumes exists."""
        if self.slow is None:
            return
        rels = [r for r in extra_files if (self.fast.root / r).is_file()]
        job = (step_dir_name, rels)
        if not self.drain_async:
            self._run_drain_jobs([job])
            return
        # serialize with any in-flight drain (raises a prior drain error
        # here, on the save path, like it always has)
        self._join_drainer()
        self._drain_pending.append(job)
        if not self.health_for(self.slow).allow():
            self.health_for(self.slow).note("drain_deferred")
            warn("CKPT_W_DRAIN", "slow-tier breaker open: drain deferred",
                 tier=self.slow.name, step=step_dir_name,
                 pending=len(self._drain_pending))
            return
        jobs, self._drain_pending = self._drain_pending, []
        self._drainer = threading.Thread(
            target=self._run_drain_jobs, args=(jobs,), daemon=True)
        self._drainer.start()

    def _join_drainer(self):
        if self._drainer is not None:
            self._drainer.join()
            self._drainer = None
        if self._drain_err is not None:
            e, self._drain_err = self._drain_err, None
            raise e

    def wait_drained(self):
        """Join the in-flight drain AND force any breaker-deferred copies
        through inline — after this returns (without raising), every
        requested drain has landed on the slow tier."""
        self._join_drainer()
        while self._drain_pending:
            jobs, self._drain_pending = self._drain_pending, []
            self._run_drain_jobs(jobs)
            self._join_drainer()    # re-raise anything _run_drain_jobs caught

    def locate(self, rel: str) -> Tier | None:
        for t in self.tiers():
            if (t.root / rel).exists():
                return t
        return None

    def evict_fast(self, step_dir_name: str):
        """Free burst-buffer space once a step is safely on the slow tier."""
        if self.slow is None:
            return
        self.wait_drained()
        shutil.rmtree(self.fast.root / step_dir_name, ignore_errors=True)


def default_store(workdir: str | Path, *, burst_buffer: bool = True,
                  lustre_bw: float | None = 500e6,
                  remote_dir: str | Path | None = None,
                  remote_bw: float | None = None,
                  remote_latency_s: float = DEFAULT_REMOTE_LATENCY_S) \
        -> TieredStore:
    """fast = /dev/shm (if available), slow = <workdir>/scratch (throttled),
    plus an optional cold object-store tier when `remote_dir` is given."""
    workdir = Path(workdir)
    shm = Path("/dev/shm")
    if burst_buffer and shm.exists() and os.access(shm, os.W_OK):
        fast = Tier("burst-buffer", shm / f"repro-bb-{os.getpid()}" /
                    workdir.name)
    else:
        fast = Tier("local", workdir / "bb")
    slow = Tier("scratch-sim", workdir / "scratch", bw_bytes_per_s=lustre_bw)
    remote = None
    if remote_dir is not None:
        remote = RemoteTier("object-store", Path(remote_dir),
                            bw_bytes_per_s=remote_bw,
                            request_latency_s=remote_latency_s)
    return TieredStore(fast, slow, remote=remote)
