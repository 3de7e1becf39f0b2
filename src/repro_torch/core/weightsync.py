"""WeightSync: serving-fleet weight distribution from the CAS —
"checkpoint as transport" (``src/repro/core/weightsync.py`` on PyTorch).

The paper's production lesson is that a C/R substrate must serve more
workloads than the save/restore loop it was prototyped for. The CAS
already makes the manifest diff between two steps a precise byte-level
delta; this module turns that into a live weight-distribution plane so a
fleet of serving replicas hot-swaps weights mid-traffic instead of
cold-restarting:

  WeightPublisher   trainer side. Hooks ``CheckpointManager.on_commit``
                    and, once a round is durable (LATEST moved, refcounts
                    published), writes a step ANNOUNCEMENT — the v7
                    manifest plus step metadata — atomically to every
                    tier of the trainer's store. Announcing is
                    best-effort by design: a failed announce warns and
                    never aborts the committed save.

  WeightSubscriber  serving side. Owns a local chunk cache in CAS layout,
                    mounted as the fast tier of its own read-composed
                    ``TieredStore`` whose lower tiers are peer caches and
                    the source store's tiers. One ``sync()``:

                      diff      manifest chunk index minus cache-resident
                                set — only MISSING chunks move;
                      pull      each missing chunk from the nearest tier
                                (peer before source, breaker-deprioritized,
                                ``retry_io``-wrapped, digest-verified) into
                                the local cache (atomic writes — a killed
                                pull never leaves a torn object);
                      assemble  a SHADOW set of host tensors via the
                                restore path's own fetch engine
                                (``RestoreSession.fetch_host`` →
                                ``read_payload_direct`` direct placement,
                                whole-payload crc gate, v7 entropy decode)
                                — bit-exact with a fresh ``restore()`` by
                                construction, because it IS the restore
                                read path; bf16 leaves are the decoded
                                uint16 bits viewed as ``torch.bfloat16``,
                                no copy;
                      flip      one reference assignment under a lock.
                                Readers snapshot ``(step, arrays)`` and can
                                never observe a torn set: the shadow dict
                                is fully built before the pointer moves
                                and no active dict is ever mutated.

                    Any sync failure (faults, missing chunks, a sick
                    source) leaves the ACTIVE set untouched: state becomes
                    ``degraded``, the replica keeps serving the last good
                    weights, and the next ``sync()`` retries from where
                    the cache left off (already-pulled chunks are not
                    re-fetched).

  PeerTier          a read-only ``Tier`` over another replica's cache with
                    a per-request latency — the rack-local hop. N
                    subscribers form a pull tree (``build_fleet``): each
                    replica's peers are caches above it, so the source
                    store serves O(tree root) chunk reads instead of
                    O(fleet) — the thundering-herd guard.

The announcement is the JAX package's document, key for key, so either
package's subscriber reads the other's publisher.

Crash points (``atomic.CrashInjector``): ``ws_mid_pull`` (halfway through
the missing-chunk pulls), ``ws_before_flip`` (shadow built, pointer not
moved), ``ws_after_flip`` (pointer moved, status not yet published). All
three resume idempotently — the cache is the only durable subscriber
state and every write to it is atomic.
"""
from __future__ import annotations

import errno
import json
import threading
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import codec as codec_mod
from . import resilience
from .atomic import NO_CRASH, CrashInjector, CrashPoint, committed_dir
from .cas import (OBJ_SUFFIX, OBJECTS_DIR, ChunkStore, chunk_digest,
                  manifest_chunk_index, object_rel)
from .chunk_exec import ChunkIOExecutor, cpu_cap
from .errors import MissingShardError, warn
from .policy import CheckpointPolicy
from .restore_path import ReadCache, RestorePlan, RestoreSession
from .split_state import leaf_paths
from .storage import Tier, TieredStore

ANNOUNCE_REL = "_WS/ANNOUNCE"
SUBSCRIBERS_DIR = "_WS/subscribers"
ANNOUNCE_FORMAT = 1


class _LeafSpec:
    """Shape/dtype carrier standing in for the abstract leaf in a restore
    job — the subscriber plans from the manifest alone, no live pytree."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


@dataclass
class PeerTier(Tier):
    """Read-only view of ANOTHER replica's chunk cache, behind a
    per-request latency (the rack-local network hop). Writes are refused
    (EROFS): a replica's cache is owned by that replica alone — peers
    read, they never mutate or reclaim. Bytes served are counted so the
    fan-out benchmark can prove the source was spared."""
    request_latency_s: float = 0.0

    def _request(self):
        if self.request_latency_s > 0:
            time.sleep(self.request_latency_s)

    def _served(self, n: int):
        with self._lock:
            self.io_counters["peer_bytes_served"] = \
                self.io_counters.get("peer_bytes_served", 0) + n

    def write_file(self, rel: str, data: bytes, *, atomic: bool = False):
        raise OSError(errno.EROFS, "peer cache is read-only", rel)

    def delete_file(self, rel: str) -> int:
        raise OSError(errno.EROFS, "peer cache is read-only", rel)

    def read_file(self, rel: str) -> bytes:
        self._request()
        data = super().read_file(rel)
        self._served(len(data))
        return data

    def read_into(self, rel: str, dest) -> bool:
        self._request()
        ok = super().read_into(rel, dest)
        if ok:
            self._served(len(dest))
        return ok


class WeightPublisher:
    """Trainer-side announcement plane. ``attach()`` (or the constructor)
    hooks the manager's ``on_commit`` list; every committed round then
    publishes ``_WS/ANNOUNCE`` — an atomic JSON document carrying the v7
    manifest — to each tier of the trainer's store, so warm subscribers
    find it on the shared fast tier and cold ones on slow/remote."""

    def __init__(self, manager=None, *, store: TieredStore | None = None):
        if manager is None and store is None:
            raise ValueError("WeightPublisher needs a manager or a store")
        self.manager = manager
        self.store = store if store is not None else manager.store
        self.seq = 0
        self.last_announced_step: int | None = None
        if manager is not None:
            self.attach(manager)

    def attach(self, manager) -> "WeightPublisher":
        if self._on_commit not in manager.on_commit:
            manager.on_commit.append(self._on_commit)
        self.manager = manager
        self.store = manager.store
        return self

    def detach(self):
        if self.manager is not None and \
                self._on_commit in self.manager.on_commit:
            self.manager.on_commit.remove(self._on_commit)

    def _on_commit(self, step: int, manifest: dict):
        self.announce(step, manifest)

    def announce(self, step: int, manifest: dict) -> dict:
        """Publish one step announcement. Returns the announcement dict;
        warns (never raises) when a tier refuses the write — distribution
        is best-effort, durability already happened at COMMIT."""
        self.seq += 1
        ann = {
            "format": ANNOUNCE_FORMAT,
            "step": int(step),
            "seq": self.seq,
            "created": time.time(),
            "step_dir": committed_dir(self.store.root, step).name,
            "manifest": manifest,
        }
        data = json.dumps(ann).encode()
        wrote = 0
        for t in (self.store.fast, self.store.slow, self.store.remote):
            if t is None:
                continue
            try:
                t.write_file(ANNOUNCE_REL, data, atomic=True)
                wrote += 1
            except OSError as e:
                warn("CKPT_W_WS", "announce write failed",
                     tier=t.name, step=step,
                     detail=f"{e.__class__.__name__}: {e}")
        if not wrote:
            warn("CKPT_W_WS", "announcement reached no tier", step=step)
        self.last_announced_step = int(step)
        return ann


class WeightSubscriber:
    """Serving-side delta puller + atomic hot-swapper (module docstring
    has the full protocol). One instance per replica; ``sync()`` is
    driven by the serving loop between requests, readers call
    ``current()`` for an un-tearable ``(step, arrays)`` snapshot."""

    def __init__(self, source: TieredStore, cache_dir, *,
                 name: str = "replica0", peers=(), leaf_filter=None,
                 policy: CheckpointPolicy | None = None,
                 crash: CrashInjector = NO_CRASH,
                 publish_status: bool = True):
        policy = policy if policy is not None else CheckpointPolicy()
        self.name = str(name)
        self.source = source
        self.leaf_filter = leaf_filter
        self.crash = crash
        self.publish_status = publish_status
        self.cache = Tier(f"ws-cache-{self.name}", Path(cache_dir))
        self.peer_tiers = [p.as_peer_tier() if isinstance(p, WeightSubscriber)
                           else p for p in peers]
        # the composed read view: local cache first, then peers, then the
        # source store's own fast→slow→remote order. Writes (pulled
        # chunks) only ever touch the cache tier.
        self.store = TieredStore(
            self.cache, None, peers=[*self.peer_tiers, *source.tiers()])
        self.chunks = ChunkStore.from_policy(self.store, policy)
        self.retry = resilience.RetryPolicy.from_durability(
            policy.durability)
        io_threads = policy.pipeline.io_threads
        # leaf fan-out on its own pool (restore-path rule: leaf tasks wait
        # on chunk reads, sharing the chunk pool could deadlock)
        self._restore_exec = ChunkIOExecutor(
            min(io_threads, cpu_cap()) if io_threads > 1 else io_threads)
        # host fetches only: the shadow set stays on the host until the
        # caller copies it where it serves
        self._session = RestoreSession(
            self.store, self.chunks, self._restore_exec,
            ReadCache(policy.pipeline.read_cache_bytes), "cpu")
        self._lock = threading.Lock()
        self._arrays: dict = {}
        self.flipped_step: int | None = None
        self.state = "init"                 # init | live | degraded
        self.last_error: str | None = None
        self._ctr_lock = threading.Lock()
        self.counters = {"syncs": 0, "flips": 0, "sync_failures": 0,
                         "chunks_pulled": 0, "wire_bytes": 0,
                         "peer_bytes": 0, "source_bytes": 0,
                         "pull_corrupt": 0, "last_sync_s": 0.0,
                         "last_flip_blocking_s": 0.0}

    # -- fleet plumbing -------------------------------------------------
    def as_peer_tier(self, *, latency_s: float = 0.0,
                     bw: float | None = None) -> PeerTier:
        return PeerTier(f"ws-peer-{self.name}", self.cache.root,
                        bw_bytes_per_s=bw, request_latency_s=latency_s)

    # -- announcement plane ---------------------------------------------
    def poll(self) -> dict | None:
        """Latest announcement visible on any SOURCE tier, or None."""
        for t in self.source.tiers():
            try:
                if (t.root / ANNOUNCE_REL).exists():
                    return json.loads(t.read_file(ANNOUNCE_REL).decode())
            except (OSError, ValueError):
                continue
        return None

    # -- the sync protocol ----------------------------------------------
    def sync(self, announcement: dict | None = None) -> dict:
        """Diff → pull → assemble → flip, against `announcement` (or the
        latest polled one). Holds last-good on ANY failure: the active
        set is untouched, state goes ``degraded``, and the next call
        resumes from the cache. Returns ``status()``."""
        ann = announcement if announcement is not None else self.poll()
        if ann is None:
            return self.status()
        step = int(ann["step"])
        if self.flipped_step is not None and step <= self.flipped_step:
            return self.status()
        t0 = time.monotonic()
        with self._ctr_lock:
            self.counters["syncs"] += 1
        try:
            manifest = ann["manifest"]
            if manifest.get("mode") != "incremental":
                raise ValueError(
                    "weightsync requires incremental (CAS) checkpoints; "
                    f"announced mode={manifest.get('mode')!r}")
            index = manifest_chunk_index(manifest, self.leaf_filter)
            missing = [d for d in index
                       if not (self.cache.root / object_rel(d)).exists()]
            self._pull(missing, index)
            shadow = self._assemble(manifest, ann["step_dir"])
            self.crash.maybe("ws_before_flip")
            self._flip(step, shadow)
            self.crash.maybe("ws_after_flip")
        except CrashPoint:
            raise                           # a simulated kill is a kill
        except Exception as e:
            with self._ctr_lock:
                self.counters["sync_failures"] += 1
            if self._arrays:
                self.state = "degraded"     # hold-last-good
            self.last_error = f"{e.__class__.__name__}: {e}"
            warn("CKPT_W_WS", "weight sync failed; holding last good set",
                 subscriber=self.name, step=step, detail=self.last_error)
        finally:
            with self._ctr_lock:
                self.counters["last_sync_s"] = time.monotonic() - t0
        self._publish_status()
        return self.status()

    def _pull(self, missing, index) -> int:
        """Fetch every missing chunk into the local cache. Atomic per
        object; killed mid-pull, the cache keeps whatever landed and the
        next sync's diff shrinks accordingly."""
        if not missing:
            return 0
        halfway = max(len(missing) // 2, 1)
        done_box = [0]

        def pull_one(digest):
            n, kind = self._pull_one(digest)
            with self._ctr_lock:
                self.counters["chunks_pulled"] += 1
                self.counters["wire_bytes"] += n
                self.counters[kind] += n
                done_box[0] += 1
                done = done_box[0]
            if done == halfway:
                self.crash.maybe("ws_mid_pull")
            return n

        self.chunks.begin_io_window()
        self.chunks.executor.map_ordered(pull_one, list(missing))
        return len(missing)

    def _pull_one(self, digest: str) -> tuple:
        """One chunk: nearest tier that has it (peer before source, an
        open breaker deprioritized), retry-wrapped read, digest gate,
        atomic cache write. Returns (bytes, 'peer_bytes'|'source_bytes')."""
        rels = [object_rel(digest, r) for r in range(2)]  # probe buddy too
        tiers = [t for t in self.store.tiers() if t is not self.cache]
        tiers = sorted(
            tiers, key=lambda t: 0 if self.store.health_for(t).allow()
            else 1)
        last_err = None
        for t in tiers:
            for rel in rels:
                if not (t.root / rel).exists():
                    continue
                try:
                    data = resilience.retry_io(
                        lambda: t.read_file(rel), self.retry,
                        deadline=self.chunks._deadline,
                        health=self.store.health_for(t), op="ws_pull")
                except OSError as e:
                    last_err = e
                    continue
                if chunk_digest(data) != digest:
                    with self._ctr_lock:
                        self.counters["pull_corrupt"] += 1
                    last_err = MissingShardError(
                        "chunk digest mismatch on pull",
                        digest=digest, tier=t.name)
                    continue
                self.cache.write_file(object_rel(digest), data,
                                      atomic=True)
                kind = "peer_bytes" if str(t.name).startswith("ws-peer") \
                    else "source_bytes"
                return len(data), kind
        raise last_err if last_err is not None else MissingShardError(
            "chunk unavailable on any tier", digest=digest)

    def _assemble(self, manifest: dict, step_dir: str) -> dict:
        """Shadow set of host tensors via the restore path's own fetch
        engine — the bit-exactness argument is structural: these ARE the
        reads and decodes a fresh ``restore()`` would perform, resolved
        against the now-populated local cache."""
        jobs = []
        for name, rec in manifest.get("leaves", {}).items():
            if self.leaf_filter is not None and not self.leaf_filter(name):
                continue
            sds = _LeafSpec(rec["shape"], rec["dtype"])
            jobs.append((name, rec, sds, None,
                         codec_mod._np_dtype(rec["dtype"])))
        plan = RestorePlan(jobs, step_dir)
        self.chunks.begin_io_window()
        fetched = self._restore_exec.map_ordered(
            lambda job: self._session.fetch_host(plan.step_dir, job), jobs)
        return {job[0]: host_tensor(pre, job[2].shape)
                for job, pre in zip(jobs, fetched)}

    def _flip(self, step: int, shadow: dict):
        """The atomic swap: one reference assignment under the lock.
        Blocking cost is O(1) — no reader ever waits on IO here."""
        t0 = time.monotonic()
        with self._lock:
            self._arrays = shadow
            self.flipped_step = int(step)
            self.state = "live"
            self.last_error = None
        with self._ctr_lock:
            self.counters["flips"] += 1
            self.counters["last_flip_blocking_s"] = time.monotonic() - t0

    # -- the serving surface --------------------------------------------
    def current(self) -> tuple:
        """(step, {leaf name → host tensor}) — an un-tearable snapshot:
        the dict was fully built before the pointer moved and is never
        mutated after."""
        with self._lock:
            return self.flipped_step, self._arrays

    # -- introspection ---------------------------------------------------
    def cache_residency(self) -> dict:
        chunks = 0
        nbytes = 0
        objects = self.cache.root / OBJECTS_DIR
        if objects.is_dir():
            for p in objects.glob(f"*/*{OBJ_SUFFIX}"):
                try:
                    nbytes += p.stat().st_size
                    chunks += 1
                except OSError:
                    continue
        return {"chunks": chunks, "bytes": nbytes}

    def status(self) -> dict:
        res = self.cache_residency()
        with self._ctr_lock:
            counters = dict(self.counters)
        return {"name": self.name, "state": self.state,
                "last_flipped_step": self.flipped_step,
                "cache_chunks": res["chunks"],
                "cache_bytes": res["bytes"],
                "cache_dir": str(self.cache.root),
                "last_error": self.last_error,
                "counters": counters,
                "updated_at": time.time()}

    def _publish_status(self):
        """Best-effort per-replica status on the SOURCE fast tier —
        ``inspect_ckpt --subscribers`` reads these."""
        if not self.publish_status:
            return
        try:
            self.source.fast.write_file(
                f"{SUBSCRIBERS_DIR}/{self.name}.json",
                json.dumps(self.status()).encode(), atomic=True)
        except OSError as e:
            warn("CKPT_W_WS", "subscriber status publish failed",
                 subscriber=self.name,
                 detail=f"{e.__class__.__name__}: {e}")

    def close(self):
        for ex in (self.chunks.executor, self._restore_exec):
            try:
                ex.shutdown(wait=True)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


def build_fleet(source: TieredStore, root, n: int, *, fanout: int = 2,
                policy: CheckpointPolicy | None = None, leaf_filter=None,
                peer_latency_s: float = 0.0,
                name_prefix: str = "replica") -> list:
    """N subscribers in a pull tree of arity `fanout`: replica i's peer
    is replica (i-1)//fanout, so only the tree root leans on the source
    store — the rest pull rack-locally."""
    if n < 1:
        raise ValueError("fleet needs at least one replica")
    root = Path(root)
    subs: list[WeightSubscriber] = []
    for i in range(n):
        peers = []
        if i > 0:
            parent = subs[(i - 1) // max(int(fanout), 1)]
            peers = [parent.as_peer_tier(latency_s=peer_latency_s)]
        subs.append(WeightSubscriber(
            source, root / f"{name_prefix}{i}", name=f"{name_prefix}{i}",
            peers=peers, policy=policy, leaf_filter=leaf_filter))
    return subs


def host_tensor(arr, shape):
    """A fetched host array as a host tensor of its logical dtype, sharing
    its memory: bf16 (``codec.BF16`` bits) and uint32 cross as same-width
    int views, which ``torch.from_numpy`` takes everywhere. ``reshape``
    keeps 0-d (scalar) leaves 0-d."""
    import torch
    arr = np.asarray(arr).reshape(tuple(shape))
    carrier = {"bfloat16": (np.int16, torch.bfloat16),
               "uint32": (np.int32, torch.uint32)}.get(
                   codec_mod.dtype_name(arr))
    with warnings.catch_warnings():
        # payload views (np.frombuffer) are read-only; the shadow set is
        # never written, only read or copied from
        warnings.simplefilter("ignore", UserWarning)
        if carrier is None:
            return torch.from_numpy(arr)
        return torch.from_numpy(arr.view(carrier[0])).view(carrier[1])


def _bits(t):
    """Bit pattern of a tensor: floats and uint32 as same-width ints."""
    import torch
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def assert_bitexact(arrays: dict, state, leaf_filter=None):
    """Leaf-by-leaf bit-equality between a subscriber's active set (or any
    {leaf name → tensor}) and a restored state of tensors — the acceptance
    gate tests and every bench rep run. Compares bit patterns (bf16 as
    int16), moving each reference leaf to the compared tensor's device,
    and checks coverage both ways."""
    import torch
    want = {name: leaf for name, leaf in leaf_paths(state)
            if leaf_filter is None or leaf_filter(name)}
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise AssertionError(
            f"leaf set mismatch: missing={missing} extra={extra}")
    for name, ref in want.items():
        got = arrays[name]
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
            raise AssertionError(
                f"{name}: shape/dtype mismatch "
                f"{tuple(got.shape)}/{got.dtype} vs "
                f"{tuple(ref.shape)}/{ref.dtype}")
        if not torch.equal(_bits(got), _bits(ref.to(got.device))):
            raise AssertionError(f"{name}: payload bytes differ")
