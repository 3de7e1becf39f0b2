"""Content-addressed chunk store (CAS) — the incremental-checkpoint engine.

The paper's key open item is "reducing the checkpoint overhead for
large-scale applications": MANA-style transparent checkpointing pays the
full-state write cost every round. Between adjacent training steps most
leaves (embeddings, frozen layers, optimizer slots of unchanged params) are
byte-identical, so steady-state checkpoints should cost O(changed chunks),
not O(model).

Design:

  * encoded shard payloads are split into chunks — fixed-size by default,
    or content-defined (FastCDC-style, ``core.cdc``) so shifted payloads
    keep deduping; each chunk is stored once under its blake2b digest in
    ``_CAS/objects/<d2>/<digest>.obj`` (immutable, content-addressed — a
    re-write of an existing digest is a dedup hit and costs nothing);
  * the data path is pipelined (``core.chunk_exec``): hash→write fans out
    over a bounded thread pool with ONE directory fsync per payload batch,
    and reassembly prefetches chunks ahead of the consumer; ``io_threads=1``
    degrades to the original serial engine;
  * objects land via write-tmp → fsync → rename, so a crash mid-write leaves
    only ``.tmp-`` litter, never a torn object;
  * ``_CAS/refs.json`` holds the published refcount table (digest → number of
    committed shard references). It is a CACHE: the authoritative root set is
    the chunk lists inside committed step manifests, so any crash that
    staleness-skews refs.json is repaired by the next mark-and-sweep;
  * refcounts are published atomically at COMMIT (by the coordinator's commit
    phase) — an aborted round publishes nothing and its orphaned objects are
    reclaimed by ``sweep``;
  * mark-and-sweep GC: mark = union of chunk refs over every committed
    manifest on every tier, sweep = delete unreferenced objects (and tmp
    litter) from every tier, then republish refs.json from the mark set.

Buddy redundancy mirrors the shard-file story: with ``replicas=2`` every
object is written twice (``.obj`` + ``.obj.r1``) and reads fall back
primary → replica × fast tier → slow tier.
"""
from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading
import zlib
from collections import Counter

from . import atomic, resilience
from .atomic import NO_CRASH, CrashInjector
from .chunk_exec import DEFAULT_IO_THREADS, ChunkIOExecutor, cpu_cap
from .errors import CASError, CorruptShardError, MissingShardError, warn
from .namespace import REPLICA_SUFFIX
from .storage import TieredStore

DEFAULT_CHUNK_SIZE = 1 << 20          # 1 MiB fixed-size chunks
DIGEST_BYTES = 16                     # blake2b-128 — 32 hex chars
CAS_DIR = "_CAS"
OBJECTS_DIR = f"{CAS_DIR}/objects"
REFS_FILE = f"{CAS_DIR}/refs.json"
OBJ_SUFFIX = ".obj"
# corrupt copies are RENAMED here by the scrubber (same tier, single
# atomic rename) — named <digest>.r<replica>.<nonce>.quar so the origin
# slot is recoverable and an interrupted scrub can converge on re-run
QUARANTINE_DIR = f"{CAS_DIR}/quarantine"
HEALTH_FILE = f"{CAS_DIR}/health.json"        # tier health snapshot
SCRUB_FILE = f"{CAS_DIR}/last_scrub.json"     # last scrub summary


def chunk_digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=DIGEST_BYTES).hexdigest()


def split_payload(payload: bytes, chunk_size: int):
    """Fixed-size chunking; the final chunk may be short. Empty payloads
    produce no chunks (reassembly yields b'')."""
    return [payload[i:i + chunk_size]
            for i in range(0, len(payload), chunk_size)]


def run_chunker(chunker, payload):
    """Apply a chunker that may be a plain callable (payload → chunk list)
    or a chunker object (``cdc.GearChunker`` — which the save path prefers,
    because the object exposes the async candidate scanner)."""
    if hasattr(chunker, "chunk"):
        return chunker.chunk(payload)
    return chunker(payload)


def object_rel(digest: str, replica: int = 0) -> str:
    rel = f"{OBJECTS_DIR}/{digest[:2]}/{digest}{OBJ_SUFFIX}"
    return rel + REPLICA_SUFFIX if replica else rel


def manifest_chunk_index(manifest: dict, leaf_filter=None) -> dict:
    """Digest → encoded-chunk length for every chunk an (incremental)
    manifest references, optionally restricted to leaves accepted by
    ``leaf_filter(name)``. The weightsync diff: a subscriber subtracts
    its cache-resident set from this index and pulls only the rest.
    Lengths come from ``chunk_lens`` (v5+); ``None`` for older manifests
    (the object's file size is still authoritative on arrival)."""
    index: dict = {}
    for name, rec in manifest.get("leaves", {}).items():
        if leaf_filter is not None and not leaf_filter(name):
            continue
        for s in rec.get("shards", []):
            chunks = s.get("chunks", [])
            lens = s.get("chunk_lens") or [None] * len(chunks)
            for d, n in zip(chunks, lens):
                index[d] = n
    return index


def live_chunk_refs(manifests) -> Counter:
    """Mark phase: refcounts implied by an iterable of manifest dicts —
    one reference per (shard, chunk) occurrence."""
    live: Counter = Counter()
    for manifest in manifests:
        for rec in manifest.get("leaves", {}).values():
            for s in rec.get("shards", []):
                live.update(s.get("chunks", []))
    return live


class ChunkStore:
    """Refcounted, tier-aware object store on top of a TieredStore."""

    def __init__(self, store: TieredStore, *,
                 chunk_size: int = DEFAULT_CHUNK_SIZE, replicas: int = 1,
                 io_threads: int = DEFAULT_IO_THREADS,
                 retry: resilience.RetryPolicy | None = None):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.store = store
        self.chunk_size = chunk_size
        # buddy redundancy is 2-way, mirroring shard files (one primary +
        # one .r1 copy); higher requests clamp rather than silently writing
        # the same replica path twice
        self.replicas = min(max(int(replicas), 1), 2)
        self._lock = threading.Lock()
        self._inflight: set = set()
        # io_threads > 1 enables the pipelined engine: hash→write fan-out
        # with one directory fsync per payload batch, and prefetched
        # reassembly reads. io_threads <= 1 is byte-for-byte the serial
        # serial path (per-chunk dir fsync, digest-verified gets) — the
        # benchmark baseline.
        self._exec = ChunkIOExecutor(io_threads)
        # retry=None ⇒ every IO is single-attempt fail-fast (the serial
        # engine NEVER constructs a policy — serial-baseline purity); the pipelined
        # engine gets the typed budget from DurabilityPolicy.io_*
        self.retry = None if self._exec.serial else retry
        self._deadline: resilience.Deadline | None = None
        # objects written past the fast tier (fail-over under ENOSPC /
        # EROFS) this process — the manifest's `degraded` marker source
        self.degraded_writes = 0

    @classmethod
    def from_policy(cls, store: TieredStore, policy) -> "ChunkStore":
        """The chunk store a ``CheckpointPolicy`` describes: chunk size
        from the chunking section, buddy replicas from durability, pool
        width from the pipeline section, retry budget from durability's
        ``io_*`` trio (pipelined engine only — the ctor drops it for
        ``io_threads=1``)."""
        return cls(store, chunk_size=int(policy.chunking.chunk_size),
                   replicas=policy.durability.replicas,
                   io_threads=policy.pipeline.io_threads,
                   retry=resilience.RetryPolicy.from_durability(
                       policy.durability))

    def begin_io_window(self) -> None:
        """Open one round's shared IO deadline: every retry loop of the
        round (writers, drain, restore reads) draws sleep budget from the
        SAME clock, so the aggregate stall a sick tier can cause is
        bounded by ``io_deadline_s``, not retries × fault sites."""
        if self.retry is not None:
            self._deadline = resilience.Deadline(self.retry.deadline_s)

    def _retry(self, fn, tier, op: str):
        """Bounded retry against one tier, drawing from the round window;
        single-attempt when no policy is set (serial engine)."""
        if self.retry is None:
            return fn()
        return resilience.retry_io(
            fn, self.retry, deadline=self._deadline,
            health=self.store.health_for(tier), op=op)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def exists(self, digest: str) -> bool:
        # only probe the .r1 path when buddy redundancy is configured —
        # with replicas=1 that stat can never hit (writes only ever
        # produce it under replicas=2) and is pure per-chunk overhead
        if self.store.locate(object_rel(digest)) is not None:
            return True
        return self.replicas > 1 and \
            self.store.locate(object_rel(digest, 1)) is not None

    def put(self, digest: str, data: bytes,
            crash: CrashInjector = NO_CRASH) -> int:
        """Store one chunk under its digest with an immediate directory
        fsync. Returns bytes physically written (0 on a dedup hit). Safe
        under concurrent rank writers: the first thread to claim a digest
        writes it; racers dedup."""
        return self._put_one(digest, data, crash, None, None)

    def _put_one(self, digest: str, data: bytes, crash: CrashInjector,
                 dirs: set | None, dirs_lock) -> int:
        """Single-chunk store. With ``dirs`` given, the fan-out directory
        fsync is DEFERRED: the touched parent dir is recorded for the
        caller's batch fsync (one per dir per payload, not one per chunk)."""
        rels = [object_rel(digest, r) for r in range(self.replicas)]
        with self._lock:
            if digest in self._inflight:
                # a prepared-barrier peer (or a pool sibling pipelining the
                # same payload) is writing it
                crash.maybe("cas_dedup_race")
                return 0
            # any copy absent from the FAST tier gets written: brand-new
            # objects, and re-promotion of chunks previously evicted to
            # the slow tier that a new round re-references — a retained
            # step must restore at burst-buffer speed
            to_write = [rel for rel in rels
                        if not (self.store.fast.root / rel).exists()]
            if not to_write:
                crash.maybe("cas_dedup_race")
                return 0
            self._inflight.add(digest)
        written = 0
        try:
            fast = self.store.fast

            def _write_fast(rel):
                # deliberately NOT Tier.write_file(atomic=True): the crash
                # matrix needs an injection point between tmp write and
                # rename, and the object fan-out dir wants an explicit
                # directory fsync after the batch of renames
                tmp = f"{rel}.tmp-{secrets.token_hex(4)}"
                fast.write_file(tmp, data)
                crash.maybe("cas_after_obj_tmp")
                os.rename(fast.root / tmp, fast.root / rel)

            touched_fast = False
            for rel in to_write:
                try:
                    self._retry(lambda: _write_fast(rel), fast,
                                "obj_write")
                    touched_fast = True
                except OSError as e:
                    # the fast tier condemned itself for this round (full /
                    # quota / read-only, retries exhausted): fail over down
                    # the hierarchy instead of aborting the save. Only the
                    # pipelined engine (retry set) degrades — serial stays
                    # fail-fast (serial-baseline purity).
                    if self.retry is None or not resilience.is_tier_full(e):
                        raise
                    self._put_degraded(rel, data, e)
                written += len(data)
            if touched_fast:
                parent = (fast.root / rels[0]).parent
                if dirs is None:
                    atomic.fsync_dir(parent)
                else:
                    with dirs_lock:
                        dirs.add(parent)
        finally:
            with self._lock:
                self._inflight.discard(digest)
        return written

    def _put_degraded(self, rel: str, data: bytes, cause: OSError):
        """Degraded-mode object write: the fast tier is full/read-only, so
        land the object on the next healthy tier down (slow → remote) with
        an atomic write + immediate parent-dir fsync (the rare path does
        not batch). The round then commits with a `degraded` manifest
        marker instead of aborting; the chunk reads fine from the lower
        tier and is re-promoted to the fast tier by the next round that
        references it (``_put_one``'s dedup check is fast-tier-only)."""
        fallbacks = [t for t in (self.store.slow, self.store.remote)
                     if t is not None]
        # deprioritize (never skip) tiers whose breaker is open
        fallbacks.sort(key=lambda t:
                       0 if self.store.health_for(t).allow() else 1)
        if not fallbacks:
            raise cause
        last = cause
        for tier in fallbacks:
            try:
                self._retry(
                    lambda: tier.write_file(rel, data, atomic=True),
                    tier, "obj_write")
                atomic.fsync_dir((tier.root / rel).parent)
            except OSError as e:
                last = e
                continue
            with self._lock:
                self.degraded_writes += 1
                first = self.degraded_writes == 1
            self.store.health_for(tier).note("degraded_writes")
            if first:
                warn("CKPT_W_DEGRADED",
                     "fast tier rejected object writes; failing over",
                     tier=tier.name, cause=f"{cause}")
            return
        raise last

    def store_chunk(self, digest: str, data, crash: CrashInjector = NO_CRASH,
                    dirs: set | None = None, dirs_lock=None) -> int:
        """Streaming-writer entry point (``save_path.SaveSession``): store
        one chunk, deferring the fan-out directory fsync into ``dirs`` for
        the caller's rank-level batch barrier. Returns bytes physically
        written (0 on a dedup hit)."""
        return self._put_one(digest, data, crash, dirs, dirs_lock)

    def get(self, digest: str, verify: bool = True) -> bytes:
        """Read one chunk: primary → buddy replica, each fast tier → slow
        tier. Any single copy failing to read (vanished between exists()
        and read — e.g. a concurrent eviction — or EIO) falls through to
        the next copy, like shard replicas do.

        ``verify=False`` skips the per-chunk digest check — only valid
        when the CALLER holds an end-to-end integrity check over the
        reassembled payload (the whole-payload crc32 in every chunked
        shard record) and retries with ``verify=True`` on mismatch. The
        unverified path also probes the fast-tier primary with a direct
        open instead of a stat-then-read (one metadata round-trip per
        chunk on a networked filesystem); any miss falls back to the full
        replica × tier resolution loop.

        Only the CONFIGURED replica slots are probed on the hot path —
        with ``replicas=1`` the old ``range(max(replicas, 2))`` loop paid
        a dead ``.r1`` stat per chunk per tier for paths that can never
        exist. Extra slots left behind by a 2-replica history are still
        honoured, but only as a last resort once every configured slot
        has failed."""
        if not verify:
            try:
                return self.store.fast.read_file(object_rel(digest))
            except OSError:
                pass               # evicted/missing primary: resolve below
        data, last_err = self._resolve(digest, range(self.replicas), verify)
        if data is not None:
            return data
        if self.replicas < 2:
            # last-ditch: a .r1 copy written under an earlier replicas=2
            # config can still save a read whose primary is damaged
            data, extra_err = self._resolve(
                digest, range(self.replicas, 2), verify)
            if data is not None:
                return data
            last_err = last_err or extra_err
        if last_err is not None:
            raise last_err
        raise MissingShardError("chunk object missing on all tiers",
                                digest=digest)

    def _resolve(self, digest: str, replicas, verify: bool):
        """Probe the given replica slots across the tier hierarchy.
        Returns ``(data, None)`` on success, ``(None, last_err)`` when
        every copy was missing/unreadable/corrupt. With a retry policy
        set, each copy read gets its bounded retry, and tiers whose
        breaker is open are deprioritized (tried last, never skipped)."""
        tiers = self.store.tiers()
        if self.retry is not None:
            tiers = sorted(tiers, key=lambda t:
                           0 if self.store.health_for(t).allow() else 1)
        last_err = None
        for replica in replicas:
            rel = object_rel(digest, replica)
            for tier in tiers:
                if not (tier.root / rel).exists():
                    continue
                try:
                    data = self._retry(
                        lambda: tier.read_file(rel), tier, "obj_read")
                except OSError as e:
                    last_err = e
                    continue
                if not verify or chunk_digest(data) == digest:
                    return data, None
                last_err = CorruptShardError(
                    "chunk content does not match its digest",
                    digest=digest, tier=tier.name, replica=replica)
        return None, last_err

    def put_payload(self, payload,
                    crash: CrashInjector = NO_CRASH,
                    on_chunk=None, chunker=None,
                    want_crc: bool = False,
                    dirs_out: set | None = None,
                    lens_out: list | None = None) -> tuple:
        """Chunk + store an encoded shard payload.
        Returns (digest_list, new_bytes_written).

        ``chunker`` (payload → list of chunk bytes) overrides the default
        fixed-size split — content-defined chunking plugs in here.
        ``on_chunk`` is invoked after every stored chunk — writer ranks
        use it to keep their coordinator heartbeat alive through long
        fsync-bound sequences.

        ``want_crc=True`` additionally returns the payload's crc32,
        accumulated chunk-by-chunk in consumption order — in the pipelined
        engine the crc rides for free on the consumer thread while workers
        hash/write the chunks still in flight.

        With ``io_threads > 1`` the hash→write sequence is pipelined
        across the chunk pool and the fan-out directory fsyncs are batched
        to one per directory per payload; the serial engine preserves the
        original chunk-at-a-time, fsync-per-put behaviour. ``payload`` may
        be any buffer (bytes, memoryview, uint8 ndarray) — the pipelined
        save path feeds zero-copy array views.

        ``dirs_out`` (pipelined engine): skip the per-payload directory
        fsync entirely and record touched fan-out dirs into the caller's
        set — a writer rank batching many payloads calls ``fsync_dirs``
        ONCE before acking PREPARED, which is all the durability the
        commit protocol needs (the manifest is written after every rank
        acks; un-fsynced orphans from a crash before that are swept).

        ``lens_out`` (manifest v5): append each chunk's byte length, in
        chunk order — CDC shard records store the list so restore can
        compute every chunk's offset up front and place reads directly.

        The pipelined branch is ``save_path.SaveSession`` limited to one
        payload — ONE implementation of the windowed hash→write pipeline
        (crc folding, dir batching, mid-batch crash point, error-joins-all)
        serves both this call and the rank-wide streaming writer."""
        if self._exec.serial:
            chunks = (run_chunker(chunker, payload) if chunker is not None
                      else split_payload(payload, self.chunk_size))
            digests, new, crc = [], 0, 0
            for chunk in chunks:
                d = chunk_digest(chunk)
                new += self.put(d, chunk, crash)
                digests.append(d)
                if lens_out is not None:
                    lens_out.append(len(chunk))
                if want_crc:
                    crc = zlib.crc32(chunk, crc)
                if on_chunk is not None:
                    on_chunk()
            if want_crc:
                return digests, new, crc & 0xFFFFFFFF
            return digests, new

        from .save_path import SaveSession      # deferred: cas ← save_path
        session = SaveSession(self, crash=crash, on_chunk=on_chunk,
                              chunker=chunker,
                              dirs=dirs_out if dirs_out is not None
                              else set())
        ticket = session.submit_payload(payload)
        if dirs_out is not None:
            session.flush()                     # caller owns the fsync batch
        else:
            session.barrier(crash)
        digests, new, crc = session.result(ticket)
        if lens_out is not None:
            lens_out.extend(ticket.lens)
        if want_crc:
            return digests, new, crc
        return digests, new

    def fsync_dirs(self, dirs, crash: CrashInjector = NO_CRASH):
        """Durability barrier for a batch of object fan-out directories —
        fsyncs fan out over the chunk pool (256-way digest sharding makes
        most dirs distinct, so parallelism is what amortizes them)."""
        crash.maybe("cas_before_batch_fsync")
        self._exec.map_ordered(atomic.fsync_dir, sorted(dirs))

    def read_payload(self, digests, payload_bytes: int | None = None,
                     crc32: int | None = None) -> bytes:
        """Reassemble a payload from its chunk digest list.

        Pipelined engine (``io_threads > 1``) with ``crc32`` given: chunks
        are prefetched ahead of reassembly WITHOUT per-chunk digest checks
        — the whole-payload crc32 is the integrity gate (it covers every
        byte end-to-end), which halves the hashing cost of a restore. On
        any length/crc mismatch the read falls back to fully-verified
        per-chunk fetches, which identify the damaged object and recover
        through buddy replicas / other tiers. The serial engine keeps the
        original digest-verified chunk-at-a-time reads."""
        digests = list(digests)

        def _check(payload: bytes, strict: bool) -> bool:
            if payload_bytes is not None and len(payload) != payload_bytes:
                if strict:
                    raise CorruptShardError(
                        "reassembled payload length mismatch",
                        expected=payload_bytes, got=len(payload))
                return False
            if crc32 is not None and \
                    (zlib.crc32(payload) & 0xFFFFFFFF) != crc32:
                if strict:
                    raise CorruptShardError(
                        "reassembled payload crc mismatch",
                        chunks=len(digests))
                return False
            return True

        if self._exec.serial:
            payload = b"".join(self.get(d) for d in digests)
            _check(payload, strict=True)
            return payload

        # reads are bandwidth/cache bound: cap effective read concurrency
        # near the core count even when the write-side pool is wider
        window = 2 * min(self._exec.threads, cpu_cap())
        fast = crc32 is not None
        payload = b"".join(self._exec.map_ordered(
            lambda d: self.get(d, verify=not fast), digests, window=window))
        if not _check(payload, strict=False):
            # end-to-end check failed: re-read with per-chunk digest
            # verification to pinpoint the damage and engage replica /
            # tier fallback per chunk
            payload = b"".join(self._exec.map_ordered(
                lambda d: self.get(d, verify=True), digests, window=window))
            _check(payload, strict=True)
        return payload

    def read_payload_fixed(self, digests, payload_bytes: int,
                           chunk_size: int, crc32: int) -> bytes | bytearray:
        """Direct-placement reassembly for FIXED chunking (the read-side
        analogue of the write path's zero-copy feed): every chunk's offset
        is known ahead (``i * chunk_size``), so the pipelined engine
        ``readinto``s each chunk straight into a preallocated payload
        buffer — no per-chunk bytes objects, no join copy.

        The serial engine keeps the original join path untouched."""
        digests = list(digests)
        if self._exec.serial or payload_bytes is None or crc32 is None \
                or chunk_size <= 0:
            return self.read_payload(digests, payload_bytes, crc32=crc32)
        if payload_bytes > max(len(digests), 1) * chunk_size or (
                digests and payload_bytes <= (len(digests) - 1) * chunk_size):
            # digest list and claimed length disagree — let the verified
            # path produce the precise corruption error
            return self.read_payload(digests, payload_bytes, crc32=crc32)
        lens = [chunk_size] * len(digests)
        if digests:
            lens[-1] = payload_bytes - (len(digests) - 1) * chunk_size
        return self.read_payload_direct(digests, payload_bytes, crc32, lens)

    def read_payload_direct(self, digests, payload_bytes: int, crc32: int,
                            lens) -> bytes | bytearray:
        """Direct-placement reassembly from an explicit chunk LENGTH list
        (manifest v5): offsets are the prefix sums, so the ``readinto``
        fast path extends to every chunking scheme — content-defined
        chunks land at their exact offsets in a preallocated payload
        buffer with no assemble/join copy. The whole-payload crc32 stays
        the integrity gate; any short/missing/corrupt object drops that
        chunk (or the whole payload, on crc mismatch) back to the
        fully-verified ``read_payload`` path, which pinpoints damage and
        heals via replicas/tiers.

        The serial engine keeps the original join path untouched."""
        digests = list(digests)
        lens = [int(n) for n in lens]
        if self._exec.serial or payload_bytes is None or crc32 is None:
            return self.read_payload(digests, payload_bytes, crc32=crc32)
        if len(lens) != len(digests) or any(n <= 0 for n in lens) \
                or sum(lens) != payload_bytes:
            # length list and digest list disagree — let the verified
            # path produce the precise corruption error
            return self.read_payload(digests, payload_bytes, crc32=crc32)
        offsets = [0]
        for n in lens:
            offsets.append(offsets[-1] + n)
        buf = bytearray(payload_bytes)
        mv = memoryview(buf)
        tiers = self.store.tiers()

        def _fill(i: int):
            dest = mv[offsets[i]:offsets[i + 1]]
            rel = object_rel(digests[i])
            # direct placement walks the full hierarchy — fast, slow, then
            # the cold remote tier's multipart ranged GETs — so a restart
            # with an empty burst buffer still lands chunks straight in
            # the payload buffer with no staged local copy. read_into
            # returns False (never raises) on a missing/short object.
            for tier in tiers:
                if tier.read_into(rel, dest):
                    return
            data = self.get(digests[i], verify=True)
            if len(data) != len(dest):
                raise CorruptShardError(
                    "chunk object length does not match the manifest",
                    digest=digests[i], expected=len(dest), got=len(data))
            dest[:] = data

        window = 2 * min(self._exec.threads, cpu_cap())
        self._exec.map_ordered(_fill, range(len(digests)), window=window)
        if (zlib.crc32(buf) & 0xFFFFFFFF) != crc32:
            # end-to-end gate failed: re-read fully verified, per chunk
            return self.read_payload(digests, payload_bytes, crc32=crc32)
        return buf

    @property
    def executor(self) -> ChunkIOExecutor:
        return self._exec

    def close(self):
        """Tear down the chunk-IO pool (idempotent)."""
        self._exec.shutdown(wait=False)

    # ------------------------------------------------------------------
    # refcounts (published cache; manifests are the root set)
    # ------------------------------------------------------------------
    def load_refs(self) -> dict:
        tier = self.store.locate(REFS_FILE)
        if tier is None:
            return {}
        try:
            return {k: int(v)
                    for k, v in json.loads(tier.read_file(REFS_FILE)).items()}
        except (ValueError, OSError):
            return {}           # torn cache — rebuilt by the next sweep

    def publish_refs(self, refs: dict, crash: CrashInjector = NO_CRASH):
        body = json.dumps({k: v for k, v in sorted(refs.items()) if v > 0},
                          separators=(",", ":")).encode()
        atomic.atomic_write_bytes(self.store.fast.root / REFS_FILE, body,
                                  crash)

    def apply_refs(self, delta, crash: CrashInjector = NO_CRASH) -> dict:
        """COMMIT-phase atomic refcount publication (called by the
        coordinator once a round is durably committed)."""
        with self._lock:
            refs = Counter(self.load_refs())
            refs.update(delta)
            crash.maybe("before_refs_publish")
            self.publish_refs(dict(refs), crash)
            return dict(refs)

    # ------------------------------------------------------------------
    # GC + fsck
    # ------------------------------------------------------------------
    def _iter_objects(self, tier):
        objdir = tier.root / OBJECTS_DIR
        if not objdir.exists():
            return
        for p in sorted(objdir.rglob("*")):
            if p.is_file():
                yield p

    def sweep(self, live: Counter | dict, crash: CrashInjector = NO_CRASH,
              fast_live: Counter | dict | None = None) -> dict:
        """Sweep phase: delete unreferenced objects and tmp litter from
        every tier, then republish refs.json as exactly the mark set.

        `fast_live` (refcounts implied by FAST-tier manifests only) enables
        burst-buffer reclamation — the CAS analogue of ``evict_fast``: a
        fast-tier copy whose only references come from slow-tier history is
        evicted, but strictly only when the identical object file already
        exists on the slow tier, so no live object ever loses its last
        copy. Without it the fast tier would pin every chunk ever
        referenced by any historical step."""
        report = {"swept": 0, "swept_bytes": 0, "kept": 0, "kept_bytes": 0,
                  "tmp_removed": 0, "evicted": 0, "evicted_bytes": 0}
        seen_kept: set = set()
        for tier in self.store.tiers():
            # a crash mid refs.json publication leaves _CAS/refs.json.tmp-*
            # at the CAS top level (outside objects/) — reclaim it here
            cas_dir = tier.root / CAS_DIR
            if cas_dir.exists():
                for t in cas_dir.glob("*.tmp-*"):
                    if t.is_file():
                        tier.delete_file(str(t.relative_to(tier.root)))
                        report["tmp_removed"] += 1
            evictable_tier = (fast_live is not None
                              and tier is self.store.fast
                              and self.store.slow is not None)
            for p in self._iter_objects(tier):
                rel = str(p.relative_to(tier.root))
                if ".tmp-" in p.name:
                    tier.delete_file(rel)
                    report["tmp_removed"] += 1
                    continue
                digest = p.name.split(OBJ_SUFFIX)[0]
                if digest not in live:
                    report["swept"] += 1
                    report["swept_bytes"] += tier.delete_file(rel)
                    crash.maybe("mid_gc_sweep")
                    continue
                if evictable_tier and digest not in fast_live \
                        and self._slow_copy_intact(rel, digest):
                    report["evicted"] += 1
                    report["evicted_bytes"] += tier.delete_file(rel)
                    continue
                if digest not in seen_kept:
                    report["kept"] += 1
                    report["kept_bytes"] += p.stat().st_size
                    seen_kept.add(digest)
        crash.maybe("before_gc_refs_publish")
        self.publish_refs(dict(live), crash)
        return report

    def digests_on_disk(self) -> set:
        out: set = set()
        for tier in self.store.tiers():
            for p in self._iter_objects(tier):
                if ".tmp-" not in p.name:
                    out.add(p.name.split(OBJ_SUFFIX)[0])
        return out

    def _slow_copy_intact(self, rel: str, digest: str) -> bool:
        """Eviction gate: never trust a slow-tier copy by existence alone —
        drains are atomic now, but a copy from an older (non-atomic) writer
        or a damaged disk must not cost the last good replica. Unthrottled
        read: this is an integrity check, not user-visible IO."""
        p = self.store.slow.root / rel
        try:
            return p.is_file() and chunk_digest(p.read_bytes()) == digest
        except OSError:
            return False

    # ------------------------------------------------------------------
    # scrub (bit-rot detection + self-healing)
    # ------------------------------------------------------------------
    def quarantine_entries(self) -> list:
        """Every quarantined copy across the hierarchy:
        ``(tier_name, rel, digest, replica, size)``. Filenames are
        ``<digest>.r<replica>.<nonce>.quar`` — digest and origin slot are
        recoverable from the name alone."""
        out = []
        for tier in self.store.tiers():
            qdir = tier.root / QUARANTINE_DIR
            if not qdir.exists():
                continue
            for p in sorted(qdir.glob("*.quar")):
                parts = p.name.split(".")
                if len(parts) < 4 or not parts[1].startswith("r"):
                    continue
                try:
                    replica = int(parts[1][1:])
                except ValueError:
                    continue
                out.append((tier.name, str(p.relative_to(tier.root)),
                            parts[0], replica, p.stat().st_size))
        return out

    def _object_copies(self, digest: str) -> list:
        """All on-disk copies of one digest: ``(tier, replica, rel)`` for
        every configured-or-legacy slot that exists, across every tier."""
        copies = []
        for replica in range(2):        # legacy .r1 copies heal too
            rel = object_rel(digest, replica)
            for tier in self.store.tiers():
                if (tier.root / rel).is_file():
                    copies.append((tier, replica, rel))
        return copies

    def _read_good(self, digest: str, copies) -> bytes | None:
        """First copy whose content matches its digest (unthrottled direct
        read — scrub is an integrity pass, not user-visible IO)."""
        for tier, _replica, rel in copies:
            try:
                data = (tier.root / rel).read_bytes()
            except OSError:
                continue
            if chunk_digest(data) == digest:
                return data
        return None

    def scrub(self, live: Counter | dict, *, sample: int | None = None,
              seed: int = 0, should_stop=None,
              crash: CrashInjector = NO_CRASH) -> dict:
        """Re-hash live objects and heal what can be healed.

        For every scanned digest: corrupt copies are moved (one atomic
        same-tier rename) to ``_CAS/quarantine/`` and the slot is
        re-written from a good replica/tier — UNLESS no good copy exists
        anywhere, in which case the copy is left in place and counted
        ``unrecoverable`` (never quarantine the last surviving copy; a
        future replica may still surface from an unmounted tier).

        ``sample=N`` re-hashes a seeded N-digest subset (steady-state
        maintenance can amortize a full pass across rounds); the seed
        makes the subset — and therefore the whole report — replayable.
        ``should_stop`` is polled between objects (PreemptionGuard wiring:
        a SIGTERM mid-scrub defers the remainder, and because quarantine
        is one rename and healing is idempotent, the re-run converges).

        Pass 0 re-replicates objects whose quarantine provenance shows a
        slot was emptied but never healed (the crash window between
        rename and re-write) — scrub is convergent under interruption."""
        report = {"scanned": 0, "clean": 0, "healed": 0, "quarantined": 0,
                  "unrecoverable": 0, "deferred": 0, "requarantined": 0,
                  "sample": sample, "seed": seed}

        def _heal(tier, rel: str, data: bytes):
            tier.write_file(rel, data, atomic=True)
            atomic.fsync_dir((tier.root / rel).parent)

        # pass 0: converge interrupted quarantine→heal windows
        quarantined_before = self.quarantine_entries()
        for tier_name, _qrel, digest, replica, _size in quarantined_before:
            if dict(live).get(digest, 0) <= 0:
                continue
            tier = next(t for t in self.store.tiers()
                        if t.name == tier_name)
            rel = object_rel(digest, replica)
            if (tier.root / rel).is_file():
                continue            # slot healed before the interruption
            good = self._read_good(digest, self._object_copies(digest))
            if good is not None:
                _heal(tier, rel, good)
                report["healed"] += 1

        live_digests = sorted(d for d, n in dict(live).items() if n > 0)
        if sample is not None and 0 < sample < len(live_digests):
            import random as _random
            live_digests = sorted(
                _random.Random(seed).sample(live_digests, sample))

        for digest in live_digests:
            if should_stop is not None and should_stop():
                report["deferred"] = len(live_digests) - report["scanned"]
                break
            report["scanned"] += 1
            copies = self._object_copies(digest)
            bad = []
            good_data = None
            for tier, replica, rel in copies:
                try:
                    data = (tier.root / rel).read_bytes()
                except OSError:
                    bad.append((tier, replica, rel))
                    continue
                if chunk_digest(data) == digest:
                    if good_data is None:
                        good_data = data
                else:
                    bad.append((tier, replica, rel))
            if not bad:
                report["clean"] += 1
                continue
            if good_data is None:
                # NEVER quarantine the last surviving copy — leave the
                # damage in place (a replica may yet surface) and report
                report["unrecoverable"] += 1
                warn("CKPT_W_SCRUB",
                     "corrupt chunk with no good copy on any tier",
                     digest=digest, copies=len(copies))
                continue
            for tier, replica, rel in bad:
                qrel = (f"{QUARANTINE_DIR}/{digest}.r{replica}"
                        f".{secrets.token_hex(4)}.quar")
                qpath = tier.root / qrel
                qpath.parent.mkdir(parents=True, exist_ok=True)
                try:
                    os.rename(tier.root / rel, qpath)
                except FileNotFoundError:
                    pass            # unreadable AND vanished: nothing to move
                else:
                    report["quarantined"] += 1
                    self.store.health_for(tier).note("quarantined")
                crash.maybe("scrub_after_quarantine")
                _heal(tier, rel, good_data)
                report["healed"] += 1
        return report

    def fsck(self, live: Counter | dict) -> dict:
        """CAS invariant check against a mark set:
          orphans  — objects on disk not referenced by any committed manifest
          missing  — referenced digests with no readable object anywhere
          ref_drift — refs.json disagrees with the mark set
        Clean ⇔ all three empty."""
        on_disk = self.digests_on_disk()
        live_set = {d for d, n in dict(live).items() if n > 0}
        orphans = sorted(on_disk - live_set)
        missing = []
        for d in sorted(live_set):
            try:
                self.get(d)
            except (MissingShardError, CorruptShardError):
                missing.append(d)
        refs = self.load_refs()
        live_d = dict(live)
        drift = {d: (refs.get(d, 0), live_d.get(d, 0))
                 for d in set(refs) | live_set
                 if refs.get(d, 0) != live_d.get(d, 0)}
        return {"orphans": orphans, "missing": missing, "ref_drift": drift,
                "objects": len(on_disk),
                "ok": not (orphans or missing or drift)}

    def stats(self) -> dict:
        """Unique object count/bytes (primaries, fast tier preferred)."""
        uniq = {}
        for tier in self.store.tiers():
            for p in self._iter_objects(tier):
                if ".tmp-" in p.name or p.name.endswith(REPLICA_SUFFIX):
                    continue
                uniq.setdefault(p.name.split(OBJ_SUFFIX)[0], p.stat().st_size)
        return {"objects": len(uniq), "bytes": sum(uniq.values())}

    def raise_if_inconsistent(self, live) -> None:
        rep = self.fsck(live)
        if not rep["ok"]:
            raise CASError("content-addressed store failed fsck",
                           orphans=len(rep["orphans"]),
                           missing=len(rep["missing"]),
                           ref_drift=len(rep["ref_drift"]))
