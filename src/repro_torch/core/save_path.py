"""Save-path pipeline stages: planning, the rank-wide chunk submission
queue, the phase-1 write engine, and the background persist stage.

``CheckpointManager`` used to interleave all of this inside one ~900-line
module; the stages now live here so each can evolve independently:

  SavePlan      pure planning — round-robin shard→rank assignment, buddy
                replica placement, and the manifest-record skeletons;
  SaveSession   a RANK-WIDE submission queue over the shared
                ``ChunkIOExecutor``: chunks from payload k+1 enter the pool
                while payload k's tail is still in flight, eliminating the
                per-shard ``put_payload`` drain bubble (the ROADMAP's
                writer-rank cross-payload pipelining item). Digest order,
                per-payload crc folding, heartbeats, dedup accounting and
                the error-joins-all guarantee are all preserved;
  write_shards  the retrying two-phase-commit phase 1: writer threads per
                surviving rank, coordinator-supervised, redistributing a
                dead rank's shards to survivors;
  PersistStage  the background persist thread for ``save(blocking=False)``:
                the training thread returns after the device→host snapshot
                while chunk/hash/write/COMMIT run here, with a
                preemption-aware fast-flush hook (SIGTERM → skip
                non-essential maintenance, drain, exit).

``io_threads=1`` stays byte-for-byte the serial engine: SaveSession
degrades to the original chunk-at-a-time ``put_payload`` calls.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import Counter, deque
from concurrent.futures import wait as futures_wait

import numpy as np

from . import codec as codec_mod
from . import resilience
from .atomic import NO_CRASH, CrashInjector
from .cas import ChunkStore, chunk_digest, split_payload
from .cas import run_chunker as cas_run_chunker
from .elastic import ShardRange
from .errors import warn
from .namespace import REPLICA_SUFFIX, UPPER_DIR, leaf_to_fname


def pack_shard(leaf: str, rng: ShardRange, arr, codec: str):
    """Full-mode (v2) inline shard file: length-prefixed msgpack header +
    encoded payload. ``msgpack`` is imported here, not at module level:
    only full mode packs shards, and incremental saves must not need it."""
    import msgpack
    payload, meta = codec_mod.encode(arr, codec)
    header = {
        "leaf": leaf,
        "global_dtype": codec_mod.dtype_name(arr),
        "start": list(rng.start),
        "stop": list(rng.stop),
        "codec": codec,
        "meta": meta,
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        "payload_bytes": len(payload),
    }
    hb = msgpack.packb(header)
    return len(hb).to_bytes(4, "little") + hb + payload, header


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

class SavePlan:
    """Pure planning for one write attempt: which rank writes which shard
    (round-robin over survivors), where buddy replicas go (the next alive
    rank), and the full-mode manifest shard records. No IO."""

    def __init__(self, per_rank: dict, manifest_shards: dict,
                 shard_order: dict):
        self.per_rank = per_rank            # rank → [(i, name, rng, arr, fname, is_replica)]
        self.manifest_shards = manifest_shards  # full mode: leaf → [records]
        self.shard_order = shard_order      # leaf → [item indices]

    @classmethod
    def build(cls, items, alive: list, *, incremental: bool, replicas: int,
              leaf_codec) -> "SavePlan":
        per_rank = {r: [] for r in alive}
        shards: dict = {}
        order: dict = {}
        for i, (name, rng, arr) in enumerate(items):
            r = alive[i % len(alive)]
            fname = f"{UPPER_DIR}/{leaf_to_fname(name)}/shard-{i:05d}.bin"
            per_rank[r].append((i, name, rng, arr, fname, False))
            order.setdefault(name, []).append(i)
            if incremental:
                # chunk objects carry their own replica copies
                continue
            replica_files = [fname]
            if replicas > 1 and len(alive) > 1:
                buddy = alive[(i + 1) % len(alive)]
                rf = fname + REPLICA_SUFFIX
                per_rank[buddy].append((i, name, rng, arr, rf, True))
                replica_files.append(rf)
            shards.setdefault(name, []).append({
                "file": fname, "replicas": replica_files,
                "start": list(rng.start), "stop": list(rng.stop),
                "dtype": codec_mod.dtype_name(arr),
                "codec": leaf_codec(name),
            })
        return cls(per_rank, shards, order)

    def manifest_leaves(self, leaf_specs, shard_records: dict | None) -> dict:
        """Manifest ``leaves`` table. ``leaf_specs``: [(name, shape, dtype)]
        for every leaf of the state. ``shard_records`` (incremental mode):
        item index → chunked record; None selects the full-mode records."""
        if shard_records is not None:
            return {
                name: {"shape": list(shape), "dtype": dtype,
                       "shards": [shard_records[i]
                                  for i in self.shard_order.get(name, [])]}
                for name, shape, dtype in leaf_specs
            }
        return {
            name: {"shape": list(shape), "dtype": dtype,
                   "shards": self.manifest_shards.get(name, [])}
            for name, shape, dtype in leaf_specs
        }


# ---------------------------------------------------------------------------
# rank-wide chunk submission queue
# ---------------------------------------------------------------------------

def _slice_encoded(stream, block_lens, cuts):
    """Slice per-chunk encodings out of a whole-payload framed block
    stream: every cut is ENTROPY_BLOCK-aligned (except the final one), so
    chunk ends map to block indices and encoded offsets are prefix sums
    of the per-block lengths. Returns (encoded chunk views, raw_lens)."""
    eoffs = np.concatenate(
        [[0], np.cumsum(np.asarray(block_lens, np.int64))])
    chunks, raw_lens = [], []
    prev_raw = prev_blk = 0
    for c in cuts:
        b1 = -(-int(c) // codec_mod.ENTROPY_BLOCK)
        chunks.append(stream[eoffs[prev_blk]:eoffs[b1]])
        raw_lens.append(int(c) - prev_raw)
        prev_raw, prev_blk = int(c), b1
    return chunks, raw_lens


class PayloadTicket:
    """Accumulator for one submitted payload: digests in chunk order,
    per-chunk byte lengths (manifest v5 offset lists), bytes physically
    written, running crc32, and a completion count. Resolved by the
    session's consumption loop; read it only after ``flush()`` (or
    ``result()``, which drains just far enough).

    A ticket whose payload sits in the scan-ahead queue (its candidate
    scan still in flight on the device) has ``submitted=False`` until the
    session chunks it and feeds the pool.

    For chunk-encoded codecs ``raw_lens`` carries the pre-entropy
    (transformed-stream) chunk lengths; ``lens``/``crc``/``new_bytes``
    then describe the ENCODED chunks that were physically stored, and
    ``payload_bytes`` stays the transformed length."""

    __slots__ = ("digests", "lens", "new_bytes", "crc", "remaining",
                 "n_chunks", "payload_bytes", "submitted", "raw_lens")

    def __init__(self, n_chunks: int, payload_bytes: int,
                 submitted: bool = True):
        self.digests: list = []
        self.lens: list = []
        self.new_bytes = 0
        self.crc = 0
        self.remaining = n_chunks
        self.n_chunks = n_chunks
        self.payload_bytes = payload_bytes
        self.submitted = submitted
        self.raw_lens: list | None = None

    @property
    def done(self) -> bool:
        return self.submitted and self.remaining == 0


class SaveSession:
    """Rank-wide submission queue feeding the chunk pool continuously
    ACROSS shard boundaries.

    ``put_payload`` drains its in-flight window at every payload end, so a
    writer rank with many small shards stalls the pool once per shard.
    Here the writer submits each payload and immediately moves on; chunk
    completions are consumed (in global submission order) only to keep the
    window bounded, to fold each payload's crc, and to run the coordinator
    heartbeat. ``flush()`` drains everything before the rank's durability
    barrier.

    Error semantics match ``ChunkIOExecutor.map_ordered``: the first
    failure (including injected ``CrashPoint``s) cancels queued chunks,
    joins every in-flight call, and re-raises — when a SaveSession method
    exits with an error, no submitted work is still running.

    The serial engine (``io_threads=1``) bypasses the queue entirely:
    ``submit_payload`` runs the original chunk-at-a-time ``put_payload``
    inline, so the serial baseline stays byte-for-byte intact.
    """

    def __init__(self, chunks: ChunkStore, *, crash: CrashInjector = NO_CRASH,
                 on_chunk=None, chunker=None, dirs: set | None = None,
                 window: int | None = None, device=None):
        self._chunks = chunks
        # where a standalone device transform runs (the manager's device;
        # a CDC chunker's scanner carries its own)
        self._device = device
        self._crash = crash
        self._on_chunk = on_chunk
        self._chunker = chunker
        # a chunker OBJECT (cdc.GearChunker) exposes the async candidate
        # scanner — that unlocks the scan-ahead queue below; a plain
        # callable still works and chunks inline
        self._chunker_obj = chunker if hasattr(chunker, "scanner") else None
        self._exec = chunks.executor
        self.serial = self._exec.serial
        # fan-out dirs pending the rank's batched fsync barrier
        self.dirs: set = dirs if dirs is not None else set()
        self._dirs_lock = threading.Lock()
        self._window = max(int(window or 2 * self._exec.threads), 1)
        self._pending: deque = deque()      # (future, ticket, chunk)
        self._scan_queue: deque = deque()   # (resolve fn, ticket)

    # -- submission ----------------------------------------------------
    def submit_payload(self, payload) -> PayloadTicket:
        """Chunk `payload` and feed the pool; returns the payload's ticket.
        Serial engine: runs to completion inline (the serial path).

        Pipelined engine with an accelerated CDC scanner: the payload's
        candidate scan is DISPATCHED here (async, on the device) and its
        chunks are only fed to the pool when the next payload arrives (or
        at flush/result) — so the scan of payload k+1 overlaps the chunk
        hash/write of payload k instead of serializing in front of it."""
        if self.serial:
            lens: list = []
            digests, new = self._chunks.put_payload(
                payload, self._crash, on_chunk=self._on_chunk,
                chunker=self._chunker, lens_out=lens)
            ticket = PayloadTicket(0, len(payload))
            ticket.digests = digests
            ticket.lens = lens
            ticket.new_bytes = new
            ticket.crc = zlib.crc32(payload) & 0xFFFFFFFF
            return ticket
        if self._chunker_obj is not None and \
                self._chunker_obj.scanner.resolve(len(payload)) != "numpy":
            ticket = PayloadTicket(-1, len(payload), submitted=False)
            try:
                handle = self._chunker_obj.scanner.scan_async(payload)

                def resolve(payload=payload, handle=handle):
                    return payload, self._chunker_obj.chunk(
                        payload, candidates=handle.result())

                self._enqueue_scan(resolve, ticket)
            except BaseException:
                self.abort()
                raise
            return ticket
        chunks = (cas_run_chunker(self._chunker, payload)
                  if self._chunker is not None
                  else split_payload(payload, self._chunks.chunk_size))
        ticket = PayloadTicket(len(chunks), len(payload))
        try:
            self._feed(chunks, ticket)
        except BaseException:
            self.abort()
            raise
        return ticket

    def submit_preconditioned(self, payload, itemsize: int,
                              codec_name: str, *,
                              device_entropy: bool = True) -> PayloadTicket:
        """Byteplane-codec payload submission (pipelined engine only —
        the serial engine encodes on the host, serial-baseline purity). The forward
        transform runs ON DEVICE: fused with the candidate scan when the
        chunk grid is content-defined over the transformed stream
        (``codec="byteplane"`` + CDC chunker) — ONE device round-trip per
        payload, gear bitmap and transformed bytes back together — and as
        a standalone async transform otherwise (fixed chunking, or a
        zstd stage between transform and chunking). Either way the device
        works on payload k+1 while the pool hashes/writes payload k, and
        the stored stream is byte-identical to the host
        ``codec_mod.encode`` path.

        Chunk-encoded codecs (byteplane-rle/-rans) add the plane entropy
        stage to the SAME dispatch when ``device_entropy`` and a CDC
        chunker are active: boundaries are cut on the transformed stream
        (rounded up to plane-block alignment) and each chunk's encoding
        is sliced out of the whole-payload encoded stream the device
        returned — byte-identical to per-chunk host encoding, but D2H and
        hashing pay only the compressed size."""
        ticket = PayloadTicket(-1, len(payload), submitted=False)
        n = len(payload)
        accel = (self._chunker_obj is not None
                 and self._chunker_obj.scanner.resolve(n) != "numpy")
        try:
            if codec_name in codec_mod.CHUNK_ENCODED \
                    and self._chunker_obj is not None:
                ck = self._chunker_obj
                if device_entropy or not accel:
                    # fused 3-stage dispatch (or the inline host oracle
                    # below the acceleration threshold — same bytes)
                    handle = ck.scanner.scan_transform_encode_async(
                        payload, itemsize, codec_name)

                    def resolve(handle=handle, ck=ck, ticket=ticket, n=n):
                        cands, stream, block_lens = handle.result()
                        cuts = ck.align_cuts(ck.cut_points_n(n, cands), n,
                                             codec_mod.ENTROPY_BLOCK)
                        chunks, ticket.raw_lens = \
                            _slice_encoded(stream, block_lens, cuts)
                        return n, chunks
                else:
                    # device transform + scan, host entropy stage
                    handle = ck.scanner.scan_transform_async(
                        payload, itemsize)

                    def resolve(handle=handle, ck=ck, ticket=ticket,
                                codec_name=codec_name):
                        cands, t = handle.result()
                        cuts = ck.align_cuts(
                            ck.cut_points_n(len(t), cands), len(t),
                            codec_mod.ENTROPY_BLOCK)
                        chunks, raw_lens, pos = [], [], 0
                        for c in cuts:
                            chunks.append(codec_mod.plane_encode_chunk(
                                t[pos:c], codec_name))
                            raw_lens.append(c - pos)
                            pos = c
                        ticket.raw_lens = raw_lens
                        return len(t), chunks
            elif codec_name in codec_mod.CHUNK_ENCODED:
                # fixed chunk grid: boundaries are not plane-aligned, so
                # each fixed-size raw chunk is entropy-coded on the host
                # (chunk-relative blocks — still a pure function of the
                # chunk bytes)
                from . import cdc_scan
                handle = cdc_scan.transform_async(payload, itemsize,
                                                  self._device)

                def resolve(handle=handle, ticket=ticket,
                            codec_name=codec_name):
                    t = handle.result()
                    raw_chunks = split_payload(t, self._chunks.chunk_size)
                    ticket.raw_lens = [len(c) for c in raw_chunks]
                    return len(t), [
                        codec_mod.plane_encode_chunk(c, codec_name)
                        for c in raw_chunks]
            elif codec_name == "byteplane" and accel:
                handle = self._chunker_obj.scanner.scan_transform_async(
                    payload, itemsize)

                def resolve(handle=handle):
                    cands, t = handle.result()
                    return t, self._chunker_obj.chunk(t, candidates=cands)
            else:
                from . import cdc_scan
                handle = cdc_scan.transform_async(payload, itemsize,
                                                  self._device)

                def resolve(handle=handle, codec_name=codec_name):
                    enc = codec_mod.encode_preconditioned(handle.result(),
                                                          codec_name)
                    if self._chunker_obj is not None:
                        chunks = self._chunker_obj.chunk(enc)
                    elif self._chunker is not None:
                        chunks = cas_run_chunker(self._chunker, enc)
                    else:
                        chunks = split_payload(enc,
                                               self._chunks.chunk_size)
                    return enc, chunks

            self._enqueue_scan(resolve, ticket)
        except BaseException:
            self.abort()
            raise
        return ticket

    def submit_chunk_encoded(self, payload, itemsize: int,
                             codec_name: str) -> PayloadTicket:
        """Host-oracle path for chunk-encoded codecs: the serial engine
        (serial-baseline purity — pure numpy, inline) and the pipelined engine with
        device pre-conditioning disabled. Transformed stream, aligned
        cuts and per-chunk encodings are all oracle-computed, so the
        stored objects and the manifest are byte-identical to the device
        path's."""
        u8 = payload if isinstance(payload, np.ndarray) \
            else np.frombuffer(payload, np.uint8)
        t = codec_mod.byteplane_forward(u8, itemsize)
        if self._chunker_obj is not None:
            ck = self._chunker_obj
            cuts = ck.align_cuts(ck.cut_points(t), len(t),
                                 codec_mod.ENTROPY_BLOCK)
        else:
            cs = self._chunks.chunk_size
            cuts = list(range(cs, len(t), cs)) + ([len(t)] if len(t) else [])
        raw_lens, chunks, pos = [], [], 0
        for c in cuts:
            chunks.append(codec_mod.plane_encode_chunk(t[pos:c], codec_name))
            raw_lens.append(c - pos)
            pos = c
        if self.serial:
            enc_stream = b"".join(chunks)
            lens: list = []
            digests, new = self._chunks.put_payload(
                enc_stream, self._crash, on_chunk=self._on_chunk,
                chunker=lambda _p: chunks, lens_out=lens)
            ticket = PayloadTicket(0, len(t))
            ticket.digests = digests
            ticket.lens = lens
            ticket.new_bytes = new
            ticket.crc = zlib.crc32(enc_stream) & 0xFFFFFFFF
            ticket.raw_lens = raw_lens
            return ticket
        ticket = PayloadTicket(len(chunks), len(t))
        ticket.raw_lens = raw_lens
        try:
            self._feed(chunks, ticket)
        except BaseException:
            self.abort()
            raise
        return ticket

    def _enqueue_scan(self, resolve, ticket: PayloadTicket):
        self._scan_queue.append((resolve, ticket))
        # depth-1 scan-ahead: feed the pool with every OLDER payload's
        # chunks (their device work had the whole previous hash/write
        # phase to finish) while the device transforms/scans this one
        while len(self._scan_queue) > 1:
            self._submit_scanned()

    def _feed(self, chunks, ticket: PayloadTicket):
        for chunk in chunks:
            while len(self._pending) >= self._window:
                self._consume_one()
            fut = self._exec.submit(self._store, chunk)
            self._pending.append((fut, ticket, chunk))

    def _submit_scanned(self):
        """Resolve the oldest queued device dispatch and feed its chunks
        to the pool (tickets always submit — and therefore resolve — in
        order). ``resolve`` returns (final payload, chunks): for a
        pre-conditioned codec the final payload is the transformed (and
        possibly compressed) stream, so the ticket's payload length is
        only known here."""
        resolve, ticket = self._scan_queue.popleft()
        try:
            payload, chunks = resolve()
            # chunk-encoded resolves return the transformed LENGTH (the
            # fused entropy dispatch never materializes the stream on
            # host) — everything else returns the payload itself
            ticket.payload_bytes = payload if isinstance(payload, int) \
                else len(payload)
            ticket.n_chunks = ticket.remaining = len(chunks)
            ticket.submitted = True
            self._feed(chunks, ticket)
        except BaseException:
            self.abort()
            raise

    def _store(self, chunk):
        d = chunk_digest(chunk)
        return d, self._chunks.store_chunk(d, chunk, self._crash,
                                           self.dirs, self._dirs_lock)

    # -- consumption ---------------------------------------------------
    def _consume_one(self):
        fut, ticket, chunk = self._pending.popleft()
        try:
            d, new = fut.result()
        except BaseException:
            self.abort()
            raise
        ticket.digests.append(d)
        ticket.lens.append(len(chunk))
        ticket.new_bytes += new
        ticket.crc = zlib.crc32(chunk, ticket.crc)
        ticket.remaining -= 1
        try:
            if ticket.n_chunks > 1 and \
                    len(ticket.digests) == 1:
                # first chunk of a multi-chunk payload durably renamed
                # while its siblings are still in flight — the mid-batch
                # crash point
                self._crash.maybe("cas_mid_batch")
            if self._on_chunk is not None:
                self._on_chunk()
        except BaseException:
            self.abort()
            raise

    def abort(self):
        """Cancel what hasn't started, join what has (no stray worker may
        still be writing objects while the caller's abort path runs).
        Queued scans are dropped (device scan results are side-effect
        free). Session methods call this on their own failures; a CALLER
        whose error occurs between session calls (codec failure, injected
        crash) must call it too before unwinding, or pool workers would
        still be renaming objects while the abort/GC path runs."""
        self._scan_queue.clear()
        futs = [f for f, _, _ in self._pending]
        for f in futs:
            f.cancel()
        futures_wait(futs)
        self._pending.clear()

    def result(self, ticket: PayloadTicket) -> tuple:
        """Drain until `ticket` resolves; returns (digests, new_bytes, crc)
        (per-chunk lengths ride on ``ticket.lens``). Chunks of LATER
        payloads may remain in flight."""
        while not ticket.submitted:
            self._submit_scanned()
        while not ticket.done:
            self._consume_one()
        return ticket.digests, ticket.new_bytes, ticket.crc & 0xFFFFFFFF

    def flush(self):
        """Drain every queued scan and in-flight chunk (all tickets
        resolve)."""
        while self._scan_queue:
            self._submit_scanned()
        while self._pending:
            self._consume_one()

    def barrier(self, crash: CrashInjector | None = None):
        """flush + the rank's ONE batched durability fsync over every
        fan-out dir this session touched."""
        self.flush()
        if self.dirs:
            self._chunks.fsync_dirs(self.dirs, crash or self._crash)
            self.dirs.clear()


# ---------------------------------------------------------------------------
# phase-1 write engine (retrying, coordinator-supervised)
# ---------------------------------------------------------------------------

class WriteOutcome:
    """Result of the phase-1 barrier: per-attempt stats, chunked records,
    the plan that produced them, and abort blame."""

    def __init__(self):
        self.ok = False
        self.reason = ""
        self.plan: SavePlan | None = None
        self.stats = {"files": 0, "payload_bytes": 0, "written_bytes": 0,
                      "new_object_bytes": 0, "chunks": 0}
        self.shard_records: dict = {}       # item index → chunked record
        self.dead: set = set()


def write_shards(*, items, alive_hint: int, coordinator, chunks: ChunkStore,
                 store, rel_stage: str, step: int, incremental: bool,
                 chunking: str, chunker, replicas: int, leaf_codec,
                 max_retries: int, save_timeout_s: float,
                 crash: CrashInjector, overlapped: bool = False,
                 device_precondition: bool = False,
                 device_entropy: bool = True, device=None) \
        -> WriteOutcome:
    """Run the retrying 2PC phase 1: plan an attempt over surviving ranks,
    start one writer thread per rank, wait for the all-PREPARED barrier,
    and on a rank death redistribute its shards to survivors (up to
    ``max_retries`` times). Pure write-side — commit/abort stays with the
    caller."""
    out = WriteOutcome()
    stats_lock = threading.Lock()

    def writer(rank: int, work: list):
        session = None
        try:
            coordinator.rank_begin(rank)
            nbytes = 0
            files: list = []
            rank_chunks: Counter = Counter()
            session = SaveSession(chunks, crash=crash,
                                  on_chunk=lambda: coordinator.heartbeat(rank),
                                  chunker=chunker, device=device)
            deferred: list = []             # (item index, ticket, record)
            for i, name, rng, arr, fname, is_replica in work:
                codec_name = leaf_codec(name)
                if incremental:
                    if not session.serial and device_precondition \
                            and codec_name in codec_mod.PRECONDITIONED:
                        # device pre-conditioning: the byteplane forward
                        # transform runs on device, fused into the CDC
                        # scan dispatch when the chunk grid follows the
                        # transformed stream — chunking, dedup and the
                        # manifest crc all operate on exactly the bytes
                        # the host encoder would have produced
                        u8 = np.ascontiguousarray(arr) \
                            .reshape(-1).view(np.uint8)
                        meta = codec_mod.byteplane_meta(arr)
                        crash.maybe(f"rank{rank}_before_write")
                        ticket = session.submit_preconditioned(
                            u8, arr.dtype.itemsize, codec_name,
                            device_entropy=device_entropy)
                        # the device dispatch is in flight but this
                        # payload's chunks have NOT been fed to the pool
                        # yet (scan-ahead queue) — the crash matrix kills
                        # the writer exactly here
                        crash.maybe(f"rank{rank}_after_fused_dispatch")
                    elif codec_name in codec_mod.CHUNK_ENCODED:
                        # host-oracle entropy path (serial engine, or
                        # device pre-conditioning disabled): same aligned
                        # cuts, same per-chunk encodings, same manifest
                        u8 = np.ascontiguousarray(arr) \
                            .reshape(-1).view(np.uint8)
                        meta = codec_mod.byteplane_meta(arr)
                        crash.maybe(f"rank{rank}_before_write")
                        ticket = session.submit_chunk_encoded(
                            u8, arr.dtype.itemsize, codec_name)
                    else:
                        if not session.serial and codec_name == "raw":
                            # zero-copy feed: the chunk pipeline consumes
                            # a uint8 VIEW of the host array — no
                            # tobytes() copy, and chunk slices stay views
                            # all the way into hash/crc/write
                            payload = np.ascontiguousarray(arr) \
                                .reshape(-1).view(np.uint8)
                            meta = {}
                        else:
                            payload, meta = codec_mod.encode(arr,
                                                             codec_name)
                        crash.maybe(f"rank{rank}_before_write")
                        ticket = session.submit_payload(payload)
                    rec = {
                        "chunks": None,     # filled after the flush below
                        "chunk_size": chunks.chunk_size,
                        "chunking": chunking,
                        "start": list(rng.start), "stop": list(rng.stop),
                        "dtype": codec_mod.dtype_name(arr),
                        "codec": codec_name,
                        "meta": meta,
                        "crc32": None,
                        # pre-conditioned payloads learn their final
                        # length at resolve time; refined below
                        "payload_bytes": ticket.payload_bytes,
                    }
                    deferred.append((i, ticket, rec))
                else:
                    data, header = pack_shard(name, rng, arr, codec_name)
                    crash.maybe(f"rank{rank}_before_write")
                    # full-mode shard files get the bounded retry but NOT
                    # the degraded failover: the commit path renames the
                    # staging dir within the fast root, so a shard landed
                    # on another tier could never be committed
                    if chunks.retry is not None:
                        resilience.retry_io(
                            lambda d=data, f=fname: store.fast.write_file(
                                f"{rel_stage}/{f}", d),
                            chunks.retry, deadline=chunks._deadline,
                            health=store.health_for(store.fast),
                            op="shard_write")
                    else:
                        store.fast.write_file(f"{rel_stage}/{fname}", data)
                    nbytes += len(data)
                    files.append(fname)
                    with stats_lock:
                        out.stats["written_bytes"] += len(data)
                        if not is_replica:
                            out.stats["files"] += 1
                            out.stats["payload_bytes"] += \
                                header["payload_bytes"]
                coordinator.heartbeat(rank)
            # one durability barrier per rank, fanned over the chunk pool —
            # PREPARED may only be acked once every object this rank wrote
            # is findable after a crash
            session.barrier(crash)
            coordinator.heartbeat(rank)
            for i, ticket, rec in deferred:
                digests, new_bytes, crc = session.result(ticket)
                # the matrix's "writer dies with orphan chunks on disk"
                # point: this payload's objects are renamed AND covered by
                # the barrier above, so the injected death deterministically
                # leaves durable orphans for the recovery sweep
                crash.maybe(f"rank{rank}_after_chunk_write")
                rec["chunks"] = digests
                rec["crc32"] = crc
                rec["payload_bytes"] = ticket.payload_bytes
                if ticket.raw_lens is not None:
                    # manifest v7: chunk-encoded codec — chunk_lens keep
                    # their physical meaning (encoded bytes: offsets,
                    # direct placement and the crc all describe what is
                    # actually read), raw lens drive the per-chunk
                    # entropy decode after placement
                    rec["payload_bytes"] = int(sum(ticket.lens))
                    rec["raw_payload_bytes"] = int(ticket.payload_bytes)
                    rec["chunk_lens"] = [int(n) for n in ticket.lens]
                    rec["chunk_raw_lens"] = [int(n)
                                             for n in ticket.raw_lens]
                elif chunking == "cdc":
                    # manifest v5: content-defined chunk lengths — restore
                    # prefix-sums them into offsets and places reads
                    # directly (fixed chunking derives offsets instead)
                    rec["chunk_lens"] = [int(n) for n in ticket.lens]
                rank_chunks.update(digests)
                nbytes += new_bytes
                with stats_lock:
                    out.shard_records[i] = rec
                    out.stats["files"] += 1
                    out.stats["payload_bytes"] += rec["payload_bytes"]
                    out.stats["written_bytes"] += new_bytes
                    out.stats["new_object_bytes"] += new_bytes
                    out.stats["chunks"] += len(digests)
            coordinator.rank_prepared(rank, nbytes=nbytes, files=files,
                                      chunks=rank_chunks)
        except Exception as e:  # noqa
            if session is not None:
                # an error raised BETWEEN session calls (codec failure,
                # injected crash) leaves chunk futures in flight — join
                # them before reporting failure, or pool workers would
                # still be renaming objects while the round's abort /
                # retry / GC path runs
                try:
                    session.abort()
                except Exception:  # noqa — the original error wins
                    pass
            coordinator.rank_failed(rank, f"{type(e).__name__}: {e}")

    for attempt in range(max_retries + 1):
        alive = [r for r in range(alive_hint) if r not in out.dead]
        if not alive:
            out.reason = "no surviving writer ranks"
            break
        # one shared IO-retry deadline per attempt: every transient-error
        # retry across all ranks draws from the same io_deadline_s budget
        chunks.begin_io_window()
        for k in out.stats:
            out.stats[k] = 0
        out.shard_records.clear()
        out.plan = SavePlan.build(items, alive, incremental=incremental,
                                  replicas=replicas, leaf_codec=leaf_codec)
        coordinator.begin_round(step, participants=alive,
                                overlapped=overlapped)
        threads = [threading.Thread(target=writer,
                                    args=(r, out.plan.per_rank[r]),
                                    daemon=True) for r in alive]
        for t in threads:
            t.start()
        out.ok = coordinator.wait_all_prepared(timeout=save_timeout_s)
        out.reason = coordinator.abort_reason()
        newly_dead = set(coordinator.round.failed) if coordinator.round \
            else set()
        for t in threads:
            t.join()
        if out.ok:
            break
        coordinator.finish_round(False)
        out.dead |= newly_dead or set(alive)  # timeout w/o blame: give up
        if attempt < max_retries and newly_dead:
            warn("CKPT_W_RETRY",
                 "writer rank(s) failed; redistributing their shards "
                 "to survivors and retrying",
                 dead=sorted(out.dead), step=step, reason=out.reason)
    return out


# ---------------------------------------------------------------------------
# snapshot stage (stage 0 — the only blocking part of an overlapped save)
# ---------------------------------------------------------------------------

def iter_snapshot_shards(state):
    """One (name, range, device tensor) entry per leaf of `state` — THE
    enumeration both the snapshot copy and the byte-budget estimate
    consume: admission must account exactly the bytes the snapshot will
    pin, so there is one rule, not two that can drift. A single-device
    tensor is one shard covering the whole leaf."""
    from .split_state import leaf_paths
    for name, leaf in leaf_paths(state):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        yield name, ShardRange((0,) * len(shape), shape), leaf


def device_quantized(name: str, leaf, quantize) -> bool:
    """Whether the snapshot quantizes this leaf on the device (K5) before
    the device→host copy: `quantize` (a leaf-name predicate, or None) names
    the int8-coded leaves, and every tensor among them goes through the
    kernel (``int8_codec.quantize_blocks`` casts a dtype other than
    bf16/f32 to f32 on the device first, as the host codec casts it)."""
    import torch
    return quantize is not None and isinstance(leaf, torch.Tensor) and \
        quantize(name)


def estimate_snapshot_bytes(state, quantize=None) -> int:
    """Host bytes ONE snapshot of `state` will pin. The persist queue's
    byte-budget admission must run BEFORE the host copy exists, so it
    gates on this metadata-only walk of ``iter_snapshot_shards`` (exact
    for the snapshot: same entries, same ``device_quantized`` rule, same
    nbytes: q and scales for a leaf quantized on the device)."""
    # a tensor's own nbytes (np.asarray refuses bf16 tensors)
    return sum(codec_mod.quantized_nbytes(data.numel())
               if device_quantized(name, data, quantize)
               else int(data.nbytes) if hasattr(data, "nbytes")
               else np.asarray(data).nbytes
               for name, _, data in iter_snapshot_shards(state))


def to_host(leaf) -> np.ndarray:
    """Device → host copy of one tensor as a C-contiguous numpy array.
    ``Tensor.numpy()`` refuses bfloat16, so bf16 travels as its uint16 bit
    pattern under ``codec.BF16`` (logical dtype ``bfloat16``); uint32 goes
    through an int32 view for the same reason on older torch builds."""
    import torch
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, order="C")
    t = leaf.detach()
    if not t.is_cuda:
        # the snapshot must not alias a live CPU tensor: an overlapped
        # save persists it while training updates the state in place
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).contiguous().cpu().numpy() \
            .view(codec_mod.BF16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).contiguous().cpu().numpy() \
            .view(np.uint32)
    return t.contiguous().cpu().numpy()


def to_host_quantized(leaf) -> codec_mod.Quantized:
    """K5 on the device, then the device → host copy of q and the scales
    only (half a bf16 leaf's bytes, a quarter of an f32 leaf's)."""
    from ..kernels.ckpt_codec import int8_codec
    q, scales = int8_codec.quantize_blocks(leaf.detach())
    return codec_mod.Quantized(q.cpu().numpy(), scales.cpu().numpy(),
                               leaf.numel(), codec_mod.dtype_name(leaf),
                               tuple(leaf.shape))


def snapshot_items(state, pool, quantize=None) -> list:
    """Device → host copy of every ``iter_snapshot_shards`` entry. The
    pipelined engine fans the per-shard host copies out over `pool` (the
    save-time idle restore pool); the serial engine keeps the original
    inline copies. Leaves that `quantize` names (``device_quantized``)
    are quantized on the device first and arrive as ``codec.Quantized``."""
    pending = list(iter_snapshot_shards(state))

    def host(entry):
        name, _, data = entry
        if device_quantized(name, data, quantize):
            return to_host_quantized(data)
        return to_host(data)

    hosts = pool.map_ordered(host, pending)
    return [(name, rng, arr)
            for (name, rng, _), arr in zip(pending, hosts)]


# ---------------------------------------------------------------------------
# maintenance stage (stage 3: retention + CAS mark-and-sweep)
# ---------------------------------------------------------------------------

def collect_live_refs(store, memo: dict, tiers=None,
                      errors: list | None = None) -> Counter:
    """Mark phase: chunk refcounts implied by every committed manifest on
    the given tiers (default: all — old steps may survive on the slow tier
    after fast-tier retirement and their chunks stay live). Committed
    manifests are immutable, so per-(tier, step) ref counters are memoized
    in `memo`: each save only parses the manifest it just wrote instead of
    re-reading the whole run history.

    An unreadable manifest does NOT silently contribute zero refs: the
    same step's copy on another tier is still consulted (a step only
    counts as seen once successfully parsed), and any step that stays
    unreadable everywhere is appended to `errors` so a destructive caller
    can fail safe instead of sweeping that step's chunks."""
    import json

    from . import atomic, cas
    full_scan = tiers is None
    tiers = store.tiers() if full_scan else tiers
    live: Counter = Counter()
    seen_steps: set = set()
    failed_steps: dict = {}
    valid_keys: set = set()
    for tier in tiers:
        for s in atomic.list_committed_steps(tier.root):
            key = (tier.name, s)
            valid_keys.add(key)
            if s in seen_steps:
                continue
            refs = memo.get(key)
            if refs is None:
                mpath = atomic.committed_dir(tier.root, s) / atomic.MANIFEST
                try:
                    refs = cas.live_chunk_refs(
                        [json.loads(mpath.read_text())])
                except (OSError, ValueError):
                    failed_steps[s] = tier.name
                    continue
                memo[key] = refs
            seen_steps.add(s)
            live.update(refs)
    if errors is not None:
        errors.extend((t, s) for s, t in failed_steps.items()
                      if s not in seen_steps)
    if full_scan:                      # drop memo entries of retired steps
        for key in list(memo):
            if key not in valid_keys:
                del memo[key]
    return live


def run_maintenance(store, chunks: ChunkStore, retain: int, collect,
                    crash: CrashInjector = NO_CRASH,
                    force_sweep: bool = False, scrub: bool = False,
                    scrub_sample: int | None = None, scrub_seed: int = 0,
                    should_stop=None) -> dict:
    """Stage 3 body: retire fast-tier steps beyond `retain`, clear staging
    litter, then mark-and-sweep the content-addressed store. `collect` is
    the manager's memoizing mark-phase callable (tiers=, errors=).

    The destructive mark-and-sweep is O(total objects + history), so the
    per-save path only runs it when retention actually dropped a step
    (that's when objects become garbage in bulk); an explicit gc() always
    sweeps, which is how aborted-round orphans are reclaimed on demand.

    ``scrub=True`` additionally re-hashes the live object set (or a
    seeded `scrub_sample`) and heals/quarantines per ``ChunkStore.scrub``;
    `should_stop` defers the remainder between objects (preemption). The
    maintenance pass also persists ``_CAS/health.json`` (tier health
    snapshot) and, after a scrub, ``_CAS/last_scrub.json`` — the offline
    inspector reads state from files, not from this process."""
    import json
    import shutil

    from . import atomic, cas

    def _finish(result: dict) -> dict:
        try:
            atomic.atomic_write_bytes(
                store.fast.root / cas.HEALTH_FILE,
                json.dumps(store.health_report(),
                           separators=(",", ":")).encode())
        except OSError:
            pass                    # telemetry must never fail maintenance
        return result

    # a step being drained to the slow tier MUST land before retirement
    # and marking — otherwise retiring its fast copy mid-copy would leave
    # its manifest on no tier and sweep would reap its chunks
    store.wait_drained()
    steps = atomic.list_committed_steps(store.root)
    dropped = steps[:-retain] if retain else []
    for s in dropped:
        shutil.rmtree(atomic.committed_dir(store.root, s),
                      ignore_errors=True)
    atomic.gc_staging(store.root)
    # a crash inside an atomic fast-tier write (committed step dirs,
    # LATEST, _CAS/refs.json) leaves .tmp-* FILES that neither gc_staging
    # (whole staging dirs) nor the drain purge (slow-tier step dirs)
    # revisits — sweep them every round, post-drain so none can be live
    fast_tmp_removed = store.fast.sweep_tmp_litter()
    no_sweep = {"swept": 0, "swept_bytes": 0, "kept": 0, "kept_bytes": 0,
                "tmp_removed": 0, "evicted": 0, "evicted_bytes": 0}
    if not (dropped or force_sweep or scrub):
        return _finish({"steps_dropped": [],
                        "fast_tmp_removed": fast_tmp_removed,
                        "cas": dict(no_sweep, skipped=True)})
    errors: list = []
    live = collect(errors=errors)
    scrub_report = None
    if scrub and not errors:
        # scrub BEFORE the sweep: healing rewrites live slots, and the
        # sweep must see the healed tree (quarantine/ lives outside
        # objects/, so quarantined copies are never re-marked or swept)
        scrub_report = chunks.scrub(live, sample=scrub_sample,
                                    seed=scrub_seed,
                                    should_stop=should_stop, crash=crash)
        try:
            atomic.atomic_write_bytes(
                store.fast.root / cas.SCRUB_FILE,
                json.dumps(scrub_report, separators=(",", ":")).encode())
        except OSError:
            pass
    if not (dropped or force_sweep):
        return _finish({"steps_dropped": [],
                        "fast_tmp_removed": fast_tmp_removed,
                        "cas": dict(no_sweep, skipped=True),
                        "scrub": scrub_report})
    fast_errors: list = []
    fast_live = (collect(tiers=[store.fast], errors=fast_errors)
                 if store.slow is not None else None)
    if fast_errors:
        # eviction's mark set is incomplete (a fast-tier manifest is
        # unreadable even though the slow copy may be fine) — evicting on
        # it would silently demote a retained step to slow-tier bandwidth,
        # so skip eviction this round
        warn("CKPT_W_GC", "unreadable fast-tier manifest(s); skipping "
             "burst-buffer eviction this round", steps=fast_errors[:8])
        fast_live = None
    crash.maybe("after_gc_mark")
    if errors:
        # fail safe: with any committed manifest unreadable the mark set
        # is incomplete, and sweeping would permanently delete chunks a
        # committed checkpoint still needs
        warn("CKPT_W_GC", "unreadable committed manifest(s); skipping "
             "the CAS sweep (fail-safe) — repair or remove the damaged "
             "step(s) and rerun gc()", steps=errors[:8])
        return _finish({"steps_dropped": dropped,
                        "fast_tmp_removed": fast_tmp_removed,
                        "cas": dict(no_sweep, skipped=True,
                                    unreadable_manifests=errors),
                        "scrub": scrub_report})
    return _finish({"steps_dropped": dropped,
                    "fast_tmp_removed": fast_tmp_removed,
                    "cas": chunks.sweep(live, crash, fast_live=fast_live),
                    "scrub": scrub_report})


# ---------------------------------------------------------------------------
# background persist stage
# ---------------------------------------------------------------------------

class PersistStage:
    """Owns the overlapped persist: ``save(blocking=False)`` hands the
    snapshotted round here and returns; chunk/hash/write/2PC-COMMIT run on
    ONE worker thread, in submission order, while training continues.

    ``depth`` bounds how many rounds may be admitted at once (the
    multi-round persist queue: snapshot round N+1 while round N persists
    — checkpoint cadence decoupled from persist latency). ``depth=1`` is
    the single-round behaviour, and the serial engine is always pinned there.
    ``host_bytes_budget`` caps the aggregate host snapshot bytes admitted
    rounds may pin: ``admit()`` blocks the NEXT snapshot (before its
    device→host copy exists) rather than letting two full snapshots OOM
    the host; a lone over-budget round still admits (never deadlocks).

    ``request_fast_flush()`` is the preemption hook: a SIGTERM handler (via
    ``PreemptionGuard.add_callback``) flips a flag the in-flight round
    consults to skip non-essential maintenance (the per-save GC sweep) so
    the round commits and the process can exit promptly — the commit
    itself, refcount publication and the slow-tier drain are never
    skipped (durability is the point of the final checkpoint). The flag
    covers every round queued at request time and clears when the queue
    drains (per-request, not a latch). A request with NO round in flight
    deliberately applies to the next overlapped round (the signal may land
    during the snapshot, before the persist worker runs); if the process
    then survives the preemption, the cost is one skipped maintenance
    round — self-healing, since the following round (or an explicit gc())
    retires everything that accumulated."""

    def __init__(self, depth: int = 1, host_bytes_budget: int | None = None):
        self.depth = max(int(depth or 1), 1)
        self.host_bytes_budget = (int(host_bytes_budget)
                                  if host_bytes_budget else None)
        self._cv = threading.Condition()
        self._q: deque = deque()            # (fn, on_error, nbytes)
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        self._inflight = 0                  # admitted rounds not yet done
        self._inflight_bytes = 0
        self._fast_flush = threading.Event()

    @property
    def active(self) -> bool:
        with self._cv:
            return self._inflight > 0 or bool(self._q)

    @property
    def inflight(self) -> int:
        """Rounds currently admitted (reserved + queued + running)."""
        with self._cv:
            return self._inflight

    @property
    def inflight_bytes(self) -> int:
        with self._cv:
            return self._inflight_bytes

    @property
    def fast_flush_requested(self) -> bool:
        return self._fast_flush.is_set()

    def request_fast_flush(self):
        self._fast_flush.set()

    def raise_pending(self):
        """Surface (and clear) a failed round's error NOW. The queued
        save path calls this before admitting the next round — at depth 1
        the drain-before-snapshot wait() surfaces persist failures on the
        very next save, and a deeper queue must not turn that into
        checkpoints silently failing for the rest of the run."""
        if self._err is not None:
            e, self._err = self._err, None
            raise e

    # -- admission -----------------------------------------------------
    def admit(self, nbytes: int = 0) -> float:
        """Block until a queue slot AND the host byte budget admit a round
        of `nbytes`, then RESERVE both — the caller's snapshot counts
        against the budget from this moment. Hand the reservation to the
        queue with ``submit(..., reserved=True)`` or cancel it with
        ``release()`` if the snapshot fails. An empty stage always admits
        (a single round larger than the whole budget must run, not
        deadlock). Returns seconds spent blocked."""
        nbytes = max(int(nbytes), 0)
        t0 = time.monotonic()
        with self._cv:
            while self._inflight >= self.depth or (
                    self.host_bytes_budget is not None
                    and self._inflight > 0
                    and self._inflight_bytes + nbytes
                    > self.host_bytes_budget):
                self._cv.wait()
            self._inflight += 1
            self._inflight_bytes += nbytes
        return time.monotonic() - t0

    def release(self, nbytes: int = 0):
        """Return an admitted round's slot + bytes (round done, or its
        snapshot failed before submission)."""
        with self._cv:
            self._inflight -= 1
            self._inflight_bytes -= max(int(nbytes), 0)
            self._cv.notify_all()

    # -- execution -----------------------------------------------------
    def submit(self, fn, on_error, nbytes: int = 0, reserved: bool = False):
        """Queue ``fn`` for the persist worker (FIFO — rounds always
        commit in submission order); ``on_error(exc)`` runs on the worker
        on failure (the manager uses it to keep the drain counters moving —
        a stuck counter would deadlock the trainer). ``reserved=True``
        consumes an ``admit()`` reservation instead of taking a new
        slot."""
        with self._cv:
            if not reserved:
                self._inflight += 1
                self._inflight_bytes += max(int(nbytes), 0)
            self._q.append((fn, on_error, max(int(nbytes), 0)))
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _run(self):
        while True:
            with self._cv:
                if not self._q:
                    # worker retires under the lock — a concurrent submit
                    # either sees the queue non-empty (we loop) or
                    # _thread=None (it starts a fresh worker): no round
                    # can be stranded between the two
                    self._thread = None
                    # fast-flush is per-request, not a latch: once every
                    # flushed round has landed (or died) the next round
                    # must run full maintenance again, or a survived
                    # preemption request would disable GC for the rest of
                    # the process lifetime
                    self._fast_flush.clear()
                    self._cv.notify_all()
                    return
                fn, on_error, nbytes = self._q.popleft()
            try:
                fn()
            except BaseException as e:  # noqa — propagated via wait()
                if self._err is None:   # first failure wins
                    self._err = e
                on_error(e)
            finally:
                self.release(nbytes)

    def wait(self):
        """Drain every admitted round, then surface the first error."""
        with self._cv:
            while self._inflight > 0 or self._q:
                self._cv.wait()
            t = self._thread
        if t is not None:
            t.join()
        if self._err is not None:
            e, self._err = self._err, None
            raise e
