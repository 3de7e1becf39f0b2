"""Restore-path pipeline stages: read planning, the host-side fetch
engine, and the byte-budgeted read cache.

The counterpart of ``core.save_path``: ``CheckpointManager.restore`` is
orchestration (manifest → plan → prefetch → device placement) and the
stages live here:

  RestorePlan     pure planning — per-leaf jobs pairing manifest shard
                  records with the CURRENT topology's index ranges
                  (``elastic.plan_reads`` does the range math);
  RestoreSession  the host-side fetch engine: leaf-level fan-out over the
                  restore pool, shard reads (fast tier → slow tier → buddy
                  replica), chunked-shard reassembly with the whole-payload
                  crc as the integrity gate, and — for FIXED chunking on
                  the pipelined engine — direct placement: chunks are
                  ``readinto`` a preallocated payload buffer at their known
                  offsets, skipping the join copy (the ROADMAP's read-side
                  direct placement item);
  ReadCache       LRU, byte-budgeted, safe under concurrent leaf fan-out.

``io_threads=1`` keeps the serial engine byte-for-byte: always-assemble,
digest-verified chunk-at-a-time reads, join-copy reassembly.
"""
from __future__ import annotations

import math
import threading
import time
import warnings
import zlib
from collections import OrderedDict

import numpy as np

from . import codec as codec_mod
from . import resilience
from .elastic import (ShardRange, assemble, leaf_first_use_class,
                      overlap, plan_reads)
from .errors import CorruptShardError, MissingShardError, warn
from .split_state import tree_unflatten


def unpack_shard(data: bytes, staged: bool = False):
    """Full-mode (v2) inline shard file → (ShardRange, array); with
    `staged`, a ``STAGED`` codec's payload stops before its last transform
    (``codec.decode_stages``)."""
    import msgpack      # only full-mode shard files need it
    hlen = int.from_bytes(data[:4], "little")
    header = msgpack.unpackb(data[4:4 + hlen])
    payload = data[4 + hlen:4 + hlen + header["payload_bytes"]]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != header["crc32"]:
        raise CorruptShardError("payload crc mismatch", leaf=header["leaf"])
    rng = ShardRange(tuple(header["start"]), tuple(header["stop"]))
    decode = codec_mod.decode_stages if staged else codec_mod.decode
    arr = decode(payload, header["codec"], rng.shape,
                 header["global_dtype"], header["meta"])
    return rng, arr


class StagedLeaf:
    """A leaf fetched for the device decode: the saved shards that cover
    it, as ``(ShardRange, piece)`` pairs in the leaf's index space. A piece
    is a ``codec.Planes`` or ``codec.Quantized`` (a ``STAGED`` codec's
    shard before its last transform) or, for any other codec, the decoded
    host array, each in its record's dtype. ``target`` is the range the
    pieces fill (the whole leaf, or this rank's shard of it)."""

    def __init__(self, pieces: list, target: ShardRange):
        self.pieces = pieces
        self.target = target


def uncovered(target: ShardRange, ranges: list) -> int:
    """Elements of `target` that none of `ranges` covers (0 at once for a
    scalar with any range, or for a range equal to `target`)."""
    if not target.shape:
        return 0 if ranges else 1
    if any(r == target for r in ranges):
        return 0
    covered = np.zeros(target.shape, dtype=bool)
    for r in ranges:
        ov = overlap(r, target)
        if ov is not None:
            covered[tuple(slice(a - s, b - s) for a, b, s in
                          zip(ov.start, ov.stop, target.start))] = True
    return int(covered.size - np.count_nonzero(covered))


class ReadCache:
    """LRU, byte-budgeted shard cache, safe under concurrent leaf fan-out.
    Re-inserting a key never double-counts its bytes, and a hit refreshes
    recency (LRU, not FIFO).

    A SINGLE entry larger than ``limit`` stays resident (eviction stops at
    one entry, deliberately): the freshly-inserted array is about to be
    consumed by the leaf that fetched it, and evicting it would only turn
    the next overlapping range read into a full re-fetch — an always-miss
    cache with extra copies. The budget bounds steady-state growth, not
    the instantaneous high-water mark of one oversized shard."""

    def __init__(self, limit: int = 1 << 30):
        self.limit = limit
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @property
    def entries(self) -> OrderedDict:
        return self._entries

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)      # recency, not insertion
            return ent[1]

    def put(self, key, arr):
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                # re-insert (e.g. concurrent fills of the same shard) must
                # not double-count: a leaked byte total would eventually
                # exceed the limit forever and thrash the cache to one entry
                self._bytes -= old[1].nbytes
            self._entries[key] = (time.monotonic(), arr)
            self._bytes += arr.nbytes
            while self._bytes > self.limit and len(self._entries) > 1:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class RestorePlan:
    """Per-leaf restore jobs for the CURRENT topology. Pure planning: no
    IO, no device access. Each job pairs a manifest leaf record with the
    abstract leaf (anything with ``shape`` and ``dtype``: a tensor, a meta
    tensor), its target sharding (a ``sharding.partition.NamedSharding``
    on a ``DeviceMesh``, or None for one device) and the canonical numpy
    dtype its host bytes decode to (bf16 as ``codec.BF16``)."""

    def __init__(self, jobs: list, step_dir: str,
                 written_policy: dict | None = None):
        self.jobs = jobs        # (name, rec, abstract leaf, sharding, np_dtype)
        self.step_dir = step_dir
        # manifest v6: the writer's recorded policy block rides the plan
        # (restore itself is record-driven; the manager adopts this for
        # FUTURE saves so dedup survives a config-drifted restart)
        self.written_policy = written_policy

    @classmethod
    def build(cls, manifest: dict, step_dir: str, names: list, flat: list,
              shard_flat: list, step: int) -> "RestorePlan":
        leaves = manifest["leaves"]
        jobs = []
        for name, sds, sharding in zip(names, flat, shard_flat):
            rec = leaves.get(name)
            if rec is None:
                raise MissingShardError("leaf missing from checkpoint",
                                        leaf=name, step=step)
            np_dtype = codec_mod._np_dtype(codec_mod.dtype_name(sds))
            jobs.append((name, rec, sds, sharding, np_dtype))
        pol = manifest.get("policy")
        return cls(jobs, step_dir,
                   written_policy=pol if isinstance(pol, dict) else None)

    def first_use_schedule(self, priority=None,
                           frontier_classes: int = 2) -> tuple:
        """(schedule, frontier): `schedule` is job indices in first-use
        order (``elastic.leaf_first_use_class`` unless a model supplies
        `priority`); `frontier` is the leading indices — the first
        `frontier_classes` DISTINCT classes (embedding + block 0 by
        default) that must be resident before step 0 begins."""
        pr = priority or leaf_first_use_class
        classes = [pr(job[0]) for job in self.jobs]
        schedule = sorted(range(len(self.jobs)),
                          key=lambda i: (classes[i], i))
        lead = sorted(set(classes))[:max(int(frontier_classes), 1)]
        lead = set(lead)
        frontier = [i for i in schedule if classes[i] in lead]
        return schedule, frontier

    @staticmethod
    def leaf_ranges(shape, sharding) -> list:
        """Index ranges THIS PROCESS needs from one leaf — what the
        host-fetch phase reads: the whole leaf on one device, this rank's
        one local range on a mesh, so a rank reads O(its shards), not
        O(global model)."""
        if sharding is None:
            return [ShardRange((0,) * len(shape), tuple(shape))]
        return [sharding.local_range(tuple(shape))]


class RestoreSession:
    """Host-side fetch engine over one manager's store/pools/cache, plus
    device placement onto ``device``. Fetching is pure numpy + IO — safe on
    restore pool workers; placement runs on the calling thread.

    ``device_decode`` (the manager's ``device_precondition``: off on the
    serial engine) moves the last decode transform onto the device: every
    saved shard of a leaf with a byteplane codec is fetched up to its
    transformed stream and placed through K4, every int8 shard up to q and
    its scales and placed through K6, each into its slice of the leaf and
    cast there when the record's dtype is not the leaf's. The restored
    bytes are the host decode's (the kernels are bit-exact with the
    oracles); the host copies and the H2D transfer carry the encoded
    form."""

    def __init__(self, store, chunks, executor, cache: ReadCache, device):
        self.store = store
        self.chunks = chunks
        self.executor = executor
        self.cache = cache
        self.device = device
        self.device_decode = False
        # stored bytes this session read for its shards (cache hits
        # excluded): what a rank's restore costs the storage
        self.bytes_read = 0
        self._read_lock = threading.Lock()

    def _count_read(self, n: int):
        with self._read_lock:
            self.bytes_read += int(n)

    # -- leaf-level ----------------------------------------------------
    def fetch_host(self, step_dir: str, job):
        """One leaf's host-side fetch: the range this process holds (the
        whole leaf on one device, the local shard on a mesh) as a host
        array, or, for the device decode, a ``StagedLeaf``. Pool-worker
        safe (pure numpy + IO)."""
        name, rec, sds, sharding, np_dtype = job
        target, = RestorePlan.leaf_ranges(tuple(sds.shape), sharding)
        if self.device_decode and any(s.get("codec") in codec_mod.STAGED
                                      for s in rec["shards"]):
            return self.fetch_staged(step_dir, name, rec, target)
        return self.leaf_fetcher(step_dir, name, rec, np_dtype)(target)

    def fetch_staged(self, step_dir, name, rec, target) -> "StagedLeaf":
        """The device decode's fetch: the saved shards that cover `target`,
        each read up to its last transform (``codec.Planes``/
        ``codec.Quantized``; a shard of any other codec decoded)."""
        available = [(ShardRange(tuple(s["start"]), tuple(s["stop"])), s)
                     for s in rec["shards"]]
        picks = plan_reads(target, available)
        missing = uncovered(target, [rng for rng, _ in picks])
        if missing:
            raise MissingShardError(f"restore plan leaves {missing} "
                                    f"elements uncovered", leaf=name)
        # a saved shard is read and decoded WHOLE even where the target
        # needs only a slice of it (as the reference's host decode): its
        # chunk stream and plane transform run over the shard, and the
        # bytes read count the whole shard
        return StagedLeaf([
            (rng, self.read_shard(step_dir, s, staged=s.get("codec")
                                  in codec_mod.STAGED))
            for rng, s in picks], target)

    def prefetch(self, plan: RestorePlan) -> list:
        """Phase 1 (blocking): fan the per-leaf host fetches out across
        the restore pool; returns, per job, the host array."""
        return self.executor.map_ordered(
            lambda job: self.fetch_host(plan.step_dir, job), plan.jobs)

    def prefetch_async(self, plan: RestorePlan, schedule=None) -> list:
        """Phase 1, streaming: dispatch every per-leaf host fetch and
        return its future — indexed by JOB position, submitted in
        `schedule` order (first-use), so pool workers drain the frontier
        first and each leaf releases to device placement as it lands
        instead of barriering on ``map_ordered``. On the serial engine
        ``submit`` runs inline, so the futures come back already resolved
        in schedule order — same bytes, no overlap."""
        futures: list = [None] * len(plan.jobs)
        for i in (schedule if schedule is not None
                  else range(len(plan.jobs))):
            futures[i] = self.executor.submit(
                self.fetch_host, plan.step_dir, plan.jobs[i])
        return futures

    def leaf_to_device(self, step_dir, job, prefetched):
        """Phase 2 (calling thread): allocate the leaf on the device and
        copy the prefetched host array into it, or finish a ``StagedLeaf``'s
        decode there. On a mesh the result is this rank's local shard
        wrapped as a ``DTensor`` with the target placements."""
        name, rec, sds, sharding, np_dtype = job
        if isinstance(prefetched, StagedLeaf):
            local = self._decode_to_device(prefetched, sds)
        else:
            local = self._upload(prefetched, sds.dtype, prefetched.shape)
        if sharding is None:
            return local
        from torch.distributed.tensor import DTensor
        shape = tuple(sds.shape)
        stride = tuple(int(math.prod(shape[i + 1:]))
                       for i in range(len(shape)))
        return DTensor.from_local(local, sharding.mesh, sharding.placements,
                                  run_check=False, shape=shape,
                                  stride=stride)

    def _upload(self, host, dtype, shape):
        """A host array copied into a new device tensor of `dtype`. bf16
        and uint32 host arrays cross as same-width int views
        (``torch.from_numpy`` takes neither everywhere)."""
        import torch
        host = np.asarray(host, order="C")
        carrier = {torch.bfloat16: (np.int16, torch.int16),
                   torch.uint32: (np.int32, torch.int32)}.get(dtype)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        dst = out
        if carrier is not None:
            host = host.view(carrier[0])
            dst = out.view(carrier[1])
        with warnings.catch_warnings():
            # read-only host buffers (np.frombuffer over the payload) are
            # only ever read here: copy_ reads them into the new tensor
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(host)
        dst.copy_(src.reshape(dst.shape))
        return out

    def _decode_to_device(self, staged: "StagedLeaf", sds):
        """Copy each staged shard to the device and run its last decode
        step there (K4 over a byteplane stream, its ragged tail passed
        through; K6 over int8 q and scales), cast it to the leaf's dtype
        (``int8_codec.numpy_cast``, the host assemble's cast) and place it
        in its slice of the target range."""
        import torch

        from ..kernels.ckpt_codec import byteplane, int8_codec
        dtype, target = sds.dtype, staged.target
        shape = target.shape

        def piece_to_device(rng, piece):
            rdt = getattr(torch, codec_mod.dtype_name(piece.dtype))
            if isinstance(piece, codec_mod.Planes):
                raw = byteplane.inverse_planes(
                    self._upload(piece.stream, torch.uint8,
                                 piece.stream.shape), piece.k)
                t = raw.view(rdt)
            elif isinstance(piece, codec_mod.Quantized):
                t = int8_codec.dequantize_blocks(
                    self._upload(piece.q, torch.int8, piece.q.shape),
                    self._upload(piece.scales, torch.float32,
                                 piece.scales.shape), piece.n, rdt)
            else:
                t = self._upload(piece, rdt, piece.shape)
            return int8_codec.numpy_cast(t.reshape(rng.shape), dtype)

        if len(staged.pieces) == 1 and staged.pieces[0][0] == target:
            return piece_to_device(*staged.pieces[0])
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for rng, piece in staged.pieces:
            t = piece_to_device(rng, piece)
            if not shape:                    # scalar: any one source serves
                out.copy_(t.reshape(()))
                continue
            ov = overlap(rng, target)
            out[tuple(slice(a - s, b - s) for a, b, s
                      in zip(ov.start, ov.stop, target.start))] = \
                t[tuple(slice(a - s, b - s)
                        for a, b, s in zip(ov.start, ov.stop, rng.start))]
        return out

    def leaf_fetcher(self, step_dir, name, rec, np_dtype):
        """Host-side range fetch for one leaf: plan reads over the saved
        shard ranges, read/decode each, assemble the target range.

        Pipelined engine only: when a single saved shard covers the target
        range EXACTLY (the common same-topology restore), its decoded
        array is returned as-is — no assemble copy, no coverage mask. The
        serial engine keeps the original always-assemble path (it is the
        benchmark baseline)."""
        available = [(ShardRange(tuple(s["start"]), tuple(s["stop"])), s)
                     for s in rec["shards"]]
        exact_ok = not self.executor.serial

        def fetch(target: ShardRange) -> np.ndarray:
            picks = plan_reads(target, available)
            if exact_ok and len(picks) == 1 and \
                    picks[0][0].start == target.start and \
                    picks[0][0].stop == target.stop:
                arr = self.read_shard(step_dir, picks[0][1])
                if arr.dtype == np_dtype and arr.shape == target.shape:
                    return arr
                # dtype/shape drift: fall through to the casting assemble
            pieces = [(rng, self.read_shard(step_dir, s))
                      for rng, s in picks]
            try:
                return assemble(target, pieces, np_dtype)
            except LookupError as e:
                raise MissingShardError(str(e), leaf=name) from None

        return fetch

    # -- shard-level ---------------------------------------------------
    def read_shard(self, step_dir: str, srec: dict, staged: bool = False):
        """One saved shard, decoded; with `staged`, a ``STAGED`` codec's
        shard stops before its last transform (``codec.Planes``/
        ``codec.Quantized``, for the device decode)."""
        if "chunks" in srec:
            return self.read_chunked_shard(srec, staged)
        # step-scoped: shard file names repeat across steps, and a failed
        # restore can leave the cache populated for a different step; a
        # staged entry is not a decoded one
        key = f"{step_dir}/{srec['file']}" + ("#staged" if staged else "")
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        last_err = None
        for fname in srec.get("replicas", [srec["file"]]):
            rel = f"{step_dir}/{fname}"
            tier = self.store.locate(rel)
            if tier is None:
                last_err = MissingShardError("shard not on any tier",
                                             file=fname)
                continue
            try:
                if self.chunks.retry is not None:
                    raw = resilience.retry_io(
                        lambda: tier.read_file(rel), self.chunks.retry,
                        deadline=self.chunks._deadline,
                        health=self.store.health_for(tier),
                        op="shard_read")
                else:
                    raw = tier.read_file(rel)
                self._count_read(len(raw))
                rng, arr = unpack_shard(raw, staged)
                if fname != srec["file"]:
                    warn("CKPT_W_REPLICA", "primary shard unavailable; "
                         "restored from buddy replica", file=srec["file"])
                self.cache.put(key, arr)
                return arr
            except (CorruptShardError, OSError, ValueError) as e:
                last_err = e
                continue
        raise last_err if last_err else MissingShardError(
            "unreadable shard", file=srec["file"])

    def read_chunked_shard(self, srec: dict, staged: bool = False):
        """v3/v4/v5 incremental shard: reassemble the encoded payload via
        the prefetch pipeline (each chunk resolved fast tier → slow tier →
        buddy replica, the whole-payload crc as the end-to-end integrity
        gate), then decode.

        The pipelined engine places reads directly whenever chunk offsets
        are knowable up front — fixed chunking by construction
        (``i × chunk_size``; v3 records carry no scheme field — they ARE
        fixed), and any scheme whose record carries a chunk LENGTH list
        (v5 CDC records) via the prefix-sum offsets. Either way the reads
        land straight in a preallocated payload buffer with no
        assemble/join copy. Pre-conditioned codecs (byteplane) store the
        TRANSFORMED stream, so direct placement reassembles exactly those
        bytes and ``decode`` applies the inverse transform afterwards,
        driven by the record's self-describing meta."""
        # meta participates in the key: it drives decode for
        # pre-conditioned and int8 payloads, so records that share chunk
        # digests but differ in interpretation must not collide; nor may a
        # staged entry (the device decode's input) and a decoded one
        key = ("cas", tuple(srec["chunks"]), srec["codec"], srec["dtype"],
               tuple(srec["start"]), tuple(srec["stop"]),
               tuple(sorted((srec.get("meta") or {}).items())), staged)
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        fixed = srec.get("chunking", "fixed") == "fixed"
        chunk_size = srec.get("chunk_size") or 0
        chunk_lens = srec.get("chunk_lens")
        chunk_raw_lens = srec.get("chunk_raw_lens")
        payload_bytes = srec.get("payload_bytes")
        crc32 = srec.get("crc32")
        if chunk_raw_lens is not None and chunk_lens is not None \
                and payload_bytes is not None and crc32 is not None:
            # manifest v7 chunk-encoded record: chunk_lens are ENCODED
            # lengths, so direct placement (and its crc-gated verified
            # fallback inside read_payload_direct) reassembles exactly
            # the stored entropy-coded stream
            payload = self.chunks.read_payload_direct(
                srec["chunks"], payload_bytes, crc32, chunk_lens)
        elif fixed and chunk_size > 0 and payload_bytes is not None \
                and crc32 is not None:
            payload = self.chunks.read_payload_fixed(
                srec["chunks"], payload_bytes, chunk_size, crc32)
        elif chunk_lens is not None and payload_bytes is not None \
                and crc32 is not None:
            payload = self.chunks.read_payload_direct(
                srec["chunks"], payload_bytes, crc32, chunk_lens)
        else:
            payload = self.chunks.read_payload(srec["chunks"],
                                               payload_bytes, crc32=crc32)
        self._count_read(len(payload))
        rng = ShardRange(tuple(srec["start"]), tuple(srec["stop"]))
        if chunk_raw_lens is not None \
                and srec["codec"] in codec_mod.CHUNK_ENCODED:
            # per-chunk entropy decode AFTER placement, then the byteplane
            # inverse over the reassembled transformed stream
            enc_lens = chunk_lens if chunk_lens is not None \
                else [len(payload)]
            t = codec_mod.plane_decode_chunks(payload, enc_lens,
                                              chunk_raw_lens, srec["codec"])
            meta = srec.get("meta") or {}
            k = int(meta.get("bp")
                    or codec_mod._np_dtype(srec["dtype"]).itemsize)
            arr = codec_mod.Planes(t, k, srec["dtype"], rng.shape)
            if not staged:
                arr = arr.decode()
        else:
            decode = codec_mod.decode_stages if staged else codec_mod.decode
            arr = decode(payload, srec["codec"], rng.shape, srec["dtype"],
                         srec.get("meta", {}))
        self.cache.put(key, arr)
        return arr


class RestoreStream:
    """Streaming restore-behind handle (``CheckpointManager.
    restore_streaming``): every leaf's host fetch is already in flight,
    submitted in first-use order; this object releases each leaf to device
    placement as it lands.

    The contract callers rely on:

      * ``wait_frontier()`` blocks only until the first-use frontier
        (embedding + block 0 by default) is RESIDENT — host data landed
        and placed on device — so step-0 preparation can begin while tail
        layers stream in behind;
      * any touch of an un-landed leaf (``leaf(name)`` or the full
        ``state()``) blocks on that leaf's future — the completion gate.
        Restored values are therefore bit-exact by construction: the same
        host fetch and the same device placement as the blocking path,
        only ordered differently;
      * device placement happens on the CALLING thread, never pool
        workers, and each leaf is placed exactly once (touches are
        memoized). The object is NOT thread-safe — one consumer thread
        drives it, like the blocking restore it replaces.
    """

    def __init__(self, session: RestoreSession, plan: RestorePlan,
                 futures: list, template, schedule: list, frontier: list,
                 finalize=None):
        self._session = session
        self._plan = plan
        self._futures = futures
        self._template = template      # the abstract state tree
        self._schedule = schedule
        self._frontier = frontier
        self._finalize = finalize      # validation + cache clear, once
        self._placed: dict = {}
        self._state = None

    # -- introspection -------------------------------------------------
    @property
    def names(self) -> list:
        return [job[0] for job in self._plan.jobs]

    @property
    def frontier_names(self) -> list:
        return [self._plan.jobs[i][0] for i in self._frontier]

    def landed(self, name: str) -> bool:
        """True iff this leaf's host fetch has completed (placement may
        still be pending) — a touch of it would not block."""
        return self._futures[self._index(name)].done()

    def landed_count(self) -> int:
        return sum(1 for f in self._futures if f.done())

    # -- the stream ----------------------------------------------------
    def _index(self, name: str) -> int:
        for i, job in enumerate(self._plan.jobs):
            if job[0] == name:
                return i
        raise KeyError(name)

    def _place(self, i: int):
        if i not in self._placed:
            pre = self._futures[i].result()     # the completion gate
            self._placed[i] = self._session.leaf_to_device(
                self._plan.step_dir, self._plan.jobs[i], pre)
        return self._placed[i]

    def wait_frontier(self):
        """Block until the first-use frontier is resident on device;
        returns self (``stream.wait_frontier().leaf(...)``)."""
        for i in self._frontier:
            self._place(i)
        return self

    def leaf(self, name: str):
        """Device array for ONE leaf — blocks only on that leaf's future.
        Step-0 compute walks leaves in first-use order through this, so
        each touch overlaps the fetches still streaming behind it."""
        return self._place(self._index(name))

    def state(self):
        """Drain the stream: place every remaining leaf in first-use
        order as it lands, unflatten, run the finalize hook (registry
        validation + read-cache release). Idempotent — the gate that
        makes the restored state whole and bit-exact."""
        if self._state is not None:
            return self._state
        try:
            for i in self._schedule:
                self._place(i)
        except BaseException:
            # one failed leaf must not leave siblings running against a
            # caller that has moved on to raise/retry
            for f in self._futures:
                if f is not None and not f.done():
                    try:
                        f.result()
                    except BaseException:  # noqa — surfaced by the first
                        pass
            raise
        out = [self._placed[i] for i in range(len(self._plan.jobs))]
        state = tree_unflatten(self._template, out)
        if self._finalize is not None:
            self._finalize(state)
        self._state = state
        return state
