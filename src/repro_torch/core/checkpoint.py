"""Checkpoint save/restore — MANA's split-process C/R for PyTorch training
state on one device. This module is ORCHESTRATION ONLY: planning and IO
live in the staged pipeline engines (``core.save_path`` /
``core.restore_path``). It writes the JAX package's on-disk format (v7
manifests, the same CAS objects), so a checkpoint written by either
package restores bit-exact in the other.

The manager runs on ``device`` (``None`` → CUDA; a CUDA request without a
card raises): the CDC scan and the byteplane codecs' encode run there as
hand-written kernels (``core.cdc_scan``), and ``restore`` places leaves
there.

Save pipeline (two-phase commit, coordinator-supervised):

  stage 0  snapshot   drain → device→host copy (the only part the training
                      thread ever blocks on);
  stage 1  write      ``save_path.write_shards``: SavePlan assignment +
                      per-rank writer threads feeding a rank-wide
                      SaveSession queue (chunks flow across shard
                      boundaries with no per-shard drain bubble), one
                      batched durability fsync per rank, retrying 2PC
                      phase 1;
  stage 2  commit     manifest (single handle, P7) → atomic rename →
                      LATEST → refcount publication (incremental mode);
  stage 3  maintain   retention GC + CAS mark-and-sweep, then background
                      drain to the slow storage tier.

With ``blocking=False`` stages 1–3 run on the ``PersistStage`` thread and
overlap subsequent training steps; a preemption signal can request a
fast-flush (skip stage-3 maintenance, never the commit or the drain) so
the round lands and the process exits promptly.

Configuration is a composed, frozen ``CheckpointPolicy`` (``core.policy``):
``mode="full"`` writes every shard inline (v2 layout); ``incremental``
chunks encoded payloads into the content-addressed store (``core.cas``) —
unchanged chunks dedup to zero write cost. The chunking section picks
``fixed`` or ``cdc`` (FastCDC-style, ``core.cdc``, with a selectable
candidate-scan backend — numpy oracle or the device scan, ``core.cdc_scan``);
the pipeline section sizes the chunk pool and the bounded multi-round
persist queue (``persist_queue_depth``, ``host_bytes_budget``). Manifest
format v6 embeds the writer's effective policy, so restore and the
inspector adopt the writer's chunking/scan/codec settings with zero
caller configuration; v5 (chunk length lists for direct placement),
v4, v3 and v2 stay fully readable, including mixed histories.

Restore pipeline: manifest → RestorePlan (per-leaf jobs,
``elastic.plan_reads`` over the saved shard ranges) → RestoreSession
prefetch (leaf fan-out, chunk prefetch, direct placement into
preallocated buffers, crc gate) → device tensors built on the calling
thread → registry validation.
"""
from __future__ import annotations

import json
import shutil
import time
from collections import Counter
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..devices import resolve_device
from . import atomic, cas, cdc
from . import codec as codec_mod
from . import resilience, save_path
from .atomic import NO_CRASH, CrashInjector
from .chunk_exec import ChunkIOExecutor, cpu_cap
from .coordinator import CheckpointCoordinator
from .drain import DrainCounters, quiesce_device_state
from .errors import (AbortedError, CkptError, NoCheckpointError, SpaceError,
                     warn)
from .policy import (CHUNKINGS, MODES, CheckpointPolicy,
                     policy_from_manifest)
from .registry import build_registry, registry_json, validate_against
from .restore_path import (ReadCache, RestorePlan, RestoreSession,
                           RestoreStream, unpack_shard)
from .save_path import PersistStage, pack_shard, write_shards
from .split_state import leaf_paths, tree_unflatten
from .storage import TieredStore

FORMAT_VERSION = 7
# v2 = full-mode inline shards only; v3 = chunked records, implicitly
# fixed-size chunking (no per-record scheme field); v4 = chunking scheme
# per shard record; v5 = CDC shard records additionally carry their chunk
# LENGTH list (restore-side direct placement for content-defined chunks);
# v6 = the manifest embeds the writer's effective CheckpointPolicy, so
# restore and the inspector adopt the writer's chunking/scan/codec
# settings with zero caller configuration; v7 = chunk-encoded codec
# records (byteplane-rle/-rans) carry per-chunk (raw_len, enc_len) pairs:
# chunk_lens stay PHYSICAL (encoded bytes — offsets/crc describe what is
# read) and chunk_raw_lens drive the plane entropy decode after placement
READABLE_FORMATS = (2, 3, 4, 5, 6, 7)

# inspector/test compatibility: the shard codecs live with their pipeline
# stages now, but these names have external users
_pack_shard = pack_shard
_unpack_shard = unpack_shard


class CheckpointManager:
    """``CheckpointManager(store, policy=CheckpointPolicy(...))`` is the
    canonical constructor; every historical flat kwarg still works behind
    a single ``DeprecationWarning`` (``CheckpointPolicy.from_legacy_kwargs``
    maps each onto its policy field with identical validation).

    ``device`` (``None`` → CUDA) is where the device encode runs and where
    ``restore`` places leaves; the tests pass ``device="cpu"``.

    ``group`` (a ``torch.distributed`` process group, gloo) makes the
    manager one rank of a sharded save: every process of the group saves
    the items it owns, and the two-phase commit runs across them over
    `group` (``_write_round``). Rank 0 of the group writes the one
    manifest. ``None`` is a one-process manager."""

    def __init__(self, store: TieredStore,
                 policy: CheckpointPolicy | None = None, *, device=None,
                 group=None, **legacy):
        self.device = resolve_device(device)
        self.group = group
        if legacy:
            if policy is not None:
                raise TypeError(
                    "pass either policy=CheckpointPolicy(...) or legacy "
                    "flat kwargs, not both")
            policy = CheckpointPolicy.from_legacy_kwargs(**legacy)
        elif policy is None:
            policy = CheckpointPolicy()
        self.store = store
        self.policy = policy
        io_threads = policy.pipeline.io_threads
        # retain is the one knob operators tune at runtime (drop history
        # before an explicit gc()), so it stays a plain mutable attribute
        self.retain = policy.durability.retain
        self.coordinator = CheckpointCoordinator(
            policy.n_writers, keepalive_s=policy.durability.keepalive_s)
        self.counters = DrainCounters()
        # always constructed: a full-mode manager must still RESTORE
        # checkpoints written incrementally (and vice versa)
        self.chunks = cas.ChunkStore.from_policy(store, policy)
        # the tiered store shares the manager's retry budget so background
        # drain copies get the same bounded-retry treatment (None on the
        # serial engine: from_policy already dropped it — fail-fast)
        store.io_retry = self.chunks.retry
        # background drains reuse the chunk pool so fast-tier reads overlap
        # throttled slow-tier writes (first manager on a store wins)
        if getattr(store, "io_executor", None) is None:
            store.io_executor = self.chunks.executor
        store.apply_pipeline_policy(policy.pipeline)
        if hasattr(store, "apply_restore_policy"):
            store.apply_restore_policy(policy.restore)
        # leaf-level restore fan-out runs on its OWN pool: leaf tasks block
        # on chunk-prefetch futures, so sharing the chunk pool could
        # deadlock with every worker parked on a nested wait. Capped at
        # the core count — the leaf work (crc, join, decode, assemble) is
        # CPU/bandwidth bound, where extra threads only contend
        self._restore_exec = ChunkIOExecutor(
            min(io_threads, cpu_cap()) if io_threads > 1 else io_threads)
        # the multi-round persist queue: the serial engine is pinned to
        # depth 1 (it IS the serial baseline)
        self._persist = PersistStage(
            depth=policy.pipeline.effective_queue_depth,
            host_bytes_budget=policy.pipeline.host_bytes_budget)
        self._cache = ReadCache(policy.pipeline.read_cache_bytes)
        self._restore = RestoreSession(store, self.chunks,
                                       self._restore_exec, self._cache,
                                       self.device)
        self._manifest_refs_cache: dict = {}   # (tier, step) → Counter
        self.last_report: dict = {}
        self.last_gc_report: dict = {}
        # post-COMMIT hooks, called as hook(step, manifest) once the round
        # is durable (LATEST moved, refcounts published) but before the
        # slow-tier drain — the weightsync publisher announces here. A
        # hook failure warns and never aborts the save.
        self.on_commit: list = []
        self._bind_write_policy(policy)

    def _bind_write_policy(self, policy: CheckpointPolicy):
        """(Re)bind the write-side engines — codec resolution and the CDC
        chunker — to `policy`. Called at construction and by manifest-v6
        policy adoption on restore (pipeline/durability are never adopted:
        pool widths and failure clocks belong to THIS process). Atomic:
        every engine is built before anything is assigned, so a policy
        that parses but can't build (cdc below the scan window, an
        unavailable codec) leaves the manager exactly as it was."""
        # None → best codec the environment supports (zstd needs the
        # optional `zstandard` package; raw always works); resolution
        # fails fast with the real cause — otherwise every writer rank
        # dies on encode and the save aborts with an opaque "no surviving
        # writer ranks"
        codec, params_codec = policy.codec.resolved()
        # chunking="cdc": chunk_size becomes the content-defined AVERAGE
        # (min/avg/max = size/4, size, size*4 — FastCDC normalization);
        # the chunker is stateless and shared by every writer rank.
        # scan_backend picks the candidate-scan engine (core.cdc_scan);
        # the serial engine is pinned to the numpy oracle — it IS the
        # serial baseline, and accelerated scans must not leak into it
        chunker = cdc.GearChunker.from_policy(
            policy.chunking, serial=policy.pipeline.serial,
            device=self.device)
        self.policy = policy
        self.codec, self.params_codec = codec, params_codec
        self._chunker = chunker
        # byteplane codecs: run the forward transform on device, fused
        # into the CDC scan dispatch (auto: pipelined engine only — the
        # serial engine is pinned to the host oracle, serial-baseline purity)
        self.device_precondition = policy.codec.precondition_enabled(
            policy.pipeline.serial)
        # chunk-encoded codecs: run the plane entropy stage (RLE/rANS)
        # on device too, fused into the same dispatch — same serial
        # pinning (the serial engine is the host-oracle serial baseline)
        self.device_entropy = policy.codec.entropy_enabled(
            policy.pipeline.serial)
        # restore's device decode (K4 for byteplane leaves, K6 for int8)
        # follows the same knob and the same serial pinning
        self._restore.device_decode = self.device_precondition
        self.chunks.chunk_size = int(policy.chunking.chunk_size)

    # ---- policy-backed views (the pre-policy attribute surface) ----
    @property
    def mode(self) -> str:
        return self.policy.mode

    @property
    def chunking(self) -> str:
        return self.policy.chunking.scheme

    @property
    def n_writers(self) -> int:
        return self.policy.n_writers

    @property
    def replicas(self) -> int:
        return self.policy.durability.replicas

    @property
    def max_retries(self) -> int:
        """Node-failure recovery: a failed/dead writer rank is excluded
        and its shards redistributed to survivors, up to this many
        times."""
        return self.policy.durability.max_retries

    @property
    def save_timeout_s(self) -> float:
        return self.policy.durability.save_timeout_s

    def close(self):
        """Drain async work and tear down the IO pools (idempotent)."""
        self.wait()
        self.store.wait_drained()
        self.chunks.close()
        self._restore_exec.shutdown(wait=False)

    # ------------------------------------------------------------------
    # save: stage 0 (snapshot) inline, stages 1–3 inline or overlapped
    # ------------------------------------------------------------------
    def save(self, state, step: int, *, extra: dict | None = None,
             blocking: bool = True, crash: CrashInjector = NO_CRASH) -> dict:
        """Checkpoint `state` at `step`. With blocking=False only the
        device→host snapshot (plus queue admission, at
        ``persist_queue_depth>1``) is synchronous; chunk/hash/write/
        2PC-COMMIT run on the persist stage and overlap subsequent
        training steps. At depth 1 the drain protocol guarantees
        quiescence before the next round; deeper queues admit round N+1's
        snapshot while round N persists, gated by the host byte budget."""
        t0 = time.monotonic()
        queued = (not blocking) and self._persist.depth > 1
        est = 0
        admit_s = 0.0
        if queued:
            # multi-round persist queue: block only for ADMISSION — a free
            # in-flight slot under the host byte budget — so round N+1
            # snapshots while round N persists. Estimated from device
            # metadata because the budget gate must run BEFORE this
            # round's host copy exists. A failed earlier round surfaces
            # HERE (depth-1 parity: its wait() raises on the next save) —
            # never silently, checkpoints after it would be a lie.
            self._persist.raise_pending()
            est = save_path.estimate_snapshot_bytes(state,
                                                    self._device_int8())
            admit_s = self._persist.admit(est)
        else:
            # P4: quiescence before snapshot (depth-1 behaviour — and the
            # serial engine's only path: byte-for-byte the serial baseline)
            self.wait()                              # previous round drained
        degraded_hint = False
        try:
            wait_s = quiesce_device_state(state)
            registry = build_registry(state)
            items = self._snapshot(state)
            snap_s = time.monotonic() - t0
            # another rank's items (None here) pin nothing in this process
            total = sum(a.nbytes for _, _, a in items if a is not None)
            # P8 preflight must see the WHOLE queue's unwritten footprint:
            # earlier admitted rounds' chunks may not have hit the tier
            # yet, so their snapshot bytes (minus this round's own
            # reservation) are added to the requirement
            pending = max(self._persist.inflight_bytes - est, 0) \
                if queued else 0
            required = (total + pending) // max(self._est_ratio(), 1)
            try:
                self.store.fast.preflight(required)
            except SpaceError:
                # degraded-mode save (pipelined engine only): a full fast
                # tier fails the round over to the hierarchy below instead
                # of aborting — writers land objects via _put_degraded and
                # the manifest commits with a `degraded` marker. Serial
                # stays fail-fast (serial-baseline purity).
                fallback = self.store.slow or self.store.remote
                if self.chunks.retry is None or fallback is None:
                    raise
                warn("CKPT_W_DEGRADED",
                     "fast tier failed capacity preflight; saving "
                     "degraded through the lower tier(s)",
                     step=step, tier=fallback.name)
                fallback.preflight(required)
                degraded_hint = True
        except BaseException:
            if queued:
                # the admission reservation must not leak — a stuck slot
                # would wedge every later admit() at the depth bound
                self._persist.release(est)
            raise
        self.counters.enqueue(total)

        # exactly-once counter drain for this round: the abort path inside
        # the round AND the persist stage's error handler both reach for
        # it, and a double commit would skew the two-counter equality (P4)
        # forever — the trainer's next wait() would stall to timeout
        counted = {"done": False}

        def commit_total():
            if not counted["done"]:
                counted["done"] = True
                self.counters.commit(total)

        args = (items, registry, state, step, extra or {}, total, t0,
                snap_s, wait_s, crash, commit_total, degraded_hint)
        if blocking:
            try:
                return self._write_round(*args, overlapped=False)
            except BaseException:
                # ANY failure (not just the abort path, which drains its
                # own counters) must drain exactly once — e.g. an OSError
                # on the manifest write would otherwise skew the P4
                # equality and stall every later save in counters.wait()
                commit_total()
                raise
        self._persist.submit(
            lambda: self._write_round(*args, overlapped=True),
            # counters must still drain or the trainer deadlocks
            on_error=lambda e: commit_total(),
            nbytes=est, reserved=queued)
        return {"step": step, "async": True, "snapshot_s": snap_s,
                "admit_s": admit_s,
                "blocking_s": time.monotonic() - t0, "bytes": total}

    def _est_ratio(self):
        # plain byteplane is a size-preserving permutation — no entropy
        # stage, so its preflight estimate must not assume shrinkage
        return 2 if self.codec not in ("raw", "byteplane") else 1

    def _effective_policy_dict(self) -> dict:
        """The policy block a v6 manifest embeds: ``self.policy`` with the
        codec section pinned to the RESOLVED codecs (a reader must see
        what was written, not this writer's "best available")."""
        pd = self.policy.to_dict()
        pd["codec"] = {"codec": self.codec,
                       "params_codec": self.params_codec}
        return pd

    def _maybe_adopt_manifest_policy(self, manifest: dict, step: int):
        """Manifest-v6 policy reconciliation: when the caller's
        chunking/codec config differs from what the checkpoint's writer
        recorded, the MANIFEST wins — restore itself is record-driven
        either way, but a drifted caller would silently mis-deduplicate
        every FUTURE save against the restored history (new chunk grid →
        zero dedup). A corrupted policy block degrades to a warning, never
        a failed restore."""
        if int(manifest.get("format", 0)) < 6:
            return
        try:
            written = policy_from_manifest(manifest)
        except Exception as e:  # noqa — untrusted block, any shape
            warn("CKPT_W_POLICY",
                 "manifest carries an unreadable policy block; restoring "
                 "on the caller's policy (shard records are "
                 "self-describing)", step=step,
                 error=f"{type(e).__name__}: {e}")
            return
        if written is None:
            return
        adopted = []
        new_chunking = self.policy.chunking
        if written.chunking != new_chunking:
            new_chunking = written.chunking
            adopted.append("chunking")
        new_codec = self.policy.codec
        wc, wp = written.codec.codec, written.codec.params_codec
        if wc is not None and \
                (wc, wp or wc) != (self.codec, self.params_codec):
            if all(codec_mod.available(c) for c in {wc, wp or wc}):
                # codec NAMES are adopted (they define the stored bytes);
                # device_precondition / device_entropy stay the reader's —
                # machine-local perf knobs producing identical bytes, and
                # the writer's device may not exist here
                new_codec = replace(
                    written.codec,
                    device_precondition=self.policy.codec
                    .device_precondition,
                    device_entropy=self.policy.codec.device_entropy)
                adopted.append("codec")
            else:
                warn("CKPT_W_POLICY",
                     "checkpoint writer's codec is unavailable in this "
                     "environment; keeping the caller's codec",
                     writer_codec=wc, step=step)
        if not adopted:
            return
        warn("CKPT_W_POLICY",
             "caller policy differs from the checkpoint writer's; "
             "adopting the manifest's settings so future saves keep "
             "deduplicating against this history",
             adopted=adopted, step=step)
        # queued persist rounds read the live chunker/chunk_size: quiesce
        # them before the rebind, or an in-flight round would chunk on two
        # grids and record bounds its records weren't produced with
        self.wait()
        try:
            self._bind_write_policy(replace(self.policy,
                                            chunking=new_chunking,
                                            codec=new_codec))
        except Exception as e:  # noqa — e.g. bounds GearChunker rejects
            # a block that PARSES but can't build an engine (cdc with a
            # sub-window average, min > avg, …) must also degrade to a
            # warning — restore never depends on the write-side engines
            warn("CKPT_W_POLICY",
                 "writer policy is unusable in this process; keeping the "
                 "caller's policy", step=step,
                 error=f"{type(e).__name__}: {e}")

    def wait(self):
        """Drain the persist stage (two-counter equality, P4)."""
        self._persist.wait()
        if not self.counters.drained():
            self.counters.wait(timeout=self.save_timeout_s)

    def request_fast_flush(self):
        """Preemption hook (signal-handler safe): ask the in-flight
        overlapped round to skip non-essential maintenance and land."""
        self._persist.request_fast_flush()

    def _snapshot(self, state) -> list:
        """Stage 0: device → host copy (``save_path.snapshot_items``) —
        the only part of an overlapped save the training thread waits on.
        Kept as an instance method so tests can interpose topologies."""
        return save_path.snapshot_items(state, self._restore_exec,
                                        quantize=self._device_int8())

    def _leaf_codec(self, leaf_name: str) -> str:
        if leaf_name.startswith("params/"):
            return self.params_codec
        return self.codec

    def _device_int8(self):
        """The leaf-name predicate of the snapshot's K5 route (int8-coded
        leaves quantized on the device before the D2H copy; same payload
        and meta as the host codec), or None where device pre-conditioning
        is off: the serial engine and ``device_precondition=False`` keep
        the host oracle."""
        if not self.device_precondition or \
                "int8" not in (self.codec, self.params_codec):
            return None
        return lambda name: self._leaf_codec(name) == "int8"

    def _write_round(self, items, registry, state, step, extra, total, t0,
                     snap_s, wait_s, crash, commit_total,
                     degraded_hint: bool = False,
                     overlapped: bool = False) -> dict:
        stage = atomic.staging_dir(self.store.root, step)
        lead = True
        if self.group is not None:
            # one staging dir for the round: full-mode shard files of every
            # process land where rank 0 commits them
            import torch.distributed as dist
            name = [stage.name]
            dist.broadcast_object_list(name, src=0, group=self.group)
            stage = stage.parent / name[0]
            lead = dist.get_rank(self.group) == 0
        stage.mkdir(parents=True, exist_ok=True)
        if lead:
            atomic.mark_pending(stage, {"step": step, "t": time.time()})
        incremental = self.mode == "incremental"
        pre_degraded = self.chunks.degraded_writes

        # ---- stage 1: plan + write (retrying 2PC phase 1) ----
        outcome = write_shards(
            items=items, alive_hint=self.n_writers,
            coordinator=self.coordinator, chunks=self.chunks,
            store=self.store, rel_stage=stage.name, step=step,
            incremental=incremental, chunking=self.chunking,
            chunker=self._chunker, replicas=self.replicas,
            leaf_codec=self._leaf_codec, max_retries=self.max_retries,
            save_timeout_s=self.save_timeout_s, crash=crash,
            overlapped=overlapped,
            device_precondition=self.device_precondition,
            device_entropy=self.device_entropy, device=self.device)
        if self.group is None:
            return self._commit_round(
                outcome, stage, registry, state, step, extra, total, t0,
                snap_s, wait_s, crash, commit_total, incremental,
                degraded_hint, pre_degraded, overlapped)
        # two-phase commit across processes: each process has prepared
        # (written and fsynced) its own items; rank 0 gathers every
        # process's vote, records and refcount deltas, writes the one
        # manifest or aborts, and every process learns the outcome
        # before its save returns
        vote = {"ok": outcome.ok, "reason": outcome.reason, "bytes": total,
                "records": (outcome.shard_records if incremental
                            else outcome.plan.manifest_shards)
                if outcome.ok else {},
                "refs": dict(self.coordinator.round.chunk_refs)
                if outcome.ok and self.coordinator.round else {},
                "stats": dict(outcome.stats),
                "new_objects": outcome.new_objects,
                "degraded": self.chunks.degraded_writes > pre_degraded}
        rank = dist.get_rank(self.group)
        votes = [None] * dist.get_world_size(self.group) if rank == 0 \
            else None
        dist.gather_object(vote, votes, dst=0, group=self.group)
        if rank != 0:
            decision = [None]
            dist.broadcast_object_list(decision, src=0, group=self.group)
            if outcome.ok:
                # rank 0 published the round's merged refcounts
                self.coordinator.finish_round(decision[0]["ok"])
            commit_total()
            if not decision[0]["ok"]:
                raise AbortedError("checkpoint aborted", step=step,
                                   reason=decision[0]["reason"])
            report = dict(decision[0]["report"], snapshot_s=snap_s,
                          rank_bytes=total, drain_wait_s=wait_s,
                          blocking_s=snap_s if overlapped
                          else time.monotonic() - t0)
            self.last_report = report
            return report
        decision = {"ok": False, "reason": ""}
        try:
            failed = [(r, v["reason"]) for r, v in enumerate(votes)
                      if not v["ok"]]
            if failed:
                if outcome.ok:
                    self.coordinator.finish_round(False)
                outcome.ok = False
                outcome.reason = "; ".join(f"rank {r}: {why}"
                                           for r, why in failed)
            else:
                merged = outcome.shard_records if incremental \
                    else outcome.plan.manifest_shards
                objects: dict | None = {}
                for v in votes:
                    merged.update(v["records"])
                    if v["new_objects"] is None or objects is None:
                        objects = None
                    else:
                        objects.update(v["new_objects"])
                for v in votes[1:]:
                    self.coordinator.round.chunk_refs.update(v["refs"])
                    for k, n in v["stats"].items():
                        outcome.stats[k] += n
                if objects is not None:
                    # an object two processes raced to write counts once,
                    # as in one process (``ChunkStore``'s in-flight set)
                    outcome.stats["new_object_bytes"] = \
                        sum(objects.values())
            decision["reason"] = outcome.reason
            report = self._commit_round(
                outcome, stage, registry, state, step, extra,
                sum(v["bytes"] for v in votes), t0, snap_s, wait_s, crash,
                commit_total, incremental,
                degraded_hint or any(v["degraded"] for v in votes),
                pre_degraded, overlapped)
            report["rank_bytes"] = total
            decision = {"ok": True, "report": report}
            return report
        finally:
            dist.broadcast_object_list([decision], src=0, group=self.group)

    def _commit_round(self, outcome, stage, registry, state, step, extra,
                      total, t0, snap_s, wait_s, crash, commit_total,
                      incremental, degraded_hint, pre_degraded,
                      overlapped) -> dict:
        """Stages 2–3 of a round whose phase 1 is decided: abort, or write
        the manifest, commit, publish refcounts, maintain and drain."""
        if not outcome.ok:
            # ABORT leaks nothing: no manifest, no LATEST move, and no
            # refcounts published — chunk objects a dead rank managed to
            # write are unreferenced orphans that the next sweep reclaims
            shutil.rmtree(stage, ignore_errors=True)
            commit_total()
            raise AbortedError("checkpoint aborted", step=step,
                               reason=outcome.reason)
        stats = outcome.stats

        # ---- stage 2: manifest = commit record (single handle, P7) ----
        leaf_specs = [(name, tuple(leaf.shape), codec_mod.dtype_name(leaf))
                      for name, leaf in leaf_paths(state)]
        leaves = outcome.plan.manifest_leaves(
            leaf_specs, outcome.shard_records if incremental else None)
        manifest = {
            "format": FORMAT_VERSION,
            "mode": self.mode,
            "step": step,
            "created": time.time(),
            "chunk_size": self.chunks.chunk_size if incremental else None,
            "chunking": self.chunking if incremental else None,
            # CDC bound triple (min/avg/max): lets the inspector compare
            # the realized chunk-size distribution against what was asked
            "chunk_bounds": ([self._chunker.min_size, self._chunker.avg_size,
                              self._chunker.max_size]
                             if incremental and self._chunker is not None
                             else None),
            # v6: the writer's EFFECTIVE policy (codec resolved) rides the
            # manifest, so a restarted job adopts the writer's
            # chunking/scan/codec settings with zero caller configuration
            "policy": self._effective_policy_dict(),
            "leaves": leaves,
            "registry": registry_json(registry),
            "extra": extra,
        }
        degraded = bool(degraded_hint or
                        self.chunks.degraded_writes > pre_degraded)
        if degraded:
            # only present when True: older readers' lenient from_dict
            # ignores the key, and clean manifests stay byte-identical
            manifest["degraded"] = True
            warn("CKPT_W_DEGRADED",
                 "round committed degraded: objects written past the "
                 "fast tier; restore reads them from the lower tier(s)",
                 step=step,
                 objects=self.chunks.degraded_writes - pre_degraded)
        crash.maybe("before_manifest")
        atomic.atomic_write_bytes(stage / atomic.MANIFEST,
                                  json.dumps(manifest).encode(), crash)
        atomic.clear_pending(stage)
        final = atomic.committed_dir(self.store.root, step)
        atomic.commit_dir(stage, final, crash)
        crash.maybe("before_latest_write")
        atomic.write_latest(self.store.root, step, crash)
        # COMMIT phase: the coordinator publishes the round's aggregated
        # chunk refcounts atomically; the digests are captured first so the
        # new objects can be drained to the slow tier below
        coord = self.coordinator
        round_digests = sorted(coord.round.chunk_refs) if coord.round else []
        coord.finish_round(
            True,
            publish_refs=(
                (lambda refs: self.chunks.apply_refs(refs, crash))
                if incremental else None))
        commit_total()
        for hook in list(self.on_commit):
            # announcement plane: distribution is best-effort, durability
            # is not — a publisher failure must never abort a committed
            # save
            try:
                hook(step, manifest)
            except Exception as e:  # noqa: BLE001
                warn("CKPT_W_HOOK", "on_commit hook failed",
                     step=step, detail=f"{e.__class__.__name__}: {e}")

        # ---- stage 3: maintenance + slow-tier drain ----
        if overlapped and self._persist.fast_flush_requested:
            # preemption fast-flush: the commit above is durable; skip the
            # O(objects + history) sweep so the process can exit. The drain
            # below still runs — a committed round must reach the slow tier
            # or later deduped rounds would reference fast-only objects.
            self.last_gc_report = {"skipped": True, "reason": "fast-flush"}
        else:
            self.last_gc_report = self._gc_locked(crash=crash)
        self.store.drain_step(
            final.name,
            extra_files=[cas.object_rel(d, r)
                         for d in round_digests
                         for r in range(self.chunks.replicas)])
        dt = time.monotonic() - t0
        report = {
            "step": step, "mode": self.mode, "bytes": total,
            "payload_bytes": stats["payload_bytes"],
            "written_bytes": stats["written_bytes"],
            "files": stats["files"], "seconds": dt,
            "snapshot_s": snap_s, "drain_wait_s": wait_s,
            "overlapped": overlapped,
            "blocking_s": snap_s if overlapped else dt,
            "throughput_gbps": total / dt / 1e9 if dt else 0.0,
            "compression_ratio": total / max(stats["payload_bytes"], 1),
            "degraded": degraded,
        }
        if incremental:
            # dedup ratio compares logical payload to per-copy object
            # bytes — new_object_bytes counts physical IO across replica
            # copies, which would read as 0.5× dedup on a cold save with
            # buddy redundancy
            per_copy = stats["new_object_bytes"] / self.chunks.replicas
            report.update(
                chunks=stats["chunks"],
                new_object_bytes=stats["new_object_bytes"],
                dedup_ratio=stats["payload_bytes"] / max(per_copy, 1))
        self.last_report = report
        return report

    # ------------------------------------------------------------------
    # GC: step retirement + CAS mark-and-sweep
    # ------------------------------------------------------------------
    def _live_chunk_refs(self, tiers=None, errors: list | None = None) \
            -> Counter:
        """Mark phase (``save_path.collect_live_refs``), memoized per
        (tier, step) so each save only parses the manifest it just wrote."""
        return save_path.collect_live_refs(self.store,
                                           self._manifest_refs_cache,
                                           tiers=tiers, errors=errors)

    def gc(self, *, crash: CrashInjector = NO_CRASH) -> dict:
        """Retire fast-tier steps beyond `retain`, clear staging litter,
        then mark-and-sweep the content-addressed store. Crash-safe: the
        mark set derives only from committed manifests, so a crash at any
        point here is repaired by the next gc() — committed checkpoints
        never lose chunks. Serializes with an in-flight async save: a
        round's fresh chunks are unreferenced until its manifest commits,
        and sweeping mid-round would reap them."""
        self.wait()
        return self._gc_locked(crash=crash, force_sweep=True)

    def scrub(self, *, sample: int | None = None, seed: int = 0,
              should_stop=None, crash: CrashInjector = NO_CRASH) -> dict:
        """Re-hash the live object set (or a seeded `sample`), quarantine
        corrupt copies and heal them from a good replica/tier
        (``ChunkStore.scrub``). Runs through the maintenance pass with
        ``retain=0`` so NO retention is applied — scrubbing must never
        drop history. Returns the maintenance report; the scrub summary
        is under ``report["scrub"]`` and persisted to
        ``_CAS/last_scrub.json`` for the offline inspector."""
        self.wait()
        self.store.wait_drained()
        return save_path.run_maintenance(
            self.store, self.chunks, 0, self._live_chunk_refs,
            crash=crash, scrub=True, scrub_sample=sample, scrub_seed=seed,
            should_stop=should_stop)

    def _gc_locked(self, *, crash: CrashInjector = NO_CRASH,
                   force_sweep: bool = False) -> dict:
        """Stage-3 body (``save_path.run_maintenance``) — called directly
        by the save round itself (which IS the persist thread, so it must
        not self-join via wait())."""
        return save_path.run_maintenance(
            self.store, self.chunks, self.retain, self._live_chunk_refs,
            crash=crash, force_sweep=force_sweep)

    # ------------------------------------------------------------------
    # restore: manifest → RestorePlan → prefetch → device placement
    # ------------------------------------------------------------------
    def latest_step(self):
        """Newest restorable step. A crash between the commit rename and
        the LATEST write leaves LATEST one step behind the newest committed
        dir; trusting the pointer alone would make a restarted trainer
        re-save that step and die on FileExistsError forever, so the answer
        is max(LATEST, newest committed step on any tier)."""
        latest = atomic.read_latest(self.store.root)
        committed = [s for tier in self.store.tiers()
                     for s in atomic.list_committed_steps(tier.root)]
        newest = max(committed, default=None)
        if latest is None or (newest is not None and newest > latest):
            return newest
        return latest

    def load_manifest(self, step: int) -> dict:
        rel = f"{atomic.committed_dir(Path('.'), step).name}/{atomic.MANIFEST}"
        tier = self.store.locate(rel)
        if tier is None:
            raise NoCheckpointError("no manifest for step", step=step)
        if self.chunks.retry is not None:
            manifest = json.loads(resilience.retry_io(
                lambda: tier.read_file(rel), self.chunks.retry,
                health=self.store.health_for(tier), op="manifest_read"))
        else:
            manifest = json.loads(tier.read_file(rel))
        fmt = int(manifest.get("format", 0))
        if fmt not in READABLE_FORMATS:
            raise CkptError("unsupported manifest format", format=fmt,
                            readable=list(READABLE_FORMATS), step=step)
        return manifest

    def _plan_restore(self, abstract_state, shardings, step):
        """Shared restore prelude: resolve the step, load + reconcile the
        manifest, and build the per-leaf plan. Returns (step, manifest,
        step_dir, plan)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise NoCheckpointError("no committed checkpoint found",
                                    root=str(self.store.root))
        # one shared IO-retry deadline for the whole restore round
        self.chunks.begin_io_window()
        self._restore.bytes_read = 0
        manifest = self.load_manifest(step)
        # v6: the writer's recorded policy wins over a mismatched caller —
        # logged reconciliation, and future saves dedup against history
        self._maybe_adopt_manifest_policy(manifest, step)
        step_dir = atomic.committed_dir(Path("."), step).name
        paths = leaf_paths(abstract_state)
        shard_flat = [None] * len(paths) if shardings is None \
            else [sh for _, sh in leaf_paths(shardings)]
        if len(shard_flat) != len(paths):
            raise ValueError("shardings and abstract_state differ in "
                             f"leaves ({len(shard_flat)} != {len(paths)})")
        plan = RestorePlan.build(manifest, step_dir, [n for n, _ in paths],
                                 [leaf for _, leaf in paths], shard_flat,
                                 step)
        return step, manifest, step_dir, plan

    @property
    def bytes_read(self) -> int:
        """Stored bytes the latest restore read (this process)."""
        return self._restore.bytes_read

    @staticmethod
    def _drain_futures(futures):
        """After a failed leaf: absorb the in-flight siblings so no pool
        worker is left running against a caller that has moved on."""
        for f in futures:
            if f is not None and not f.done():
                try:
                    f.result()
                except BaseException:  # noqa — surfaced by the first
                    pass

    def restore(self, abstract_state, shardings=None, *,
                step: int | None = None, validate: bool = True,
                leaf_priority=None):
        """Restore onto ``self.device``. `abstract_state`: nested dict of
        tensors (or meta tensors — only shapes/dtypes are used);
        `shardings`: the matching tree of ``sharding.partition.
        NamedSharding`` (every leaf a ``DTensor`` of this rank's range,
        read from the saved shards that overlap it — M×N), or None for one
        device. Returns (state, extra).

        Pipelined engine: per-leaf host fetches are dispatched in
        FIRST-USE order (``elastic.leaf_first_use_class``, or a
        model-supplied `leaf_priority`) and each leaf releases to device
        placement as it lands — placement of early leaves overlaps the
        fetches still streaming behind them, no ``map_ordered`` barrier.
        The serial engine keeps the original two-phase path. Device
        tensors are built on the calling thread either way."""
        step, manifest, step_dir, plan = self._plan_restore(
            abstract_state, shardings, step)
        if self._restore_exec.serial:
            prefetched = self._restore.prefetch(plan)
            out = [self._restore.leaf_to_device(step_dir, job, pre)
                   for job, pre in zip(plan.jobs, prefetched)]
        else:
            schedule, _ = plan.first_use_schedule(
                leaf_priority, self.policy.restore.frontier_classes)
            futures = self._restore.prefetch_async(plan, schedule)
            out = [None] * len(plan.jobs)
            try:
                # place the leaves in the order their fetches went out,
                # and drop each host copy once it is placed: the host
                # holds the fetches in flight, not the whole state
                for i in schedule:
                    out[i] = self._restore.leaf_to_device(
                        step_dir, plan.jobs[i], futures[i].result())
                    futures[i] = None
            except BaseException:
                self._drain_futures(futures)
                raise
        state = tree_unflatten(abstract_state, out)
        if validate:
            validate_against(state, manifest["leaves"])
        self._cache.clear()
        return state, manifest.get("extra", {})

    def restore_streaming(self, abstract_state, shardings=None, *,
                          step: int | None = None, validate: bool = True,
                          leaf_priority=None):
        """Streaming restore-behind: returns ``(RestoreStream, extra)``
        with every per-leaf host fetch already in flight in first-use
        order. ``stream.wait_frontier()`` blocks only until the leading
        first-use classes (``policy.restore.frontier_classes``) are
        resident, so the caller begins step-0 preparation while tail
        leaves stream in; any touch of an un-landed leaf — including the
        final ``stream.state()`` completion gate — blocks on that leaf's
        future, so the restored state is bit-exact with the blocking path
        by construction. Registry validation and the read-cache release
        run once, inside the completion gate."""
        _, manifest, _, plan = self._plan_restore(abstract_state,
                                                  shardings, step)
        schedule, frontier = plan.first_use_schedule(
            leaf_priority, self.policy.restore.frontier_classes)
        futures = self._restore.prefetch_async(plan, schedule)

        def finalize(state):
            if validate:
                validate_against(state, manifest["leaves"])
            self._cache.clear()

        stream = RestoreStream(self._restore, plan, futures, abstract_state,
                               schedule, frontier, finalize=finalize)
        return stream, manifest.get("extra", {})

    # ------------------------------------------------------------------
    # compatibility shims: tests and operator tooling reach these names
    # ------------------------------------------------------------------
    def _read_shard(self, step_dir: str, srec: dict) -> np.ndarray:
        return self._restore.read_shard(step_dir, srec)

    def _cache_get(self, key):
        return self._cache.get(key)

    def _cache_put(self, key, arr):
        self._cache.put(key, arr)

    @property
    def _read_cache(self):
        return self._cache.entries

    @property
    def _read_cache_bytes(self) -> int:
        return self._cache.nbytes

    @property
    def read_cache_limit(self) -> int:
        return self._cache.limit

    @read_cache_limit.setter
    def read_cache_limit(self, v: int):
        self._cache.limit = v
