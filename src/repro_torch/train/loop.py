"""Production training loop with first-class C/R (``src/repro/train/
loop.py`` on PyTorch — the paper's integration point): restore-on-start,
periodic async checkpoints, preemption handling, drain-before-snapshot,
coordinator-supervised writes.

The Trainer owns the *lower half* (device, step function, pipeline
objects) and treats the *upper half* (TrainState + DataState) as opaque
checkpointable data — the split-process discipline as code structure.
``device`` (``None`` → CUDA) names the card. Without a ``mesh`` one device
holds the whole state. With one (``launch.mesh``: one process per rank),
every state leaf is a ``DTensor`` placed by the reference's partition
rules (``core.split_state.state_shardings``), the Trainer installs the
reference's activation layout (``set_constrainer(act_constrainer(cfg,
mesh))``; it never sets the exec mesh, as the reference's Trainer does
not), each rank keeps its rows of the batch, the step computes the
one-device function with that layout on the local shards
(``train.steps._layout_step``), and each rank saves the ranges it owns
into the one manifest (``CheckpointManager(group=)``), so a checkpoint of
one mesh restores onto any other.
"""
from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass

from ..core.checkpoint import CheckpointManager
from ..core.policy import CheckpointPolicy
from ..core.preempt import PreemptionGuard
from ..core.save_path import to_host
from ..core.split_state import (abstract_train_state, config_digest,
                                init_train_state, leaf_paths,
                                lower_half_descriptor, state_shardings)
from ..core.storage import TieredStore, default_store
from ..data.pipeline import DataState, SyntheticPipeline
from ..devices import resolve_device
from ..models import Model
from ..models.model import set_constrainer
from ..optim import make_optimizer
from ..sharding.partition import (act_constrainer, batch_spec,
                                  distribute_tree)
from .steps import make_train_step

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainerConfig:
    workdir: str
    batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 20
    async_ckpt: bool = True
    retain: int = 3
    n_writers: int = 4
    codec: str | None = None        # None = best available (zstd, else raw)
    params_codec: str | None = None
    ckpt_mode: str = "full"         # "incremental" = CAS dedup checkpoints
    chunk_size: int = 1 << 20
    chunking: str = "fixed"         # "cdc" = content-defined (shift-tolerant)
    scan_backend: str = "auto"      # cdc candidate scan engine (cdc_scan)
    io_threads: int = 4             # chunk-IO pipeline width (1 = serial)
    persist_queue_depth: int = 1    # async rounds in flight (>1 = queue)
    host_bytes_budget: int | None = None  # cap on queued snapshot bytes
    replicas: int = 1
    seed: int = 0
    log_every: int = 10
    grad_accum: int = 1
    burst_buffer: bool = False      # /dev/shm tier (benchmarks turn this on)
    lustre_bw: float | None = None  # None = unthrottled slow tier
    streaming_restore: bool = False  # begin step 0 at the first-use frontier
    remote_dir: str | None = None   # mount a cold object-store tier
    remote_bw: float | None = None  # None = unthrottled remote tier
    remote_latency_s: float = 0.0   # per-request latency of the remote tier


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig, *,
                 store: TieredStore | None = None, device=None, mesh=None):
        self.cfg = model_cfg
        self.tcfg = tcfg
        # ---- lower half bring-up (the "trivial MPI application") ----
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = Model(model_cfg)
        self.optimizer = make_optimizer(model_cfg)
        self._abstract = abstract_train_state(self.model, self.optimizer)
        self._shardings = None
        rows, batch_axes, group = None, (), None
        if mesh is not None:
            import torch
            import torch.distributed as dist
            self._shardings = state_shardings(self._abstract, mesh,
                                              self.optimizer)
            shape = (tcfg.batch, tcfg.seq_len)
            bs = batch_spec({"rows": torch.empty(shape, device="meta")},
                            mesh, model_cfg)["rows"]
            rng = bs.local_range(shape)
            rows, batch_axes = (rng.start[0], rng.stop[0]), \
                bs.dim_axes(2)[0]
            layout = act_constrainer(model_cfg, mesh)
            layout.batch_axes = batch_axes
            set_constrainer(layout)
            if dist.get_world_size() > 1:
                # the checkpoint's control messages ride their own gloo
                # group (made here, in the same order on every rank), so an
                # async save's persist thread never issues collectives on
                # the group the step uses
                group = dist.new_group(backend="gloo")
        else:
            set_constrainer(None)
        self.pipeline = SyntheticPipeline(model_cfg, batch=tcfg.batch,
                                          seq_len=tcfg.seq_len,
                                          device=self.device, rows=rows)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       grad_accum=tcfg.grad_accum,
                                       shardings=self._shardings,
                                       batch_axes=batch_axes)
        store = store or default_store(tcfg.workdir,
                                       burst_buffer=tcfg.burst_buffer,
                                       lustre_bw=tcfg.lustre_bw,
                                       remote_dir=tcfg.remote_dir,
                                       remote_bw=tcfg.remote_bw,
                                       remote_latency_s=tcfg.remote_latency_s)
        # TrainerConfig's flat checkpoint fields compose into the policy
        # object, with REPRO_CKPT_* env overrides merged last
        policy = CheckpointPolicy().with_overrides(
            mode=tcfg.ckpt_mode, n_writers=tcfg.n_writers,
            codec=tcfg.codec, params_codec=tcfg.params_codec,
            replicas=tcfg.replicas, retain=tcfg.retain,
            chunk_size=tcfg.chunk_size, chunking=tcfg.chunking,
            scan_backend=tcfg.scan_backend, io_threads=tcfg.io_threads,
            persist_queue_depth=tcfg.persist_queue_depth,
            host_bytes_budget=tcfg.host_bytes_budget,
            streaming_restore=tcfg.streaming_restore)
        self.manager = CheckpointManager(
            store, policy=CheckpointPolicy.from_env(base=policy),
            device=self.device, group=group)
        # ---- upper half ----
        self.state = None
        self.data_state: DataState | None = None
        self.py_step = 0
        self.history: list = []
        self.restored_from = None
        self._restore_stream = None     # in-flight streaming restore
        self._pending_batch = None      # step-0 input staged during the tail

    # ------------------------------------------------------------------
    def _extra(self) -> dict:
        return {
            "data_state": self.data_state.to_json(),
            "arch": self.cfg.arch_id,
            "config_digest": config_digest(self.cfg),
            "lower_half": lower_half_descriptor(self.mesh,
                                                self.cfg).to_json(),
            "py_step": self.py_step,
        }

    def init_or_restore(self):
        latest = self.manager.latest_step()
        if latest is None:
            self.state = init_train_state(self.model, self.optimizer,
                                          seed=self.tcfg.seed,
                                          device=self.device)
            if self._shardings is not None:
                self.state = distribute_tree(self.state, self._shardings)
            self.data_state = self.pipeline.init_state(self.tcfg.seed)
            self.py_step = 0
            log.info("initialized fresh state (seed=%d)", self.tcfg.seed)
        elif self.manager.policy.restore.streaming:
            # streaming restore-behind: every leaf fetch is in flight in
            # first-use order; fit() begins step 0 once the frontier is
            # resident and drains the tail behind the completion gate
            self._restore_stream, extra = self.manager.restore_streaming(
                self._abstract, self._shardings, step=latest)
            self.data_state = DataState.from_json(extra["data_state"])
            self.py_step = int(extra.get("py_step", latest))
            self.restored_from = latest
            log.info("restoring step %d STREAMING (%d leaves in flight, "
                     "frontier %d)", latest, len(self._restore_stream.names),
                     len(self._restore_stream.frontier_names))
        else:
            self.state, extra = self.manager.restore(
                self._abstract, self._shardings, step=latest)
            self.data_state = DataState.from_json(extra["data_state"])
            self.py_step = int(extra.get("py_step", latest))
            self.restored_from = latest
            log.info("restored step %d (upper half) onto %s%s (lower half "
                     "rebuilt)", latest, self.device,
                     "" if self.mesh is None
                     else f", mesh {tuple(self.mesh.shape)}")
        return self

    def save(self, *, blocking: bool = True):
        if self._restore_stream is not None:
            self._finish_streaming_restore()
        return self.manager.save(self.state, self.py_step,
                                 extra=self._extra(), blocking=blocking)

    def _finish_streaming_restore(self):
        """Begin step 0 at the first-use frontier: once the frontier is
        resident, stage the step-0 batch (pipeline fetch + host→device
        copy overlap the still-streaming tail), then cross the completion
        gate — every remaining leaf placed as it lands, the full state
        whole and bit-exact before the first step."""
        stream, self._restore_stream = self._restore_stream, None
        t0 = time.monotonic()
        stream.wait_frontier()
        t_frontier = time.monotonic() - t0
        log.info("restore frontier resident in %.3fs (%d/%d leaves "
                 "landed) — beginning step 0 behind the completion gate",
                 t_frontier, stream.landed_count(), len(stream.names))
        self._pending_batch = self.pipeline.next(self.data_state)
        self.state = stream.state()
        log.info("restore stream complete in %.3fs (tail %.3fs behind "
                 "the frontier)", time.monotonic() - t0,
                 time.monotonic() - t0 - t_frontier)

    # ------------------------------------------------------------------
    def fit(self, n_steps: int, *, guard: PreemptionGuard | None = None,
            stop_after: int | None = None) -> dict:
        """Run until `n_steps` total steps (absolute), a preemption signal,
        or `stop_after` additional steps (tests). Returns a status report."""
        assert self.state is not None or self._restore_stream is not None, \
            "call init_or_restore() first"
        if self._restore_stream is not None:
            self._finish_streaming_restore()
        own_guard = guard is None
        guard = guard or PreemptionGuard()
        # SIGTERM mid-persist: flip the manager's fast-flush flag from the
        # signal handler so the in-flight overlapped round skips
        # non-essential maintenance and lands promptly
        guard.add_callback(self.manager.request_fast_flush)
        status = "completed"
        steps_done = 0
        if own_guard:
            guard.__enter__()
        try:
            while self.py_step < n_steps:
                if guard.should_preempt:
                    self.manager.wait()
                    rep = self.save(blocking=True)
                    # the preemption checkpoint must be FULLY durable —
                    # including its slow-tier copy — before the process
                    # answers the eviction: the burst buffer may not
                    # survive the node reassignment
                    self.manager.store.wait_drained()
                    log.info("preempted at step %d; checkpoint %.3fs",
                             self.py_step, rep["seconds"])
                    status = "preempted"
                    break
                if self._pending_batch is not None:
                    # step-0 input staged while the restore tail streamed
                    batch, next_ds = self._pending_batch
                    self._pending_batch = None
                else:
                    batch, next_ds = self.pipeline.next(self.data_state)
                t0 = time.monotonic()
                self.state, metrics = self.step_fn(self.state, batch)
                self.data_state = next_ds
                self.py_step += 1
                steps_done += 1
                if self.py_step % self.tcfg.log_every == 0 or \
                        self.py_step == n_steps:
                    # reading the metrics waits for the step to finish
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=self.py_step,
                             step_s=time.monotonic() - t0)
                    self.history.append(m)
                    log.info("step %5d loss=%.4f (%.2fs)", self.py_step,
                             m.get("loss", float("nan")), m["step_s"])
                if self.tcfg.ckpt_every and \
                        self.py_step % self.tcfg.ckpt_every == 0:
                    rep = self.save(blocking=not self.tcfg.async_ckpt)
                    if rep.get("async"):
                        # the train thread paid only the snapshot barrier;
                        # persist overlaps the steps that follow
                        log.info("ckpt step %d: blocked %.3fs "
                                 "(snapshot %.3fs), persist overlapped",
                                 self.py_step, rep["blocking_s"],
                                 rep["snapshot_s"])
                if stop_after is not None and steps_done >= stop_after:
                    status = "paused"
                    break
            self.manager.wait()
            if status == "completed" and (
                    not self.manager.latest_step()
                    or self.manager.latest_step() < self.py_step):
                self.save(blocking=True)
        finally:
            if own_guard:
                guard.__exit__(None, None, None)
        return {"status": status, "step": self.py_step,
                "history": self.history,
                "ckpt_metrics": dict(self.manager.coordinator.metrics)}

    def params_digest(self) -> str:
        """Bit-exactness probe: order-stable sha256 over the ``/``-joined
        leaf names and raw bytes of all params (bf16 as its 2-byte
        patterns, so the JAX package's digest of the same values is the
        same); a ``DTensor`` leaf is gathered to its full tensor first, so
        the digest is the same on every mesh."""
        if self._restore_stream is not None:
            self._finish_streaming_restore()
        h = hashlib.sha256()
        for name, leaf in leaf_paths(self.state["params"]):
            if hasattr(leaf, "full_tensor"):
                leaf = leaf.full_tensor()
            h.update(name.encode())
            h.update(to_host(leaf).tobytes())
        return h.hexdigest()

