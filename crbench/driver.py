"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the record the metric readers read.

Set-up builds one ``Trainer`` (the program's training entry), hands it the
benchmark's weights and its seeded batches (through its ``pipeline``),
drives the first steps through ``Trainer.fit`` (the window's own call),
warms what the window uses, and sizes the window from the warm-up's step
time. The traffic mix's ``kind`` picks how the window drives the program:

* ``interval``: ``Trainer.fit`` over the window's steps, the Trainer
  saving (its own ``save``, asynchronously) at the steps where each
  ``1/(saves + 1)`` of the window has passed, as an interval timer would
  call it; the window ends when the last round has landed;
* ``recover``: cycles of a job restarting from the checkpoint that set-up
  wrote: a fresh ``Trainer`` on the same store, ``init_or_restore``, a
  fixed number of steps, and the state dropped.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from . import inputs
from .reference import compare, ckpt_reader
from .reference import train as ref_train

BIG = 1 << 60
DIGEST_WORDS = 1 << 22


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    cfg: dict
    batch: int
    seq: int
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    saves: list = dataclasses.field(default_factory=list)    # save calls
    rounds: list = dataclasses.field(default_factory=list)   # landed rounds
    save_call_s: float = 0.0
    wait_s: float = 0.0          # waits for rounds outside save calls
    restores: list = dataclasses.field(default_factory=list)
    leaves: list = dataclasses.field(default_factory=list)   # (name, bytes)
    trace: object = None

    @property
    def tokens(self) -> int:
        return self.steps * self.batch * self.seq

    def step_s(self) -> float:
        """Window time outside checkpoint and restart calls, a step."""
        other = self.save_call_s + self.wait_s + \
            sum(r["restart_s"] for r in self.restores)
        return (self.window_s - other) / max(self.steps, 1)


class Pipeline:
    """The Trainer's data seam: batch ``step`` of data stream ``seed``
    (``inputs.batch``), made on the device. ``asked`` keeps the data
    states the program handed it."""

    def __init__(self, cfg: dict, device):
        from repro_torch.data.pipeline import DataState
        self.cfg, self.device, self.DataState = cfg, device, DataState
        self.asked = []

    def init_state(self, seed=0):
        return self.DataState(seed=int(seed), step=0, source_counts=())

    def next(self, state):
        self.asked.append((state.seed, state.step))
        return (inputs.batch(self.cfg, state.seed, state.step, self.device),
                self.DataState(state.seed, state.step + 1, ()))


def port_config(cj: dict):
    """The program's model configuration with the sizes of the
    configuration's file; every size the file states must be what the
    program runs."""
    from repro_torch.configs import get_config
    base = get_config(cj["port_arch"])
    names = {f.name for f in dataclasses.fields(base)} - {"arch_id",
                                                          "source", "ssm"}
    kw = {k: v for k, v in cj.items() if k in names}
    cfg = dataclasses.replace(base, **kw)
    if "ssm" in cj:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            base.ssm, **cj["ssm"]))
    for k in [*kw, *(["ssm"] if "ssm" in cj else [])]:
        got, v = getattr(cfg, k), cj[k]
        if k == "ssm":
            got = dataclasses.asdict(got)
        if got != v:
            raise ValueError(f"{cj['name']}: {k} runs as {got!r}, not {v!r}")
    return cfg


def check_recipe(trainer, cj: dict):
    r, opt = cj["recipe"], trainer.optimizer
    have = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps,
            "weight_decay": opt.weight_decay, "clip_norm": opt.clip_norm}
    for k, v in have.items():
        if v != r[k]:
            raise ValueError(f"the program's AdamW has {k}={v}, the "
                             f"configuration's recipe {r[k]}")


def leaf_dict(tree) -> dict:
    from repro_torch.core.split_state import leaf_paths
    return dict(leaf_paths(tree))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, bench, workload: str, seed: int, seconds: float,
                 device, traced: bool = False, t_start=None):
        self.bench, self.seed, self.seconds = bench, int(seed), seconds
        self.device, self.traced = torch.device(device), traced
        self.t_start = time.monotonic() if t_start is None else t_start
        self.w = bench.workload(workload)
        self.cj = bench.config(self.w["config"])
        self.tj = bench.traffic(self.w["traffic"])
        self.model = bench.reference(self.cj["reference"])
        tr = self.cj["train"]
        self.rec = Record(self.cj, tr["batch"], tr["seq_len"])
        self.cfg = port_config(self.cj)
        self.tmp = Path(tempfile.mkdtemp(prefix="crbench-",
                                         dir=os.environ.get("TMPDIR")))
        self.workdir = self.tmp / "store"
        self.checks = {}
        self.diag = {}      # what the run printed beside its result
        self.digest = Digest(self.device, self.seed)

    # ------------------------------------------------------------------
    def trainer(self):
        from repro_torch.core.storage import Tier, TieredStore
        from repro_torch.train.loop import Trainer, TrainerConfig
        pol = self.tj["policy"]
        tcfg = TrainerConfig(workdir=str(self.workdir),
                             batch=self.rec.batch, seq_len=self.rec.seq,
                             seed=self.seed, ckpt_every=0,
                             burst_buffer=False, **pol)
        t = Trainer(self.cfg, tcfg, store=TieredStore(
            Tier("fast", self.workdir)), device=self.device)
        t.pipeline = Pipeline(self.cj, self.device)
        return t

    def start(self):
        """A Trainer with a fresh state whose parameters are the
        benchmark's weights of this seed (kept as ``w0``)."""
        spec = self.model.param_specs(self.cj)
        self.w0 = inputs.weights(spec, self.seed, self.device)
        t = self.trainer()
        check_recipe(t, self.cj)
        t.init_or_restore()
        params = leaf_dict(t.state["params"])
        if {n: tuple(p.shape) for n, p in params.items()} != \
                {n: tuple(s[0]) for n, s in spec.items()}:
            raise ValueError("the program's parameters are not the "
                             "configuration's leaves")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.w0[n])
        return t

    def setup(self):
        from repro_torch.kernels import build
        if self.device.type == "cuda":
            build.build_all()
        t = self.start()
        self.rec.leaves = [(n, x.nbytes) for n, x in
                           leaf_dict(t.state).items()]
        self.digest(leaf_dict(t.state))     # its kernels' first launches
        self.prog = self.first_steps(t)
        warm = self.tj.get("warmup_steps", 3)
        t.fit(BIG, stop_after=1)
        sync(self.device)
        t0 = time.monotonic()
        t.fit(BIG, stop_after=warm)
        sync(self.device)
        self.step_s = (time.monotonic() - t0) / warm
        getattr(self, f"setup_{self.tj['kind']}")(t)
        sync(self.device)
        self.rec.setup_s = time.monotonic() - self.t_start
        self.diag.update(warm_step_s=self.step_s,
                         window_steps=getattr(self, "n_steps", None),
                         cycles=getattr(self, "n_cycles", None))

    def first_steps(self, t) -> dict:
        """Steps 1–3 through ``Trainer.fit``: each step's loss, each leaf's
        norm of the first gradient as AdamW received it (its first moment
        over 1 − b1 after one step) and of its change over the three."""
        b1, every = t.optimizer.b1, t.tcfg.log_every
        t.tcfg.log_every = 1
        out = {"loss": []}
        for i in range(3):
            t.fit(BIG, stop_after=1)
            out["loss"].append(t.history[-1]["loss"])
            if i == 0:
                out["grad"] = {n: float(m.norm()) / (1 - b1) for n, m in
                               leaf_dict(t.state["opt"]["m"]).items()}
        out["change"] = {n: float((p.float() - self.w0[n].float()).norm())
                         for n, p in leaf_dict(t.state["params"]).items()}
        t.tcfg.log_every = every
        return out

    # ---- interval: saves inside fit ---------------------------------
    def setup_interval(self, t):
        """Warm the save path on a small state in a scratch store (the
        kernels' first launches, the staging arena), then fix the window's
        steps and the steps at which the Trainer saves."""
        from repro_torch.core.checkpoint import CheckpointManager
        from repro_torch.core.storage import Tier, TieredStore
        g = inputs.generator(self.device, self.seed, "warm")
        small = {"opt": {"m": torch.randn(3 << 18, generator=g,
                                          device=self.device)},
                 "params": {"w": torch.randn(3 << 19, generator=g,
                                             device=self.device)
                            .to(torch.bfloat16)}}
        warm = CheckpointManager(TieredStore(Tier("fast", self.tmp / "warm")),
                                 policy=t.manager.policy, device=self.device)
        warm.save(small, 0, blocking=True)
        warm.close()
        shutil.rmtree(self.tmp / "warm", ignore_errors=True)
        n = max(3, round(self.seconds / self.step_s))
        k = self.tj["saves"]
        first = t.py_step
        self.n_steps = n
        self.save_at = {first + round(n * i / (k + 1)) for i in range(1, k + 1)}
        self.t = t

    def window_interval(self):
        t, rec = self.t, self.rec
        t.tcfg.ckpt_every = 1
        orig_save, orig_wait = t.save, t.manager.wait
        state = {"in_save": False}
        last = max(self.save_at)

        def wait():
            a = time.monotonic()
            orig_wait()
            if not state["in_save"]:
                rec.wait_s += time.monotonic() - a
            rep = t.manager.last_report
            if rep and "seconds" in rep and \
                    rep["step"] not in {r["step"] for r in rec.rounds}:
                rec.rounds.append(dict(rep))

        def save(blocking=True):
            if t.py_step not in self.save_at:
                return {}
            state["in_save"] = True
            a = time.monotonic()
            if t.py_step == last:
                # what the plain reader must find after the window
                self.saved = (t.py_step, self.digest(leaf_dict(t.state)))
            rep = orig_save(blocking=blocking)
            rec.save_call_s += time.monotonic() - a
            state["in_save"] = False
            rec.saves.append(dict(rep))
            return rep

        t.save, t.manager.wait = save, wait
        t.fit(BIG, stop_after=self.n_steps)
        rec.steps = self.n_steps

    def finish_interval(self):
        self.t.manager.close()
        self.t.state = None
        del self.t

    def check_interval(self):
        step, saved = self.saved
        self.checks["save_mismatch"] = (self.read_back(step, saved), 0)

    # ---- recover: restart cycles ------------------------------------
    def setup_recover(self, t):
        """The job's last checkpoint (a blocking save) and its digest, then
        one warm restart, which also sizes the window's cycles."""
        rep = t.save(blocking=True)
        self.saved = (t.py_step, self.digest(leaf_dict(t.state)))
        self.rec.rounds.append(dict(rep))
        t.manager.close()
        t.state = None
        del t
        self.cycle_steps = self.tj["cycle_steps"]
        self.mismatch, self.resumed, self.digest_s = [], [], 0.0
        a = time.monotonic()
        self.cycle(warm=True)
        est = time.monotonic() - a + (self.cycle_steps - 1) * self.step_s
        self.n_cycles = max(1, round(self.seconds / est))

    def cycle(self, warm: bool = False):
        rec = self.rec
        a = time.monotonic()
        t = self.trainer()
        t.init_or_restore()
        restored = time.monotonic()
        if not warm:
            # the restored state's digest, launched on the card (the step
            # updates the state in place); compared once the window has
            # closed
            self.mismatch.append(self.digest(leaf_dict(t.state)))
            self.digest_s += time.monotonic() - restored
        inner, first = t.step_fn, {}

        def step(state, batch):
            out = inner(state, batch)
            if not first:
                sync(self.device)
                first["end"] = time.monotonic()
            return out

        t.step_fn = step
        t.fit(BIG, stop_after=1 if warm else self.cycle_steps)
        b = time.monotonic()
        t.manager.close()
        asked = t.pipeline.asked[0]
        t.state = None
        del t
        if warm:
            return
        c = time.monotonic()
        rec.steps += self.cycle_steps
        rec.restores.append({"restore_s": restored - a,
                             "resume_s": first["end"] - a,
                             "restart_s": (restored - a) + (c - b)})
        self.resumed.append(asked)

    def window_recover(self):
        for _ in range(self.n_cycles):
            self.cycle()

    def finish_recover(self):
        self.diag["digest_s"] = self.digest_s

    def check_recover(self):
        step, saved = self.saved
        self.checks["save_mismatch"] = (self.read_back(step, saved), 0)
        self.checks["restore_mismatch"] = (
            sum(Digest.differ(saved, d) for d in self.mismatch), 0)
        ds = ckpt_reader.manifest(
            self.workdir, step)["extra"]["data_state"]
        self.checks["resume_data_mismatch"] = (
            sum(a != (ds["seed"], ds["step"]) for a in self.resumed), 0)

    def read_back(self, step: int, saved: dict) -> int:
        """Leaves whose bits in the latest round, decoded by the plain
        reader, differ from the digest `saved` of the state saved at
        `step`; the whole state where the round is of another step."""
        got, _, leaves = ckpt_reader.read_leaves(self.workdir)
        if got != step:
            return len(saved)
        return Digest.differ(saved, self.digest(
            {n: torch.from_numpy(_signed(a)).to(self.device)
             for n, a in leaves.items()}))

    # ------------------------------------------------------------------
    def window(self):
        getattr(self, f"window_{self.tj['kind']}")()

    def measure(self):
        """The window, traced where asked; ends when its last work has."""
        tr = None
        if self.traced:
            from .trace import DeviceTrace
            tr = DeviceTrace(self.device)
            tr.start()
        sync(self.device)
        a = time.monotonic()
        self.window()
        sync(self.device)
        self.rec.window_s = time.monotonic() - a
        if tr is not None:
            tr.stop()
            self.rec.trace = tr
        getattr(self, f"finish_{self.tj['kind']}")()
        r = self.rec
        keep = ("step", "seconds", "blocking_s", "snapshot_s", "bytes",
                "written_bytes")
        self.diag.update(
            window_s=r.window_s, steps=r.steps, step_s=r.step_s(),
            save_call_s=r.save_call_s, wait_s=r.wait_s,
            saves=[{k: s.get(k) for k in keep} for s in r.saves],
            rounds=[{k: s.get(k) for k in keep} for s in r.rounds],
            restores=r.restores)

    def check(self) -> dict:
        """Every compared number with its limit, once the window has
        closed and the program's state is freed."""
        lim = self.bench.limits(self.w["config"])
        getattr(self, f"check_{self.tj['kind']}")()
        batches = [inputs.batch(self.cj, self.seed, i, self.device)
                   for i in range(3)]
        ref = ref_train.train(self.model, self.cj, self.w0, batches)
        for k, v in compare.gaps(self.prog, ref).items():
            self.checks[k] = (v, lim[k]["limit"])
        return self.checks

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _int(x):
    return INT[x.element_size()]


def _signed(a):
    """A NumPy array's bits as the integers `_int` views a tensor's."""
    import numpy as np
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32,
                   8: np.int64}[a.itemsize])


class Digest:
    """64-bit digests of a state's leaves, computed on the card: a leaf's
    bits, viewed as integers, times fixed random weights of the run's
    seed, summed with wrap-around over blocks of ``DIGEST_WORDS``, each
    block's sum times an odd number of its own. Two leaves whose bits
    differ anywhere, or lie in another order, share a digest with a chance
    of about 2⁻⁶²; a leaf that one side lacks counts as differing."""

    def __init__(self, device, seed: int):
        g = inputs.generator(device, seed, "digest")
        self.w = torch.randint(1, 1 << 62, (DIGEST_WORDS,), generator=g,
                               device=device, dtype=torch.int64)

    def __call__(self, leaves: dict) -> dict:
        """{name: 0-d int64 tensor on the card}; launched, not read."""
        out = {}
        for n, x in leaves.items():
            v = x.detach().contiguous().view(-1).view(_int(x))
            parts = [torch.mul(v[i:i + DIGEST_WORDS],
                               self.w[:min(DIGEST_WORDS, v.numel() - i)])
                     .sum() for i in range(0, v.numel(), DIGEST_WORDS)]
            if len(parts) <= 1:
                out[n] = parts[0] if parts else self.w[:0].sum()
            else:
                odd = torch.arange(1, 2 * len(parts), 2, device=v.device)
                out[n] = (torch.stack(parts) * odd).sum()
        return out

    @staticmethod
    def differ(a: dict, b: dict) -> int:
        both = sorted(set(a) & set(b))
        bad = len(set(a) ^ set(b))
        if both:
            bad += int((torch.stack([a[n] for n in both])
                        != torch.stack([b[n] for n in both])).sum())
        return bad
