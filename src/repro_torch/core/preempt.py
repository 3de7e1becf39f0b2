"""Preemption handling (``src/repro/core/preempt.py``, framework-free and
copied as it is) — the paper's scheduling-flexibility use case:

  "making space for high-priority, real-time workloads by preempting
   low-priority jobs" — i.e. SIGTERM arrives, the job checkpoints at the
   next step boundary and exits cleanly; the scheduler later restarts it
   and it resumes bit-exactly.
"""
from __future__ import annotations

import signal
import threading
import time

from .errors import warn


class PreemptionGuard:
    """Installs handlers for `signals`; the training loop polls
    ``should_preempt`` at step boundaries (checkpointing mid-step is exactly
    the in-transit-message hazard the drain protocol exists to avoid).

    Every received signal is recorded (``signums``), not just the last.
    OS-delivered signals are DEFERRED, not swallowed: on ``__exit__`` each
    one is re-delivered to the restored handler, so an outer SIGTERM
    handler (or the default action — process exit, which is what a
    preempted job owes its scheduler) still observes the signal once the
    guarded region has checkpointed. ``request()`` (programmatic
    preemption) sets the flag without scheduling any re-delivery.

    ``add_callback`` registers signal-handler-safe hooks that run on every
    preemption signal — the checkpoint manager uses one to fast-flush an
    in-flight overlapped persist.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self.signals = signals
        self._flag = threading.Event()
        self._old = {}
        self.received_at: float | None = None
        self.signum: int | None = None          # most recent
        self.signums: list = []                 # every one, in order
        self._deferred: list = []               # OS-delivered only
        self._callbacks: list = []

    def add_callback(self, fn):
        """Run `fn()` on every preemption signal. Must be signal-safe
        (set an event, flip a flag); exceptions are logged, not raised —
        a broken hook must not lose the signal itself. Re-registering an
        equal callable is a no-op (a trainer re-entering fit() with the
        same guard must not stack duplicates)."""
        if fn not in self._callbacks:
            self._callbacks.append(fn)

    def _record(self, signum):
        self.signum = signum
        self.signums.append(signum)
        self.received_at = time.time()
        self._flag.set()
        for fn in self._callbacks:
            try:
                fn()
            except Exception as e:  # noqa — see add_callback
                warn("CKPT_W_PREEMPT_HOOK", "preemption callback failed",
                     error=f"{type(e).__name__}: {e}")

    def _handler(self, signum, frame):
        self._deferred.append(signum)
        self._record(signum)

    def __enter__(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old.clear()
        # re-deliver what the guard intercepted: the outer handler (or the
        # default action) must still see the preemption — before this, a
        # SIGTERM caught inside the guard simply vanished and the process
        # out-lived its eviction notice
        deferred, self._deferred = self._deferred, []
        for s in dict.fromkeys(deferred):
            signal.raise_signal(s)
        return False

    @property
    def should_preempt(self) -> bool:
        return self._flag.is_set()

    def request(self):
        """Programmatic preemption (tests / preempt-queue simulation) —
        sets the flag and runs callbacks, but schedules no re-delivery
        (there is no real OS signal to hand back)."""
        self._record(signal.SIGUSR1)


class PreemptQueue:
    """Tiny priority-scheduler simulation for examples: high-priority
    arrivals preempt the running low-priority job via its guard."""

    def __init__(self):
        self.events = []

    def submit_high_priority(self, guard: PreemptionGuard, job: str):
        self.events.append(("preempt", job, time.time()))
        guard.request()
