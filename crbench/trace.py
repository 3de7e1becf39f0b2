"""The traced run's instruments: the device trace of the window
(``torch.profiler``, device activity only) and a sampler of the host's
Python stacks, which names what the host was doing in each idle gap.

The sampler is a copy of ``chip_smoke.py``'s ``StackSampler`` that keeps
each sample's time: a daemon thread reads every other thread's stack each
10 ms."""
from __future__ import annotations

import bisect
import collections
import sys
import threading
import time
from pathlib import Path

from . import yardstick as Y

class StackSampler:
    def __init__(self, period: float = 0.01, depth: int = 3):
        self.period, self.depth = period, depth
        self.main = threading.main_thread().ident
        self.samples = []           # (host ns, main thread's innermost frames)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _frames(self, frame) -> str:
        key = []
        while frame is not None and len(key) < self.depth:
            key.append(f"{Path(frame.f_code.co_filename).name}:"
                       f"{frame.f_lineno}:{frame.f_code.co_name}")
            frame = frame.f_back
        return " < ".join(key)

    def _run(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.main)
            if frame is not None:
                self.samples.append((time.time_ns(), self._frames(frame)))

    def stop(self):
        self._stop.set()
        self._thread.join()

    def label(self, lo_ns: float, hi_ns: float) -> str:
        """The main thread's most frequent stack in [lo, hi), or in a gap
        shorter than a period, its sample nearest to the gap."""
        if not self.samples:
            return "no host sample"
        times = self._times()
        a, b = bisect.bisect_left(times, lo_ns), bisect.bisect_left(times,
                                                                     hi_ns)
        if b > a:
            c = collections.Counter(k for _, k in self.samples[a:b])
            return c.most_common(1)[0][0]
        near = [i for i in (a - 1, a) if 0 <= i < len(times)]
        mid = (lo_ns + hi_ns) / 2
        return self.samples[min(near, key=lambda i: abs(times[i] - mid))][1]

    def _times(self):
        if len(getattr(self, "_t", ())) != len(self.samples):
            self._t = [t for t, _ in self.samples]
        return self._t


class DeviceTrace:
    """Profile the device from ``start`` to ``stop``. ``start`` waits for
    the device and launches one marker kernel, whose start in the trace
    maps the host clock (``time.time_ns``) onto the trace's."""

    def __init__(self, device):
        self.device = device

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.host0 = time.time_ns()
        torch.cuda._sleep(1000)
        self.sampler = StackSampler()

    def stop(self):
        import torch
        torch.cuda.synchronize(self.device)
        self.host1 = time.time_ns()
        self.sampler.stop()
        self.prof.__exit__(None, None, None)
        self.events = []            # (name, start ns, end ns)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                self.events.append((e.name(), e.start_ns(), e.end_ns()))
        self.events.sort(key=lambda e: e[1])
        # the marker is the first device activity after the host's stamp
        shift = self.events[0][1] - self.host0 if self.events else 0
        self.lo, self.hi = self.host0 + shift, self.host1 + shift
        self.shift = shift
        del self.prof

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return Y.busy([[a, b] for _, a, b in self.events], self.lo,
                      self.hi) / 1e9

    def kernel_times(self) -> dict:
        """{K number: [seconds of each launch]} of the hand-written
        kernels."""
        out = collections.defaultdict(list)
        for name, a, b in self.events:
            k = Y.kernel_of(name)
            if k:
                out[k].append((b - a) / 1e9)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host's main thread was doing (its gaps summed by
        label)."""
        ops = collections.Counter()
        for name, a, b in self.events:
            ops[name[:120]] += (b - a) / 1e9
        idle = collections.Counter()
        for a, b in Y.gaps([[a, b] for _, a, b in self.events], self.lo,
                           self.hi):
            idle[self.sampler.label(a - self.shift, b - self.shift)] += \
                (b - a) / 1e9
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}
