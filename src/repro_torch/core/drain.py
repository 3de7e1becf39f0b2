"""Quiescence / drain protocol — the paper's in-transit message discipline.

MANA: "to ensure that no in-transit MPI messages are lost due to
checkpointing, we delayed the final checkpoint until the count of total
bytes sent and received was equal."

PyTorch analogue, one level up the stack:
  1. device quiescence — synchronise the CUDA stream that wrote the state:
     no in-flight kernel may straddle the snapshot;
  2. writer quiescence — the async checkpoint writer tracks
     (enqueued_bytes, committed_bytes); the next snapshot (and shutdown)
     wait until the two counters are EQUAL — the same two-counter equality.
"""
from __future__ import annotations

import threading
import time


class DrainCounters:
    """Thread-safe sent/received byte accounting (paper's equality test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.enqueued_bytes = 0
        self.committed_bytes = 0
        self.enqueued_items = 0
        self.committed_items = 0

    def enqueue(self, nbytes: int):
        with self._cv:
            self.enqueued_bytes += nbytes
            self.enqueued_items += 1

    def commit(self, nbytes: int):
        with self._cv:
            self.committed_bytes += nbytes
            self.committed_items += 1
            self._cv.notify_all()

    def drained(self) -> bool:
        with self._lock:
            return (self.enqueued_bytes == self.committed_bytes
                    and self.enqueued_items == self.committed_items)

    def wait(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not (self.enqueued_bytes == self.committed_bytes
                       and self.enqueued_items == self.committed_items):
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enqueued_bytes": self.enqueued_bytes,
                "committed_bytes": self.committed_bytes,
                "enqueued_items": self.enqueued_items,
                "committed_items": self.committed_items,
            }


def quiesce_device_state(state) -> float:
    """Block until no kernel writing `state` is in flight: synchronise the
    current stream of every CUDA device a leaf lives on (the stream the
    training step wrote it from). Returns the wait time (a reliability
    metric the trainer logs)."""
    import torch

    from .split_state import leaf_paths
    t0 = time.monotonic()
    devices = {leaf.device for _, leaf in leaf_paths(state)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return time.monotonic() - t0
