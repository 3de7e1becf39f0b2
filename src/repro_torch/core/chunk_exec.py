"""Bounded chunk-IO executor — the pipelining engine under the CAS hot path.

The original data path was strictly serial: each writer rank hashed and wrote
its chunks one at a time with a directory fsync per object, and restore
reassembled payloads chunk by chunk. On the storage hierarchies this system
targets (burst buffer + parallel filesystem) every one of those stages —
blake2b hashing, file writes, fsync, reads — releases the GIL or waits on
the kernel, so a small thread pool pipelines them almost for free.

``ChunkIOExecutor`` is deliberately tiny and deliberately *not* a bare
``ThreadPoolExecutor``:

  * ``map_ordered`` keeps a bounded in-flight window, so reassembling a
    multi-GiB payload never materialises every chunk's future (or buffer)
    at once — it is a prefetch pipeline, not a scatter-gather;
  * results are delivered **in item order** with an optional per-result
    callback, which is how writer ranks keep their coordinator keepalive
    heartbeat alive through a long batch;
  * an error (including an injected ``CrashPoint``) cancels the queue and
    **joins every in-flight call before re-raising** — no stray worker may
    still be writing objects while the caller's abort/GC path runs, or the
    crash matrix's post-crash fsck would race its own litter;
  * ``threads <= 1`` is a true serial mode that runs inline on the caller's
    thread — byte-for-byte the original serial behaviour, used as the benchmark
    baseline and available for debugging.

The pool is created lazily (a restore-only process that never touches a
chunked checkpoint spawns no threads) and torn down via ``shutdown()``.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import (Future, ThreadPoolExecutor,
                                wait as futures_wait)

DEFAULT_IO_THREADS = 4


def cpu_cap() -> int:
    """Parallelism cap for CPU/bandwidth-bound stages (hash, crc, memcpy,
    cached reads): more threads than cores only adds contention there.
    Latency-bound stages (fsync, cold reads) are the ones that want the
    full io_threads width."""
    return max(os.cpu_count() or 2, 2)


class ChunkIOExecutor:
    def __init__(self, threads: int = DEFAULT_IO_THREADS):
        self.threads = max(int(threads), 1)
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    @property
    def serial(self) -> bool:
        return self.threads <= 1

    # ------------------------------------------------------------------
    def _get_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.threads,
                    thread_name_prefix="chunk-io")
            return self._pool

    def map_ordered(self, fn, items, *, window: int | None = None,
                    on_result=None) -> list:
        """Apply ``fn`` to every item, returning results in item order.

        At most ``window`` calls are in flight (default ``2 × threads``).
        ``on_result`` is invoked on the caller's thread after each result is
        consumed, in order. On any exception — from ``fn`` or from
        ``on_result`` — pending calls are cancelled, in-flight calls are
        joined, and the first error re-raises: when this method exits, no
        submitted work is still running.
        """
        items = list(items)
        if self.serial or len(items) <= 1:
            out = []
            for it in items:
                out.append(fn(it))
                if on_result is not None:
                    on_result(out[-1])
            return out
        window = max(int(window or 2 * self.threads), 1)
        pool = self._get_pool()
        pending: deque = deque()
        out: list = []
        i = 0
        try:
            while i < len(items) or pending:
                while i < len(items) and len(pending) < window:
                    pending.append(pool.submit(fn, items[i]))
                    i += 1
                f = pending.popleft()
                out.append(f.result())
                if on_result is not None:
                    on_result(out[-1])
        except BaseException:
            for f in pending:
                f.cancel()
            futures_wait(list(pending))
            raise
        return out

    def submit(self, fn, *args) -> Future:
        """Raw pool submission for streaming callers (``save_path.
        SaveSession``) that manage their own in-flight window and
        consumption order. A serial executor runs the call inline and
        returns an already-resolved future, so callers need no branch."""
        if self.serial:
            f: Future = Future()
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # noqa — future carries it
                f.set_exception(e)
            return f
        return self._get_pool().submit(fn, *args)

    def shutdown(self, wait: bool = True):
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
