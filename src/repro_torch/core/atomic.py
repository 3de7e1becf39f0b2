"""Atomic commit primitives (paper Lesson 3: CHANGES_PENDING fields acting as
locks, even for single-threaded code) and crash-consistent directory commit.

Protocol:
  * all writes land in ``<root>/step_<N>.tmp-<nonce>/`` (staging);
  * a ``_META/PENDING`` marker exists while any mutation is in flight;
  * commit = write manifest → fsync → remove PENDING → rename staging dir to
    ``<root>/step_<N>`` (atomic on POSIX) → rewrite LATEST pointer atomically.

A crash at ANY point leaves either the previous committed checkpoint intact
(staging dirs are ignored/garbage-collected) or the new one fully committed.
Property-tested with injected crashes at every protocol step.
"""
from __future__ import annotations

import json
import os
import secrets
from pathlib import Path

from .errors import StaleStateError

PENDING = "_META/PENDING"
MANIFEST = "_META/manifest.json"
LATEST = "LATEST"


class CrashPoint(Exception):
    """Raised by tests to simulate a crash at a protocol step."""


class CrashInjector:
    def __init__(self, crash_at: str | None = None):
        self.crash_at = crash_at

    def maybe(self, point: str):
        if self.crash_at == point:
            raise CrashPoint(point)


NO_CRASH = CrashInjector()


def fsync_file(path: Path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: Path):
    fd = os.open(path, os.O_RDONLY | os.O_DIRECTORY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: Path, data: bytes, crash: CrashInjector = NO_CRASH):
    tmp = path.with_name(path.name + f".tmp-{secrets.token_hex(4)}")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    crash.maybe("after_tmp_write")
    os.rename(tmp, path)
    crash.maybe("after_rename")
    fsync_dir(path.parent)


def staging_dir(root: Path, step: int) -> Path:
    return root / f"step_{step:08d}.tmp-{secrets.token_hex(4)}"


def committed_dir(root: Path, step: int) -> Path:
    return root / f"step_{step:08d}"


def mark_pending(stage: Path, payload: dict):
    p = stage / PENDING
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload))
    fsync_file(p)


def clear_pending(stage: Path):
    p = stage / PENDING
    if p.exists():
        p.unlink()
        fsync_dir(p.parent)


def assert_not_pending(d: Path):
    if (d / PENDING).exists():
        raise StaleStateError("checkpoint directory has a PENDING marker",
                              path=str(d))


def commit_dir(stage: Path, final: Path, crash: CrashInjector = NO_CRASH):
    """Atomic promotion of a fully-written staging dir."""
    assert (stage / MANIFEST).exists(), "commit without manifest"
    assert_not_pending(stage)
    crash.maybe("before_commit_rename")
    if final.exists():
        raise FileExistsError(final)
    os.rename(stage, final)
    crash.maybe("after_commit_rename")
    fsync_dir(final.parent)


def write_latest(root: Path, step: int, crash: CrashInjector = NO_CRASH):
    atomic_write_bytes(root / LATEST, str(step).encode(), crash)


def read_latest(root: Path):
    p = root / LATEST
    if not p.exists():
        return None
    try:
        return int(p.read_text().strip())
    except ValueError:
        return None


def list_committed_steps(root: Path) -> list:
    out = []
    if not root.exists():
        return out
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_") and ".tmp-" not in d.name \
                and (d / MANIFEST).exists() and not (d / PENDING).exists():
            try:
                out.append(int(d.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def gc_staging(root: Path):
    """Remove orphaned staging dirs (crash leftovers)."""
    import shutil
    n = 0
    if not root.exists():
        return 0
    for d in root.iterdir():
        if d.is_dir() and ".tmp-" in d.name:
            shutil.rmtree(d, ignore_errors=True)
            n += 1
    return n
