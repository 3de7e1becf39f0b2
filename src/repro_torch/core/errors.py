"""Structured, coded errors & warnings (paper Lesson 4: "better attention to
warnings and error messages from the beginning").

Every failure mode observed in the paper's production hardening has a code
here; tests assert on codes, not message text.
"""
from __future__ import annotations

import logging

log = logging.getLogger("repro.ckpt")


class CkptError(RuntimeError):
    code = "CKPT_E_GENERIC"

    def __init__(self, msg, **ctx):
        self.ctx = ctx
        super().__init__(f"[{self.code}] {msg}"
                         + (f" | {ctx}" if ctx else ""))


class SpaceError(CkptError):
    """Insufficient storage for the checkpoint image (paper: 'Applications
    with a large memory footprint may fail to checkpoint if there is
    insufficient storage space; a system warning is needed')."""
    code = "CKPT_E_SPACE"


class CorruptShardError(CkptError):
    """Checksum mismatch / unreadable shard payload."""
    code = "CKPT_E_CORRUPT"


class MissingShardError(CkptError):
    """Manifest references a shard file that does not exist on any tier or
    buddy replica."""
    code = "CKPT_E_MISSING"


class AbortedError(CkptError):
    """2-phase commit aborted (rank failure / keepalive timeout)."""
    code = "CKPT_E_ABORTED"


class NamespaceError(CkptError):
    """Upper-half leaf name collides with reserved lower-half namespace
    (the fd-conflict analogue)."""
    code = "CKPT_E_NAMESPACE"


class RegistryMismatchError(CkptError):
    """State-region table validation failed (Lesson 1 runtime checks)."""
    code = "CKPT_E_REGISTRY"


class NoCheckpointError(CkptError):
    code = "CKPT_E_NOCKPT"


class CodecUnavailableError(CkptError):
    """Requested codec needs an optional dependency that is not installed
    (e.g. codec='zstd' without the `zstandard` package — declared under the
    `compress` extra)."""
    code = "CKPT_E_CODEC"


class CASError(CkptError):
    """Content-addressed store invariant violation (digest mismatch,
    refcount drift, orphaned or missing chunk objects)."""
    code = "CKPT_E_CAS"


class StaleStateError(CkptError):
    """CHANGES_PENDING marker found — structure was mid-mutation (Lesson 3)."""
    code = "CKPT_E_PENDING"


def warn(code: str, msg: str, **ctx):
    log.warning("[%s] %s | %s", code, msg, ctx)
