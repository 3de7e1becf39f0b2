"""Reserved-namespace registry — the file-descriptor-conflict analogue.

In MANA, the upper half could open an fd before checkpoint that the lower
half later claimed on restart; the fix was tagging and reserving descriptor
ranges per half. Here, checkpoint-internal artifacts (manifests, staging
dirs, pointers, replica suffixes) live under reserved prefixes, and
upper-half leaf names are validated against them — a collision is a hard
error before any byte is written, not a corrupt restore later.
"""
from __future__ import annotations

import re

from .errors import NamespaceError

# lower-half reserved names (checkpoint machinery)
RESERVED_PREFIXES = ("_META", ".tmp-", "LATEST", "_AOT_CACHE", "_DRAIN",
                     "_CAS")
REPLICA_SUFFIX = ".r1"
UPPER_DIR = "upper"

_SAFE = re.compile(r"[^A-Za-z0-9_.\-]")


def leaf_to_fname(leaf_path: str) -> str:
    """Map a pytree leaf path ('params/stage_0/b1/wg') to a flat, safe file
    stem. '/' → '__' keeps paths shallow (srun-arg-limit lesson: workers read
    the manifest, never a file list)."""
    check_leaf_name(leaf_path)
    return _SAFE.sub("_", leaf_path.replace("/", "__"))


def check_leaf_name(leaf_path: str):
    head = leaf_path.split("/", 1)[0]
    for pfx in RESERVED_PREFIXES:
        if head.startswith(pfx):
            raise NamespaceError(
                "upper-half leaf name collides with reserved lower-half "
                "namespace", leaf=leaf_path, reserved=pfx)
    if leaf_path.endswith(REPLICA_SUFFIX):
        raise NamespaceError("leaf name ends with replica suffix",
                             leaf=leaf_path)
    return True
