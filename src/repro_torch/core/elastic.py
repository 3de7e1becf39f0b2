"""Elastic restore planner — the M×N portability core.

A checkpoint stores, per pytree leaf, shard files covering logical index
ranges of the global array. Restoring onto a NEW mesh asks, per device, for
some index range; the planner computes which saved files overlap and how to
assemble the requested block. Nothing about the saving topology (device
count, mesh shape, host count, sharding) is assumed — the direct analogue of
MANA's "restart under a different MPI / network than the one you
checkpointed under", strengthened to arbitrary re-sharding.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShardRange:
    """Half-open logical index range [start, stop) per dim."""
    start: tuple
    stop: tuple

    @property
    def shape(self):
        return tuple(b - a for a, b in zip(self.start, self.stop))

    def size(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def normalize_index(index, global_shape) -> ShardRange:
    """jax shard .index (tuple of slices, possibly with Nones) → ShardRange."""
    start, stop = [], []
    for sl, dim in zip(index, global_shape):
        start.append(0 if sl.start is None else int(sl.start))
        stop.append(dim if sl.stop is None else int(sl.stop))
    return ShardRange(tuple(start), tuple(stop))


def overlap(a: ShardRange, b: ShardRange) -> ShardRange | None:
    start = tuple(max(x, y) for x, y in zip(a.start, b.start))
    stop = tuple(min(x, y) for x, y in zip(a.stop, b.stop))
    if any(p >= q for p, q in zip(start, stop)) and len(start) > 0:
        return None
    return ShardRange(start, stop)


def assemble(target: ShardRange, pieces, dtype) -> np.ndarray:
    """pieces: iterable of (ShardRange, np.ndarray) fully covering `target`.

    Raises if coverage is incomplete (missing shards are a restore error the
    caller maps to CKPT_E_MISSING).
    """
    out = np.empty(target.shape, dtype=dtype)
    covered = np.zeros(target.shape, dtype=bool) if target.shape else \
        np.zeros((), dtype=bool)
    for rng, arr in pieces:
        ov = overlap(rng, target)
        if ov is None and target.shape:
            continue
        if not target.shape:  # scalar
            out[...] = arr
            covered = np.ones((), bool)
            continue
        dst = tuple(slice(a - t, b - t)
                    for a, b, t in zip(ov.start, ov.stop, target.start))
        src = tuple(slice(a - s, b - s)
                    for a, b, s in zip(ov.start, ov.stop, rng.start))
        out[dst] = arr[src]
        covered[dst] = True
    if not bool(np.all(covered)):
        missing = int(covered.size - covered.sum()) if target.shape else 1
        raise LookupError(f"restore plan leaves {missing} elements uncovered "
                          f"for target {target}")
    return out


def plan_reads(target: ShardRange, available: list) -> list:
    """available: list of (ShardRange, handle). Returns a small subset
    (greedy by overlap size) that covers `target`.

    Coverage is tracked per ELEMENT, not by an element-count bound: saved
    shards may partially overlap each other (e.g. ranges written under
    different topologies in one history), and a count that double-credits
    the overlap would stop picking before the target is actually covered.
    Shards contributing no new elements are skipped — redundant replicas
    are never read twice."""
    scored = []
    for rng, handle in available:
        ov = overlap(rng, target)
        if ov is not None or not target.shape:
            scored.append((ov.size() if ov else 1, ov, rng, handle))
    # greedy: biggest overlaps first — fewest reads, no redundant replicas
    scored.sort(key=lambda t: -t[0])
    if not target.shape:                     # scalar: any one source serves
        return [(rng, handle) for _, _, rng, handle in scored[:1]]
    if scored and scored[0][1] is not None \
            and scored[0][1].start == target.start \
            and scored[0][1].stop == target.stop:
        # exact cover by one source (the common same-topology restore):
        # answer in O(1), before allocating the coverage mask — this sits
        # on the restore hot path next to the assemble-skip fast path
        return [(scored[0][2], scored[0][3])]
    # partial covers: one bool mask (assemble allocates the same for its
    # coverage check right after) with per-element accounting — but only
    # slice-sized counts per candidate, never full-array scans
    covered = np.zeros(target.shape, dtype=bool)
    remaining = target.size()
    picks = []
    for _, ov, rng, handle in scored:
        if remaining <= 0:
            break
        dst = tuple(slice(a - t, b - t)
                    for a, b, t in zip(ov.start, ov.stop, target.start))
        sub = covered[dst]
        fresh = sub.size - int(np.count_nonzero(sub))
        if fresh == 0:
            continue                         # adds nothing new
        covered[dst] = True
        remaining -= fresh
        picks.append((rng, handle))
    return picks


# ---------------------------------------------------------------------------
# first-use ordering (streaming restore-behind)
# ---------------------------------------------------------------------------
# A forward pass touches the embedding first, then transformer blocks in
# index order, then the final norm / LM head; optimizer slots follow their
# layer. Streaming restore orders the fetch schedule by that first use so
# step 0 can begin once the leading classes are resident while tail layers
# stream in behind the completion gate.

_EMBED_RE = re.compile(
    r"(?:^|[/._-])(?:embed\w*|wte|wpe|tok_emb\w*|pos_emb\w*)")
_TAIL_RE = re.compile(
    r"(?:^|[/._-])(?:lm_head|head|final\w*|ln_f|out_norm)")
_BLOCK_RE = re.compile(
    r"(?:^|[/._-])(?:layers?|blocks?|stages?|h|b)_?(\d+)")

FIRST_USE_DEFAULT = 1 << 61      # unclassified: after all indexed blocks
FIRST_USE_TAIL = 1 << 62         # final norm / head: touched last


def leaf_first_use_class(name: str) -> int:
    """Config-derived first-use class of one leaf path (lower = touched
    earlier in step 0). Class 0 = embeddings and step counters; class
    1+k = the k-th indexed block, composing nested indices
    (``stage_1/b2`` orders after every block of ``stage_0``); tail heads
    and norms come last; unrecognized names land just before the tail —
    correctness never depends on this (an early touch of a late-classed
    leaf just blocks on its future), only time-to-first-step does."""
    n = name.lower()
    blocks = [int(m) for m in _BLOCK_RE.findall(n)]
    if blocks:
        cls = 1
        for b in blocks:
            cls = cls * 4096 + b
        return cls
    if _EMBED_RE.search(n):
        return 0
    if _TAIL_RE.search(n):
        return FIRST_USE_TAIL
    if any(tok in n for tok in ("step", "count", "rng", "key")):
        return 0                 # tiny scalars the loop needs immediately
    return FIRST_USE_DEFAULT


def first_use_order(names, priority=None) -> list:
    """Indices of `names` sorted by first-use class (stable within a
    class, so equal-class leaves keep manifest order)."""
    pr = priority or leaf_first_use_class
    return sorted(range(len(names)), key=lambda i: (pr(names[i]), i))
