"""Content-defined chunking (FastCDC-style) for the content-addressed store.

Fixed-size chunking destroys dedup the moment a payload shifts by a byte:
every chunk boundary after the edit moves, every digest changes, and an
insert near the front of a leaf re-writes the whole leaf. Content-defined
chunking places boundaries where the *data* says to — a rolling hash over a
small window — so identical regions re-align to identical chunks no matter
how far the surrounding bytes shifted.

This implementation keeps FastCDC's cut discipline and replaces its
byte-at-a-time loop with a vectorizable rolling hash:

  * **Gear table** — 256 random 64-bit values derived deterministically
    from blake2b (boundaries, and therefore dedup, are stable across
    processes, machines and runs; no seed state to persist);
  * **Rolling hash** — the windowed gear sum ``H[i] = Σ gear[b[i-k]]``
    over the trailing ``WINDOW`` bytes, computed for every position with
    one table lookup + one ``cumsum`` + one subtraction over the whole
    payload (uint32 wraparound is the modulus). A boundary is a position
    where ``H & mask == 0``; each byte entering/leaving the window
    reshuffles all 32 bits, and sums of 64 table values are uniform, so
    cut spacing is geometric exactly as with the classic shift-gear hash —
    but the scan is vectorized instead of a Python loop, with selectable
    backends (``core.cdc_scan``): the numpy oracle, or the device scan —
    a hand-written CUDA kernel or its plain PyTorch version — all
    byte-identical;
  * **Normalized chunking with min/avg/max bounds** — FastCDC's two-mask
    scheme: below the average target a *stricter* mask (avg·2^NORM_BITS
    expected spacing) applies, past it a *looser* one, and ``max_size``
    force-cuts. This tightens the size distribution around the average,
    which is what makes "equal average chunk size" comparisons against
    fixed-size chunking fair.

Invariants (property-tested in ``tests/test_cdc.py``):

  * concatenating the chunks reproduces the payload exactly;
  * every chunk is ≤ ``max_size``; every chunk except the final one is
    ≥ ``min_size``;
  * chunking is deterministic;
  * after inserting/deleting a region, only chunks overlapping the edit
    (plus at most a couple of boundary-resync chunks) change digest.
"""
from __future__ import annotations

import numpy as np

from . import cdc_scan
from .cdc_scan import GEAR, WINDOW, GearScanner  # noqa: F401 — re-exports:
# the gear table and window are part of the on-disk dedup contract and
# tests pin them through this module

NORM_BITS = 2        # FastCDC normalization level (mask skew around avg)
MIN_DIV = 4          # default min_size = avg_size // MIN_DIV
MAX_MUL = 4          # default max_size = avg_size * MAX_MUL
MIN_AVG_SIZE = 4 * WINDOW   # below this min_size would undercut the window


class GearChunker:
    """FastCDC-style chunker with min/avg/max bounds.

    ``avg_size`` is the target average; boundaries are content-defined, so
    actual sizes are geometric around it, clamped to [min_size, max_size].
    """

    def __init__(self, avg_size: int, *, min_size: int | None = None,
                 max_size: int | None = None, scan_backend: str = "numpy",
                 device=None):
        if avg_size < MIN_AVG_SIZE:
            raise ValueError(
                f"avg_size must be >= {MIN_AVG_SIZE} (rolling-hash window "
                f"is {WINDOW} bytes), got {avg_size}")
        if avg_size > 1 << 28:
            raise ValueError("avg_size must be <= 2^28 (32-bit hash masks)")
        self.avg_size = int(avg_size)
        self.min_size = int(min_size or max(self.avg_size // MIN_DIV, WINDOW))
        self.max_size = int(max_size or self.avg_size * MAX_MUL)
        if not WINDOW <= self.min_size <= self.avg_size <= self.max_size:
            raise ValueError(
                f"need {WINDOW} <= min({self.min_size}) <= "
                f"avg({self.avg_size}) <= max({self.max_size})")
        bits = max(round(np.log2(self.avg_size)), 1)
        # low-bit masks: the windowed gear sum is uniform in all 32 bits,
        # so plain nested masks give the right hit probabilities and the
        # strict-candidate set is a subset of the loose one
        self.mask_strict = np.uint32((1 << (bits + NORM_BITS)) - 1)
        self.mask_loose = np.uint32((1 << max(bits - NORM_BITS, 1)) - 1)
        # candidate scan engine: "numpy" (the oracle), "jnp" / "pallas"
        # (device scan, byte-identical — core.cdc_scan), or "auto"; on
        # `device` (None → CUDA)
        self.scan_backend = scan_backend
        self.scanner = GearScanner(int(self.mask_strict),
                                   int(self.mask_loose),
                                   backend=scan_backend, device=device)

    @classmethod
    def from_policy(cls, chunking, *, serial: bool = False, device=None):
        """The chunker a ``ChunkingPolicy`` describes — ``None`` for the
        fixed scheme. The serial engine pins the numpy oracle scan (it IS
        the serial baseline; accelerated scans must not leak into it)."""
        if chunking.scheme != "cdc":
            return None
        return cls(int(chunking.chunk_size),
                   min_size=chunking.min_size, max_size=chunking.max_size,
                   scan_backend="numpy" if serial else chunking.scan_backend,
                   device=device)

    # ------------------------------------------------------------------
    def _candidates(self, payload):
        """All candidate cut *end offsets* (strict set, loose set)."""
        return self.scanner.scan(payload)

    def cut_points(self, payload, candidates=None) -> list:
        """End offsets of every chunk (last one == len(payload)).

        ``candidates`` short-circuits the scan with a precomputed
        (strict, loose) pair — the save path scans payloads asynchronously
        (``scanner.scan_async``) so the scan of payload k+1 overlaps the
        chunk hash/write of payload k, then feeds the result back here."""
        strict, loose = (candidates if candidates is not None
                         else self._candidates(payload))
        return self.cut_points_n(len(payload), (strict, loose))

    def cut_points_n(self, n: int, candidates) -> list:
        """``cut_points`` when only the payload LENGTH is known — the
        fused transform+scan+entropy dispatch never materializes the
        transformed bytes on the host, so the save path cuts on
        ``(strict, loose)`` candidates plus the length alone."""
        if n == 0:
            return []
        if n <= self.min_size:
            return [n]
        strict, loose = candidates
        cuts = []
        pos = 0
        while n - pos > self.min_size:
            hi = min(pos + self.max_size, n)
            e = None
            j = int(np.searchsorted(strict, pos + self.min_size))
            if j < len(strict) and strict[j] <= min(pos + self.avg_size, hi):
                e = int(strict[j])
            else:
                j = int(np.searchsorted(loose, pos + self.avg_size + 1))
                if j < len(loose) and loose[j] <= hi:
                    e = int(loose[j])
            if e is None:
                if hi < n:
                    e = hi                 # force-cut at max_size
                else:
                    break                  # tail (≤ max_size) is one chunk
            cuts.append(e)
            pos = e
        if pos < n:
            cuts.append(n)
        return cuts

    @staticmethod
    def align_cuts(cuts: list, n: int, align: int) -> list:
        """Round content-defined cut end-offsets UP to ``align`` multiples
        (the final cut stays at ``n``), dropping duplicates. The chunk-
        encoded codecs cut on this grid so every chunk starts on a plane-
        block boundary: each chunk's entropy encoding is then BOTH a pure
        function of the chunk bytes (dedup-stable) and a contiguous slice
        of the whole-payload encoded stream the fused dispatch returns.
        Alignment shifts cuts by < align ≪ min_size, so the size bounds
        and boundary-resync properties of CDC survive."""
        out = []
        last = 0
        for c in cuts:
            a = min(-(-int(c) // align) * align, n)
            if a > last:
                out.append(a)
                last = a
        return out

    def chunk(self, payload, candidates=None) -> list:
        """Split ``payload`` into content-defined chunks.

        Returns zero-copy ``memoryview`` slices — the chunker never
        duplicates the payload; hashing, crc folding and object writes all
        accept buffer views (``payload`` may be bytes, a memoryview, or a
        contiguous uint8 ndarray)."""
        cuts = self.cut_points(payload, candidates=candidates)
        mv = memoryview(payload)
        out = []
        pos = 0
        for e in cuts:
            out.append(mv[pos:e])
            pos = e
        return out
