"""Batched gear-scan engine — the device candidate scan under CDC.

Content-defined chunking is only "free" at save time when the rolling-hash
scan runs near memory bandwidth. This module keeps the vectorized numpy scan
as the *correctness oracle* and runs the same scan on the device; every path
computes byte-identical candidates (cut points are the dedup keyspace: a
path that drifts by one byte re-writes history).

Backends keep the JAX package's vocabulary, so ``CheckpointPolicy.to_dict()``
and a manifest's policy block mean the same thing in both packages:

  numpy    the oracle, on the host;
  pallas   the hand-written CUDA kernels (``csrc/*.cu``: the gear scan K1,
           and in the fused dispatch the byteplane forward K2 and the RLE
           emitter K3) on the scanner's CUDA device. On a scanner built
           with ``device="cpu"`` it runs their plain PyTorch versions — the
           same arithmetic, so CPU tests drive the whole device path;
  jnp      the plain PyTorch versions on the scanner's device (CUDA or
           CPU): the kernels' yardstick, never a silent substitute;
  auto     numpy below ``MIN_ACCEL_BYTES``, else pallas on a CUDA device
           and jnp on the CPU.

There is no fallback: a CUDA scanner launches its kernels or raises, and a
scanner asked for ``device="cuda"`` on a machine without a card raises at
construction.

Two device routes, both asynchronous (dispatch now, ``result()`` later):

  scan_async                   the segmented scan of a raw payload: ~4 MiB
                               segments with a 64-byte halo, each staged in a
                               pinned host buffer, uploaded, scanned by K1,
                               and its mask copied back into another pinned
                               buffer, with a CUDA event per segment. Staging
                               buffers recycle only after their event has
                               completed; a ticket waits on its own events,
                               never on the whole device.
  scan_transform_encode_async  the fused three-stage dispatch for the
                               chunk-encoded codecs (``byteplane-rle``,
                               ``byteplane-rans``): K2 transform, K1 scan of
                               the transformed stream, K3 + glue entropy
                               encode, one upload and one event per payload.
  scan_transform_async         K2 then K1 over the transformed stream, no
                               entropy stage: candidates plus the
                               transformed stream come back together.
  transform_async              K2 alone (fixed chunking, or a host codec
                               stage after the transform).

The last two upload through the pinned staging arena as ``scan_async``
does and record one event per payload.
"""
from __future__ import annotations

import hashlib
import threading
from collections import deque

import numpy as np

from ..devices import resolve_device
from . import codec as codec_mod

WINDOW = 64          # rolling-hash window (bytes); boundaries depend on
                     # exactly this much trailing context
SEGMENT_BYTES = 4 << 20      # per-dispatch span of the segmented scan
MIN_ACCEL_BYTES = 2 << 20    # auto: below this the numpy oracle wins
                             # (dispatch + padding overhead)
PALLAS_BLOCK = 64 << 10      # padding granule of the device scan layout
BACKENDS = ("auto", "numpy", "jnp", "pallas")
MAX_INFLIGHT_SEGMENTS = 3    # bounds live staging+result memory: a large
                             # payload scans as a pipeline of segments


def _gear_table() -> np.ndarray:
    # uint32, not uint64: the scan is memory-bandwidth bound and no mask
    # ever needs more than 32 bits (avg_size is capped at 2^28)
    out = np.empty(256, np.uint32)
    for b in range(256):
        h = hashlib.blake2b(bytes([b]), digest_size=4,
                            person=b"repro-cdc-v1").digest()
        out[b] = int.from_bytes(h, "little")
    return out


GEAR = _gear_table()

_EMPTY = np.empty(0, np.int64)

launches = 0            # K1 kernel launches since the last reset
_count_lock = threading.Lock()


def as_u8(payload) -> np.ndarray:
    """Zero-copy uint8 view of any buffer the save path feeds the chunker
    (bytes, memoryview, contiguous ndarray)."""
    if isinstance(payload, np.ndarray):
        return payload.reshape(-1).view(np.uint8)
    return np.frombuffer(payload, np.uint8)


# ---------------------------------------------------------------------------
# numpy backend — the correctness oracle
# ---------------------------------------------------------------------------

def scan_candidates_numpy(data: np.ndarray, mask_strict: int,
                          mask_loose: int):
    """All candidate cut *end offsets* (strict set, loose set). Every
    device path is tested against this."""
    n = len(data)
    if n <= WINDOW:
        return _EMPTY, _EMPTY
    v = GEAR[data]
    c = np.cumsum(v, dtype=np.uint32)          # wraps mod 2^32 — intended
    # window sum ending at byte i (inclusive), for i in [WINDOW-1, n-1]
    s = c[WINDOW - 1:].copy()
    s[1:] -= c[:n - WINDOW]
    loose = np.nonzero((s & np.uint32(mask_loose)) == 0)[0] + WINDOW
    strict = loose[(s[loose - WINDOW] & np.uint32(mask_strict)) == 0]
    return strict.astype(np.int64), loose.astype(np.int64)


# ---------------------------------------------------------------------------
# device scan: K1 and its plain version
# ---------------------------------------------------------------------------
# Layout (the Pallas kernel's): ``padded`` holds WINDOW halo bytes, then the
# span, then padding up to a PALLAS_BLOCK multiple. Mask byte i is 0, 1
# (loose) or 2 (strict) for the 64-byte window ending at i; positions below
# the first window take the tail of the first PALLAS_BLOCK as halo (the
# Pallas program 0 reads its own block) and extraction discards them.

_gear_lock = threading.Lock()
_gear_dev: dict = {}          # device → GEAR as an int32 tensor


def _gear_tensor(device):
    """GEAR on `device` (uploaded once: a per-call upload from pageable
    memory would wait for the stream's queued work)."""
    import torch
    with _gear_lock:
        g = _gear_dev.get(device)
        if g is None:
            g = _gear_dev[device] = torch.from_numpy(
                GEAR.view(np.int32).copy()).to(device)
        return g


def gear_scan_plain(padded, mask_strict: int, mask_loose: int):
    """Plain PyTorch mask over a padded uint8 tensor. torch has no wrapping
    uint32 add or cumsum, so sums run in int64 and are masked to 32 bits
    (a 64-bit cumsum of 32-bit values cannot overflow below 2^31 bytes of
    input)."""
    import torch
    n = padded.shape[0]
    gear = _gear_tensor(padded.device).to(torch.int64) & 0xFFFFFFFF
    ext = torch.cat([padded[PALLAS_BLOCK - WINDOW:PALLAS_BLOCK], padded])
    c = torch.cumsum(gear[ext.long()], 0)
    w = (c[WINDOW:] - c[:n]) & 0xFFFFFFFF
    h = w & int(mask_strict)
    return ((h & int(mask_loose)) == 0).to(torch.uint8) + \
        (h == 0).to(torch.uint8)


def gear_scan(padded, mask_strict: int, mask_loose: int):
    """Mask over a padded uint8 tensor. CUDA tensor → the K1 kernel on the
    current stream; CPU tensor → ``gear_scan_plain``."""
    import torch
    if padded.dtype != torch.uint8 or padded.dim() != 1:
        raise TypeError(f"expected a 1-D uint8 tensor, got {padded.dtype} "
                        f"{tuple(padded.shape)}")
    n = padded.shape[0]
    if n == 0 or n % PALLAS_BLOCK:
        raise ValueError(f"padded length {n} is not a positive multiple "
                         f"of {PALLAS_BLOCK}")
    if not padded.is_cuda:
        return gear_scan_plain(padded, mask_strict, mask_loose)
    if not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("gear-scan kernel needs a contiguous, 16-byte "
                         "aligned input")
    from ..kernels import build
    out = torch.empty_like(padded)
    gear = _gear_tensor(padded.device)
    build.launch("gear_scan", padded, padded.data_ptr(), out.data_ptr(),
                 gear.data_ptr(), n, int(mask_strict), int(mask_loose))
    global launches
    with _count_lock:
        launches += 1
    return out


def padded_len(n: int) -> int:
    """Device scan length for an n-byte span: WINDOW halo + span, rounded
    up to PALLAS_BLOCK."""
    return -(-(n + WINDOW) // PALLAS_BLOCK) * PALLAS_BLOCK


def extract(mask: np.ndarray, start: int, seg_len: int, total_len: int):
    """Host mask of one span → global (strict, loose) candidate end
    offsets. Positions below the first full window (global < WINDOW-1) and
    in the padding are discarded — the oracle's validity range."""
    p = np.flatnonzero(mask) - WINDOW        # → span-local positions
    p = p[(p >= 0) & (p < seg_len)]
    gp = p + start
    ok = (gp >= WINDOW - 1) & (gp < total_len)
    gp = gp[ok]
    mv = mask[p + WINDOW][ok]
    return (gp[mv == 2] + 1), (gp + 1)


class _StagingArena:
    """Host staging-buffer pool for device dispatches (pinned on a CUDA
    device, so uploads and mask downloads are asynchronous). A buffer goes
    back to the pool only once the CUDA event recorded after its last use
    has completed — a pinned buffer reused while its copy is in flight
    would hand the device torn bytes."""

    MAX_PER_SIZE = 4    # idle buffers kept per size (≥ in-flight window)

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict = {}           # (nbytes, pinned) → [tensor]

    def acquire(self, n: int, pinned: bool):
        import torch
        with self._lock:
            bufs = self._free.get((n, pinned))
            if bufs:
                return bufs.pop()
        return torch.empty(n, dtype=torch.uint8, pin_memory=pinned)

    def release(self, buf, event=None):
        if event is not None and not event.query():
            raise RuntimeError("staging buffer released while its "
                               "dispatch is in flight")
        key = (buf.numel(), buf.is_pinned())
        with self._lock:
            bufs = self._free.setdefault(key, [])
            if len(bufs) < self.MAX_PER_SIZE:
                bufs.append(buf)


_ARENA = _StagingArena()


def _upload(host, device):
    """uint8 host tensor → the device (asynchronous from pinned memory);
    a CPU device reads the host tensor in place."""
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def _download(t, from_arena: bool = False):
    """Start copying device tensor `t` to the host. On a CUDA device the
    copy lands in pinned memory asynchronously (the caller records an
    event after it); a CPU tensor is returned as is. ``from_arena`` takes
    the pinned buffer (1-D uint8) from the staging arena."""
    import torch
    if not t.is_cuda:
        return t
    host = (_ARENA.acquire(t.numel(), True) if from_arena else
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
    host.copy_(t, non_blocking=True)
    return host


def _record(device):
    """A CUDA event recorded on the current stream (None on the CPU)."""
    import torch
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _SegmentDispatch:
    """One in-flight segment of the segmented scan: the staging buffer, the
    host mask (filling), and the event recorded after both copies."""

    __slots__ = ("staging", "mask", "event")

    def __init__(self, staging, mask, event):
        self.staging = staging
        self.mask = mask
        self.event = event

    def finish(self, start: int, seg_len: int, total: int):
        if self.event is not None:
            self.event.synchronize()
        cands = extract(self.mask.numpy(), start, seg_len, total)
        _ARENA.release(self.staging, self.event)
        if self.mask.is_pinned():
            _ARENA.release(self.mask, self.event)
        return cands


# ---------------------------------------------------------------------------
# tickets
# ---------------------------------------------------------------------------

class ScanTicket:
    """Handle for one (possibly in-flight) payload scan. ``result()``
    joins the device work and returns the (strict, loose) candidate end
    offsets — byte-identical to the numpy oracle.

    Dispatch is WINDOWED: the first ``MAX_INFLIGHT_SEGMENTS`` segments
    are launched by ``scan_async`` (so device work overlaps whatever the
    caller does next); the rest launch from ``result()`` as earlier
    segments extract, keeping at most a few segments of staging buffers
    alive at once."""

    __slots__ = ("_pending", "_todo", "_dispatch", "_done")

    def __init__(self, pending=None, todo=None, dispatch=None, done=None):
        self._pending = pending         # deque of (dispatch, start, len, n)
        self._todo = todo               # [(start, seg_len, total)]
        self._dispatch = dispatch
        self._done = done               # eager paths resolve immediately

    def result(self):
        if self._done is None:
            strict, loose = [], []
            while self._pending:
                d, start, seg_len, total = self._pending.popleft()
                s, l = d.finish(start, seg_len, total)
                strict.append(s)
                loose.append(l)
                if self._todo:
                    nstart, nlen, ntotal = self._todo.pop(0)
                    self._pending.append(
                        (self._dispatch(nstart, nlen), nstart, nlen, ntotal))
            self._done = (
                np.concatenate(strict) if strict else _EMPTY,
                np.concatenate(loose) if loose else _EMPTY)
            self._pending = self._todo = self._dispatch = None
        return self._done


class _Deferred:
    """A dispatch whose ``result()`` is computed once, on first call (or
    given up front as `done` by the inline host paths)."""

    __slots__ = ("_resolve", "_done")

    def __init__(self, resolve=None, done=None):
        self._resolve = resolve
        self._done = done

    def result(self):
        if self._done is None:
            self._done = self._resolve()
            self._resolve = None
        return self._done


class FusedEncodeTicket(_Deferred):
    """Handle for one fused transform + scan + plane-entropy dispatch.
    ``result()`` waits on the dispatch's event and returns
    ``((strict, loose), stream, block_lens)``: candidate end offsets over
    the transformed stream, the framed RLE/rANS block stream (host uint8,
    byte-identical to the oracle encoding of the oracle transform) and
    per-block encoded lengths (headers included) whose prefix sums let
    the save path slice any plane-block-aligned chunk's encoding out of
    the stream without re-encoding."""

    __slots__ = ()


class FusedScanTicket(_Deferred):
    """Handle for one fused transform + scan dispatch. ``result()`` returns
    ``((strict, loose), transformed)``: candidate end offsets computed over
    the transformed stream (byte-identical to the numpy oracle scanning the
    oracle transform) plus the transformed payload as a host uint8
    array."""

    __slots__ = ()


class TransformTicket(_Deferred):
    """Handle for one standalone device byteplane transform (no candidate
    scan). ``result()`` returns the transformed stream as a host uint8
    array, byte-identical to the oracle."""

    __slots__ = ()


def _stage(data: np.ndarray, device):
    """Copy a host payload into a staging buffer (pinned on a CUDA device)
    and start its upload; returns (staging buffer, device tensor)."""
    staging = _ARENA.acquire(len(data), device.type == "cuda")
    staging.numpy()[:] = data
    return staging, _upload(staging, device)


def _resolver(event, staging, outs, finish):
    """``result()`` body of a device dispatch: wait on its event, turn the
    downloaded tensors `outs` into numpy arrays (copies of arena buffers,
    which return to the pool), and hand them to `finish`."""
    def resolve():
        if event is not None:
            event.synchronize()
        arrays = []
        for t in outs:
            if t.is_pinned():
                arrays.append(t.numpy().copy())
                _ARENA.release(t, event)
            else:
                arrays.append(t.numpy())
        _ARENA.release(staging, event)
        return finish(*arrays)
    return resolve


def transform_async(payload, itemsize: int, device=None) -> TransformTicket:
    """Async byteplane forward transform WITHOUT a candidate scan — the
    save path uses this when the codec wants pre-conditioned bytes but the
    chunk grid is not content-defined over them (fixed chunking, or a host
    codec stage after the transform). On `device` (``None`` → CUDA) the
    payload goes up through the staging arena, K2 runs once (its plain
    version on a CPU device) and the stream comes back into pinned memory.
    Below the acceleration threshold the host oracle runs inline — same
    bytes either way."""
    data = as_u8(payload)
    if len(data) < MIN_ACCEL_BYTES:
        return TransformTicket(
            done=codec_mod.byteplane_forward(data, itemsize))
    from ..kernels.ckpt_codec import byteplane as bp
    dev = resolve_device(device)
    staging, raw = _stage(data, dev)
    t = _download(bp.forward_planes(raw, int(itemsize)), from_arena=True)
    return TransformTicket(resolve=_resolver(_record(dev), staging, (t,),
                                             lambda a: a))


# ---------------------------------------------------------------------------
# the scanner
# ---------------------------------------------------------------------------

class GearScanner:
    """Candidate scan for one (mask_strict, mask_loose) pair with a
    selectable backend, on ``device`` (``None`` → CUDA). ``scan`` is
    synchronous; ``scan_async`` dispatches device work and returns a
    ticket, which is how the save path overlaps the scan of the next
    payload with the chunk hash/write of the current one."""

    def __init__(self, mask_strict: int, mask_loose: int, *,
                 backend: str = "auto", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"scan_backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        self.mask_strict = int(mask_strict)
        self.mask_loose = int(mask_loose)
        if self.mask_loose & ~self.mask_strict:
            # the single-AND trick in the device scan (and the
            # strict-⊆-loose candidate algebra) both require nested masks
            raise ValueError("mask_loose must be a bit-subset of "
                             "mask_strict")
        self.backend = backend
        self.device = resolve_device(device)

    # -- backend resolution -------------------------------------------
    def accelerator_present(self) -> bool:
        """The scanner's device is a CUDA card."""
        return self.device.type == "cuda"

    def resolve(self, n: int) -> str:
        """The backend a payload of ``n`` bytes actually runs on."""
        if self.backend == "auto":
            if n < MIN_ACCEL_BYTES:
                return "numpy"     # dispatch overhead dominates below this
            return "pallas" if self.accelerator_present() else "jnp"
        return self.backend

    def _ops(self, backend: str):
        """(transform, scan, emitter) for a device backend: the kernel
        wrappers for pallas, the plain versions for jnp."""
        from ..kernels.ckpt_codec import byteplane as bp
        from ..kernels.ckpt_codec import entropy as ent
        if backend == "pallas":
            return bp.forward_planes, gear_scan, ent.rle_emission
        return bp.forward_plain, gear_scan_plain, ent.rle_emission_plain

    # -- scanning ------------------------------------------------------
    def scan(self, payload):
        return self.scan_async(payload).result()

    def scan_async(self, payload) -> ScanTicket:
        data = as_u8(payload)
        n = len(data)
        if n <= WINDOW:
            return ScanTicket(done=(_EMPTY, _EMPTY))
        backend = self.resolve(n)
        if backend == "numpy":
            return ScanTicket(done=scan_candidates_numpy(
                data, self.mask_strict, self.mask_loose))
        _, scan, _ = self._ops(backend)
        dev = self.device
        pinned = dev.type == "cuda"

        def dispatch(start, seg_len):
            # warm staging, never zeroed: halo/tail garbage is filtered by
            # extraction (and the first-window positions it could
            # influence are below WINDOW-1)
            staging = _ARENA.acquire(padded_len(seg_len), pinned)
            buf = staging.numpy()
            halo = min(start, WINDOW)
            if halo:
                buf[WINDOW - halo:WINDOW] = data[start - halo:start]
            buf[WINDOW:WINDOW + seg_len] = data[start:start + seg_len]
            mask = _download(scan(_upload(staging, dev), self.mask_strict,
                                  self.mask_loose), from_arena=True)
            return _SegmentDispatch(staging, mask, _record(dev))

        spans = []
        pos = 0
        while pos < n:
            seg_len = min(SEGMENT_BYTES, n - pos)
            spans.append((pos, seg_len, n))
            pos += seg_len
        pending = deque(
            (dispatch(start, seg_len), start, seg_len, total)
            for start, seg_len, total in spans[:MAX_INFLIGHT_SEGMENTS])
        return ScanTicket(pending, spans[MAX_INFLIGHT_SEGMENTS:], dispatch)

    def scan_transform_async(self, payload, itemsize: int) \
            -> FusedScanTicket:
        """The byteplane forward transform (K2) and the candidate scan of
        the *transformed* stream (K1) as ONE device round-trip: one upload
        through the staging arena, one event, the mask and the stream
        downloaded together. Below the acceleration threshold (or on the
        numpy backend) the host oracle runs both stages inline: same
        bytes, same candidates."""
        import torch
        data = as_u8(payload)
        n = len(data)
        backend = self.resolve(n)
        if backend == "numpy" or n <= WINDOW:
            t = codec_mod.byteplane_forward(data, itemsize)
            done = (scan_candidates_numpy(t, self.mask_strict,
                                          self.mask_loose)
                    if n > WINDOW else (_EMPTY, _EMPTY))
            return FusedScanTicket(done=(done, t))
        transform, scan, _ = self._ops(backend)
        dev = self.device
        staging, raw = _stage(data, dev)
        t = transform(raw, int(itemsize))
        padded = torch.zeros(padded_len(n), dtype=torch.uint8, device=dev)
        padded[WINDOW:WINDOW + n] = t
        mask = scan(padded, self.mask_strict, self.mask_loose)
        outs = (_download(mask, from_arena=True),
                _download(t, from_arena=True))
        return FusedScanTicket(resolve=_resolver(
            _record(dev), staging, outs,
            lambda m, tt: (extract(m, 0, n, n), tt)))

    def scan_transform_encode_async(self, payload, itemsize: int,
                                    entropy_codec: str) \
            -> FusedEncodeTicket:
        """Three fused stages in ONE device round-trip: byteplane forward
        transform (K2), candidate scan of the transformed stream (K1), and
        the plane RLE block encoder (K3 + glue) — chunks reach the host
        already compressed. Below the acceleration threshold (or on the
        numpy backend) the host oracle runs all three stages inline: same
        bytes, same candidates, same encoded stream."""
        import torch

        from ..kernels.ckpt_codec import entropy as ent
        data = as_u8(payload)
        n = len(data)
        backend = self.resolve(n)
        if backend == "numpy" or n <= WINDOW:
            t = codec_mod.byteplane_forward(data, itemsize)
            cands = (scan_candidates_numpy(t, self.mask_strict,
                                           self.mask_loose)
                     if n > WINDOW else (_EMPTY, _EMPTY))
            stream, block_lens = codec_mod.plane_stream_encode(
                t, entropy_codec)
            return FusedEncodeTicket(done=(cands, stream, block_lens))
        transform, scan, emitter = self._ops(backend)
        dev = self.device
        # the JAX package uploads the snapshot payload again for this
        # dispatch (cdc_scan.py:753); the same flow here
        raw = torch.empty(n, dtype=torch.uint8, device=dev)
        raw.copy_(torch.from_numpy(np.array(data, copy=not
                                            data.flags.writeable)))
        t = transform(raw, int(itemsize))
        padded = torch.zeros(padded_len(n), dtype=torch.uint8, device=dev)
        padded[WINDOW:WINDOW + n] = t
        mask = scan(padded, self.mask_strict, self.mask_loose)
        _, dlens, out, total = ent.encode(t, entropy_codec, emitter)
        mask_h, dlens_h, out_h, total_h = (
            _download(x) for x in (mask, dlens, out, total))
        event = _record(dev)

        def resolve():
            if event is not None:
                event.synchronize()
            cands = extract(mask_h.numpy(), 0, n, n)
            stream = out_h.numpy()[:int(total_h)]
            block_lens = 3 + dlens_h.numpy().astype(np.int64)
            return cands, stream, block_lens

        return FusedEncodeTicket(resolve=resolve)
