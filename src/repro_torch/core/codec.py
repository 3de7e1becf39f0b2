"""Shard payload codecs: raw | zstd | int8 block-quantization (+zstd) |
byteplane pre-conditioning (± zstd).

The int8 codec addresses the paper's stated future work ("reducing the
checkpoint overhead for large-scale applications"): 4×/2× size reduction on
f32/bf16 leaves with per-block scales. The device-side quantizer has a Pallas
TPU kernel (repro.kernels.ckpt_codec) validated against the numpy encoder
here; on the host path we quantize with numpy after device→host transfer.

The byteplane codecs are LOSSLESS pre-conditioning: the payload's bytes are
transposed into per-byte-position planes (plane p holds byte p of every
element) and each plane is delta-coded mod 256. Params-like floats have
near-constant sign/exponent bytes interleaved with near-random mantissa
bytes; separating the planes turns the stream into long runs the entropy
stage compresses faster AND tighter, and lets zstd's incompressible-block
fast path skip the mantissa planes instead of grinding the matcher over
interleaved noise. ``byteplane`` stores the transformed stream as-is (a
size-preserving permutation — chunking/dedup operate on it directly);
``byteplane-zstd`` adds the host zstd stage. Both are self-describing via
``meta["bp"]`` (the element width) and invert on decode. The functions here
are the numpy ORACLE; the device-side jnp/Pallas backends
(``repro.kernels.ckpt_codec.byteplane``) are property-tested against them,
and the save path fuses the forward transform into the CDC gear-scan
dispatch (``core.cdc_scan.GearScanner.scan_transform_async``).

``byteplane-rle`` / ``byteplane-rans`` move the entropy stage itself onto
the device (nvCOMP/DietGPU-style): the transformed stream is encoded in
fixed 4 KiB plane blocks — RLE for the run-length-collapsing sign/exponent
planes, order-0 lane-interleaved rANS for mixed low-entropy blocks, and a
per-block "store raw" escape so incompressible mantissa planes pass through
untouched. These are CHUNK-ENCODED codecs: boundaries are still cut on the
transformed stream (rounded up to plane-block alignment), each chunk is
entropy-coded independently and deterministically (dedup-stable), and v7
manifests carry per-chunk (raw_len, enc_len) pairs so restore can place
encoded chunks directly and decode after placement.

`zstandard` is an OPTIONAL dependency (the `compress` extra): raw, int8 and
byteplane work without it (int8 then stores its quantized payload
uncompressed, flagged in meta so decode stays self-describing); asking for
codec="zstd" or "byteplane-zstd" without the package raises
CodecUnavailableError with the install hint.
"""
from __future__ import annotations

import threading

import numpy as np

from .errors import CodecUnavailableError

try:
    import zstandard
    HAVE_ZSTD = True
except ModuleNotFoundError:           # optional dependency (compress extra)
    zstandard = None
    HAVE_ZSTD = False

BLOCK = 256
CODECS = ("raw", "zstd", "int8", "byteplane", "byteplane-zstd",
          "byteplane-rle", "byteplane-rans")
# codecs whose encode is (byteplane transform → optional entropy stage):
# the save path may run the transform ON DEVICE, fused into the CDC scan
PRECONDITIONED = ("byteplane", "byteplane-zstd", "byteplane-rle",
                  "byteplane-rans")
# the device-entropy subset: the entropy stage is applied PER CHUNK of the
# transformed stream (chunk boundaries are still cut on the transformed
# bytes; the CAS stores each chunk's encoding, and the manifest records
# per-chunk (raw_len, enc_len) pairs). Encoding is a pure function of the
# chunk bytes, so identical chunks still dedup to identical objects.
CHUNK_ENCODED = ("byteplane-rle", "byteplane-rans")

# -- entropy-stage format constants (the on-disk contract) ------------------
# Plane blocks: the transformed stream is encoded in fixed-size blocks so
# the escape decision tracks the byte-plane structure (a 4 KiB block lies
# inside one plane for any realistically-sized shard). CDC cut points are
# rounded UP to this alignment when a chunk-encoded codec is active, so a
# chunk's encoding equals the concatenation of its blocks' encodings and
# the fused device dispatch can encode the whole payload once.
ENTROPY_BLOCK = 4096
RANS_LANES = 16          # lane-interleaved rANS states per block
RANS_PROB_BITS = 12      # quantized frequency precision (sum = 4096)
RANS_L = 1 << 23         # renormalization lower bound (byte renorm)
_RANS_STEPS = ENTROPY_BLOCK // RANS_LANES
_LANE_MAX = 2 * _RANS_STEPS       # emission bound: ≤2 bytes/symbol/lane
# fixed per-block rANS overhead: nsyms byte + 16×u32 states + 16×u16 lens
_RANS_FIXED = 1 + 4 * RANS_LANES + 2 * RANS_LANES

# zstandard (de)compressor objects are NOT thread-safe; the checkpoint writer
# runs N rank threads concurrently (observed: "Src size is incorrect" under
# shared compressors — the paper's missing-locks failure class). Thread-local
# instances instead of a lock keep ranks parallel.
_TL = threading.local()


def _require_zstd(op: str):
    if not HAVE_ZSTD:
        raise CodecUnavailableError(
            "codec requires the optional `zstandard` package "
            "(pip install 'repro[compress]')", op=op)


def _zc() -> "zstandard.ZstdCompressor":
    _require_zstd("compress")
    if not hasattr(_TL, "zc"):
        _TL.zc = zstandard.ZstdCompressor(level=3)
    return _TL.zc


def _zd() -> "zstandard.ZstdDecompressor":
    _require_zstd("decompress")
    if not hasattr(_TL, "zd"):
        _TL.zd = zstandard.ZstdDecompressor()
    return _TL.zd


def available(codec: str) -> bool:
    """True iff `codec` is usable in this environment."""
    if codec in ("zstd", "byteplane-zstd"):
        return HAVE_ZSTD
    return codec in CODECS


def default_codec() -> str:
    """Best lossless codec the environment supports."""
    return "zstd" if HAVE_ZSTD else "raw"


# bfloat16 host payloads: numpy has no bfloat16 type without ``ml_dtypes``,
# so a bf16 array is carried as its uint16 bit pattern under a dtype whose
# metadata names the logical type. The metadata survives reshape, views of
# the same dtype, copies and ``np.frombuffer``; ``dtype_name`` reads it back,
# so manifests and shard records spell the dtype exactly as the JAX
# package's do.
BF16 = np.dtype(np.uint16, metadata={"logical": "bfloat16"})


def dtype_name(x) -> str:
    """numpy's spelling of the LOGICAL dtype of a numpy array, a torch
    tensor, a numpy dtype or a torch dtype: ``bfloat16``, ``float32``,
    ``int32``, ``uint32``, ..."""
    dt = getattr(x, "dtype", x)
    meta = getattr(dt, "metadata", None)
    if meta and "logical" in meta:
        return meta["logical"]
    s = str(dt)
    return s[len("torch."):] if s.startswith("torch.") else s


def _to_f32(arr: np.ndarray) -> np.ndarray:
    if dtype_name(arr) == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
        return (bits << np.uint32(16)).view(np.float32)
    return np.asarray(arr).astype(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even float32 → bfloat16 bits (as ``BF16``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        >> np.uint32(16)
    r = np.where(np.isnan(x), np.uint32(0x7FC0), r)
    return r.astype(np.uint16).view(BF16)


def contig_u8(arr) -> np.ndarray:
    """Flat C-contiguous uint8 view of ``arr`` — zero-copy when the array
    already is contiguous (the snapshot path's host arrays are)."""
    a = np.ascontiguousarray(arr)
    return a.reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# byteplane pre-conditioning — the numpy oracle
# ---------------------------------------------------------------------------

def byteplane_forward(data, itemsize: int) -> np.ndarray:
    """Byte-plane transpose + per-plane delta (mod 256) of a byte stream
    of ``itemsize``-byte elements. Size-preserving and lossless: plane p
    of the output holds ``x[j][p] - x[j-1][p]`` for every element j (the
    first element passes through), and any ragged tail (``len % itemsize``
    bytes) is appended untransformed. THE oracle the jnp/Pallas device
    backends are property-tested against — it defines the transformed
    stream that chunking, dedup and the manifest crc all operate on."""
    u8 = data if isinstance(data, np.ndarray) \
        else np.frombuffer(data, np.uint8)
    u8 = u8.reshape(-1).view(np.uint8)
    k = int(itemsize)
    if k <= 0:
        raise ValueError(f"itemsize must be positive, got {itemsize}")
    n = u8.size
    ne = n // k
    out = np.empty(n, np.uint8)
    if ne:
        x = u8[:ne * k].reshape(ne, k)
        d = out[:ne * k].reshape(k, ne)
        d[:, :] = x.T
        d[:, 1:] -= x[:-1].T           # uint8 wraparound is the modulus
    out[ne * k:] = u8[ne * k:]
    return out


def byteplane_inverse(data, itemsize: int) -> np.ndarray:
    """Exact inverse of ``byteplane_forward``: per-plane cumulative sum
    mod 256, then transpose back to element order."""
    u8 = data if isinstance(data, np.ndarray) \
        else np.frombuffer(data, np.uint8)
    u8 = u8.reshape(-1).view(np.uint8)
    k = int(itemsize)
    if k <= 0:
        raise ValueError(f"itemsize must be positive, got {itemsize}")
    n = u8.size
    ne = n // k
    out = np.empty(n, np.uint8)
    if ne:
        d = u8[:ne * k].reshape(k, ne)
        x = np.cumsum(d, axis=1, dtype=np.uint8)   # wraps mod 256
        out[:ne * k].reshape(ne, k)[:, :] = x.T
    out[ne * k:] = u8[ne * k:]
    return out


def byteplane_meta(arr: np.ndarray) -> dict:
    """The self-describing meta a byteplane payload carries: the element
    width the inverse transform needs (ONE source of truth — the host
    encoder and the fused device path must agree)."""
    return {"bp": int(arr.dtype.itemsize)}


# ---------------------------------------------------------------------------
# plane-aware entropy stage (byteplane-rle / byteplane-rans) — numpy oracle
# ---------------------------------------------------------------------------
# The transformed stream is encoded in ENTROPY_BLOCK-byte blocks. Each block
# is framed [flag u8][enc_len u16le][enc_len bytes] where flag is:
#   0 = raw escape (incompressible — mantissa planes pass through untouched)
#   1 = RLE: greedy maximal runs as (run_len u8 ∈ 1..255, value u8) pairs
#   2 = rANS: order-0, 12-bit quantized freqs, 16 interleaved lanes
# A smaller representation is chosen only when STRICTLY smaller (raw < rle
# < rans on ties), so the encoder is deterministic and a pure function of
# the block bytes — identical chunks still produce identical objects.
#
# rANS block body layout:
#   [nsyms-1 u8][sym u8 ×nsyms ascending][freq u16le ×nsyms]
#   [state u32le ×16][lane_len u16le ×16][lane0 bytes … lane15 bytes]
# Lane j owns symbols at indices j, j+16, j+32, … of the block; encode
# walks symbols in reverse, byte-renormalizing against RANS_L, and each
# lane's byte stream is serialized in DECODE consumption order.

def _rle_emissions(u8: np.ndarray, nb: int):
    """Vectorized greedy RLE over a whole stream, runs cut at every
    ENTROPY_BLOCK boundary. Returns (pair_buf [nb, 2·B] u8 zero-padded,
    rle_lens [nb] encoded byte counts)."""
    B = ENTROPY_BLOCK
    n = u8.size
    idx = np.arange(n, dtype=np.int64)
    change = np.empty(n, bool)
    change[0] = True
    if n > 1:
        change[1:] = u8[1:] != u8[:-1]
    change[::B] = True                       # runs never span blocks
    seg_start = np.maximum.accumulate(np.where(change, idx, 0))
    pos = idx - seg_start                    # 0-based position inside run
    end = np.empty(n, bool)
    if n > 1:
        end[:-1] = change[1:]
    end[-1] = True
    end[B - 1::B] = True                     # block boundary ends the run
    emit = end | (pos % 255 == 254)          # cap runs at 255
    e = np.flatnonzero(emit)
    blk = e // B
    npairs = np.bincount(blk, minlength=nb)
    starts = np.concatenate([[0], np.cumsum(npairs)])[:-1]
    rank = np.arange(e.size) - starts[blk]
    buf = np.zeros((nb, 2 * B), np.uint8)
    buf[blk, 2 * rank] = (pos[e] % 255 + 1).astype(np.uint8)
    buf[blk, 2 * rank + 1] = u8[e]
    return buf, 2 * npairs


def _rans_quantize(counts: np.ndarray, blens: np.ndarray):
    """Deterministic 12-bit frequency quantization, vectorized across
    blocks: f = max(1, c·4096 // n) for present symbols, the residual is
    absorbed by the first most-frequent symbol; blocks where that would
    drop it below 1 are rANS-ineligible."""
    nb = counts.shape[0]
    T = 1 << RANS_PROB_BITS
    nz = counts > 0
    f = np.where(
        nz, np.maximum(1, (counts * T) // np.maximum(blens[:, None], 1)), 0)
    imax = np.argmax(counts, axis=1)         # first occurrence on ties
    rows = np.arange(nb)
    f[rows, imax] += T - f.sum(axis=1)
    eligible = f[rows, imax] >= 1
    cum = np.cumsum(f, axis=1) - f           # exclusive per-symbol base
    return f, cum, nz.sum(axis=1), eligible


def _rans_encode_blocks(blkmat: np.ndarray, blens: np.ndarray,
                        f: np.ndarray, cum: np.ndarray):
    """Lane-interleaved rANS encode of every block at once. Returns
    (lane_buf [nb, 16, _LANE_MAX] u8 in decode order, lane_len [nb, 16],
    states [nb, 16] u32)."""
    nb = blkmat.shape[0]
    L, S = RANS_LANES, _RANS_STEPS
    sym = blkmat.reshape(nb, S, L).astype(np.int64)
    valid = (np.arange(ENTROPY_BLOCK).reshape(S, L)[None]
             < blens[:, None, None])
    rows = np.arange(nb)[:, None]
    x = np.full((nb, L), RANS_L, np.uint32)
    out_b = np.zeros((S, nb, L, 2), np.uint8)
    out_v = np.zeros((S, nb, L, 2), bool)
    for t in range(S - 1, -1, -1):
        s = sym[:, t, :]
        v = valid[:, t, :]
        fv = np.where(v, f[rows, s], 1).astype(np.uint32)
        cv = np.where(v, cum[rows, s], 0).astype(np.uint32)
        x_max = fv << np.uint32(8 + 23 - RANS_PROB_BITS)   # = ((L>>12)<<8)·f
        e0 = v & (x >= x_max)
        out_b[t, :, :, 0] = (x & 0xFF).astype(np.uint8)
        out_v[t, :, :, 0] = e0
        x = np.where(e0, x >> np.uint32(8), x)
        e1 = v & (x >= x_max)
        out_b[t, :, :, 1] = (x & 0xFF).astype(np.uint8)
        out_v[t, :, :, 1] = e1
        x = np.where(e1, x >> np.uint32(8), x)
        xe = ((x // fv) << np.uint32(RANS_PROB_BITS)) + (x % fv) + cv
        x = np.where(v, xe, x)
    # decode consumes the emission sequence reversed: steps ascending,
    # within a step the second byte before the first
    db = out_b[:, :, :, ::-1].transpose(1, 2, 0, 3).reshape(nb, L, 2 * S)
    dv = out_v[:, :, :, ::-1].transpose(1, 2, 0, 3).reshape(nb, L, 2 * S)
    lane_len = dv.sum(axis=-1).astype(np.int64)
    lane_buf = np.zeros((nb, L, _LANE_MAX), np.uint8)
    pos = np.cumsum(dv, axis=-1) - 1
    i, j, _ = np.nonzero(dv)
    lane_buf[i, j, pos[dv]] = db[dv]
    return lane_buf, lane_len, x


def _rans_serialize(f, nsyms, lane_buf, lane_len, states):
    """Pack rANS block bodies into a padded matrix [nb, W] + lengths."""
    nb = f.shape[0]
    L = RANS_LANES
    W = 1 + 3 * 256 + _RANS_FIXED - 1 + L * _LANE_MAX
    data = np.zeros((nb, W), np.uint8)
    rows = np.arange(nb)
    data[:, 0] = ((nsyms - 1) & 0xFF).astype(np.uint8)
    r_idx, s_idx = np.nonzero(f > 0)
    starts = np.concatenate([[0], np.cumsum(nsyms)])[:-1]
    rank = np.arange(r_idx.size) - starts[r_idx]
    data[r_idx, 1 + rank] = s_idx.astype(np.uint8)
    fo = 1 + nsyms[r_idx]
    fv = f[r_idx, s_idx].astype(np.int64)
    data[r_idx, fo + 2 * rank] = (fv & 0xFF).astype(np.uint8)
    data[r_idx, fo + 2 * rank + 1] = (fv >> 8).astype(np.uint8)
    o_states = 1 + 3 * nsyms                          # [nb]
    st = states.astype(np.uint32)
    for b in range(4):
        cols = o_states[:, None] + 4 * np.arange(L) + b
        data[rows[:, None], cols] = \
            ((st >> np.uint32(8 * b)) & 0xFF).astype(np.uint8)
    o_lens = o_states + 4 * L
    cols = o_lens[:, None] + 2 * np.arange(L)
    data[rows[:, None], cols] = (lane_len & 0xFF).astype(np.uint8)
    data[rows[:, None], cols + 1] = (lane_len >> 8).astype(np.uint8)
    o_bytes = o_lens + 2 * L                          # [nb]
    lane_off = np.cumsum(lane_len, axis=1) - lane_len  # [nb, L]
    i, j, k = np.nonzero(np.arange(_LANE_MAX)[None, None, :]
                         < lane_len[:, :, None])
    data[i, o_bytes[i] + lane_off[i, j] + k] = lane_buf[i, j, k]
    rans_lens = o_bytes + lane_len.sum(axis=1)
    return data, rans_lens


def entropy_encode_blocks(u8: np.ndarray, codec: str):
    """Oracle block encoder for a whole (sub)stream: returns
    (flags [nb], dlens [nb], padded [nb, ·] u8) where row b's first
    dlens[b] bytes are block b's encoded body. Pure numpy; the jnp/Pallas
    backends in ``kernels.ckpt_codec.entropy`` must match byte-for-byte."""
    if codec not in CHUNK_ENCODED:
        raise ValueError(f"codec {codec!r} has no entropy stage")
    B = ENTROPY_BLOCK
    n = u8.size
    nb = -(-n // B)
    if nb == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                np.zeros((0, B), np.uint8))
    pad = nb * B - n
    blkmat = np.concatenate([u8, np.zeros(pad, np.uint8)]).reshape(nb, B)
    blens = np.full(nb, B, np.int64)
    blens[-1] = n - (nb - 1) * B
    rle_buf, rle_lens = _rle_emissions(u8, nb)
    flags = np.zeros(nb, np.uint8)
    dlens = blens.copy()
    use_rle = rle_lens < dlens
    flags[use_rle] = 1
    dlens[use_rle] = rle_lens[use_rle]
    if codec == "byteplane-rans":
        valid = np.arange(B)[None, :] < blens[:, None]
        counts = np.bincount(
            (blkmat.astype(np.int64) + 256 * np.arange(nb)[:, None])[valid],
            minlength=256 * nb).reshape(nb, 256)
        f, cum, nsyms, eligible = _rans_quantize(counts, blens)
        lane_buf, lane_len, states = \
            _rans_encode_blocks(blkmat, blens, f, cum)
        rans_data, rans_lens = \
            _rans_serialize(f, nsyms, lane_buf, lane_len, states)
        use_rans = eligible & (rans_lens < dlens)
        flags[use_rans] = 2
        dlens[use_rans] = rans_lens[use_rans]
    padded = np.zeros((nb, B), np.uint8)
    raw_rows = flags == 0
    padded[raw_rows] = blkmat[raw_rows]
    rle_rows = flags == 1
    padded[rle_rows] = rle_buf[rle_rows, :B]
    if codec == "byteplane-rans":
        rans_rows = flags == 2
        padded[rans_rows] = rans_data[rans_rows, :B]
    keep = np.arange(B)[None, :] < dlens[:, None]
    padded[~keep] = 0                        # deterministic padding
    return flags, dlens, padded


def assemble_block_stream(flags, dlens, padded):
    """Serialize (flags, dlens, padded) into the framed block stream.
    Shared by every backend — the device paths return the same triple.
    Returns (stream np.uint8, block_lens [nb] incl. 3-byte headers)."""
    flags = np.asarray(flags, np.uint8)
    dlens = np.asarray(dlens, np.int64)
    padded = np.asarray(padded, np.uint8)
    nb = flags.size
    block_lens = 3 + dlens
    offs = np.cumsum(block_lens) - block_lens
    out = np.zeros(int(block_lens.sum()), np.uint8)
    out[offs] = flags
    out[offs + 1] = (dlens & 0xFF).astype(np.uint8)
    out[offs + 2] = (dlens >> 8).astype(np.uint8)
    total = int(dlens.sum())
    if total:
        blk = np.repeat(np.arange(nb), dlens)
        rank = np.arange(total) - np.repeat(np.cumsum(dlens) - dlens, dlens)
        out[offs[blk] + 3 + rank] = padded[blk, rank]
    return out, block_lens


def plane_stream_encode(u8, codec: str):
    """Encode a transformed stream (or one chunk of it — the format is
    position-independent) with the plane entropy stage. Returns
    (stream np.uint8, block_lens)."""
    u8 = u8 if isinstance(u8, np.ndarray) else np.frombuffer(u8, np.uint8)
    u8 = u8.reshape(-1).view(np.uint8)
    return assemble_block_stream(*entropy_encode_blocks(u8, codec))


def plane_encode_chunk(chunk, codec: str) -> bytes:
    """Per-chunk entropy encode — blocks are framed relative to the chunk
    start, so the result is a pure function of the chunk bytes (dedup-
    stable) and, when chunks are ENTROPY_BLOCK-aligned, concatenating the
    per-chunk encodings equals encoding the whole stream once (what the
    fused device dispatch produces)."""
    return plane_stream_encode(chunk, codec)[0].tobytes()


def _rans_decode_group(bodies, raw_lens, payload):
    """Vectorized rANS decode of a group of blocks: ``bodies`` is a list of
    (offset, enc_len) into ``payload``; returns list of np.uint8 arrays."""
    m = len(bodies)
    L, S = RANS_LANES, _RANS_STEPS
    f_rows, sym_rows, lane_mats, lane_lens, states = [], [], [], [], []
    for off, elen in bodies:
        body = payload[off:off + elen]
        ns = int(body[0]) + 1
        syms = body[1:1 + ns].astype(np.int64)
        freqs = body[1 + ns:1 + 3 * ns].view(np.uint8)
        freqs = (freqs[0::2].astype(np.int64)
                 | (freqs[1::2].astype(np.int64) << 8))
        p = 1 + 3 * ns
        st = body[p:p + 4 * L].reshape(L, 4).astype(np.uint32)
        states.append(st[:, 0] | (st[:, 1] << np.uint32(8))
                      | (st[:, 2] << np.uint32(16))
                      | (st[:, 3] << np.uint32(24)))
        p += 4 * L
        ll = body[p:p + 2 * L].reshape(L, 2).astype(np.int64)
        ll = ll[:, 0] | (ll[:, 1] << 8)
        p += 2 * L
        mat = np.zeros((L, _LANE_MAX), np.uint8)
        for j in range(L):
            mat[j, :ll[j]] = body[p:p + ll[j]]
            p += int(ll[j])
        lane_mats.append(mat)
        lane_lens.append(ll)
        fr = np.zeros(256, np.int64)
        fr[syms] = freqs
        f_rows.append(fr)
        sym_rows.append(np.repeat(syms, freqs))   # slot → symbol LUT
    f_full = np.stack(f_rows)
    cum_full = np.cumsum(f_full, axis=1) - f_full
    lut = np.stack(sym_rows)                      # [m, 4096]
    lanes = np.stack(lane_mats)                   # [m, L, _LANE_MAX]
    llen = np.stack(lane_lens)                    # [m, L]
    x = np.stack(states)                          # [m, L] u32
    ptr = np.zeros((m, L), np.int64)
    rows = np.arange(m)[:, None]
    cols = np.arange(L)[None, :]
    mask = np.uint32((1 << RANS_PROB_BITS) - 1)
    out = np.zeros((m, S, L), np.uint8)
    nsteps = (np.asarray(raw_lens)[:, None]
              - cols + L - 1) // L                # symbols per lane
    for t in range(S):
        act = t < nsteps
        slot = x & mask
        s = lut[rows, slot.astype(np.int64)]
        fv = f_full[rows, s].astype(np.uint32)
        cv = cum_full[rows, s].astype(np.uint32)
        x = np.where(act,
                     fv * (x >> np.uint32(RANS_PROB_BITS)) + slot - cv, x)
        for _ in range(2):                        # byte renorm, ≤2 reads
            need = act & (x < np.uint32(RANS_L)) & (ptr < llen)
            b = lanes[rows, cols, np.minimum(ptr, _LANE_MAX - 1)]
            x = np.where(need, (x << np.uint32(8)) | b, x)
            ptr = np.where(need, ptr + 1, ptr)
        out[:, t, :] = np.where(act, s, 0).astype(np.uint8)
    flat = out.reshape(m, ENTROPY_BLOCK)
    return [flat[i, :raw_lens[i]] for i in range(m)]


def plane_stream_decode(enc, raw_len: int, codec: str) -> np.ndarray:
    """Decode a framed block stream back to ``raw_len`` transformed bytes.
    Works on a whole-payload stream or a single chunk's encoding (same
    format). Raises ValueError on malformed framing."""
    if codec not in CHUNK_ENCODED:
        raise ValueError(f"codec {codec!r} has no entropy stage")
    payload = enc if isinstance(enc, np.ndarray) \
        else np.frombuffer(enc, np.uint8)
    payload = payload.reshape(-1).view(np.uint8)
    out = np.empty(raw_len, np.uint8)
    pos = 0
    done = 0
    rans_jobs, rans_dst = [], []
    while done < raw_len:
        if pos + 3 > payload.size:
            raise ValueError("entropy stream truncated (header)")
        flag = int(payload[pos])
        elen = int(payload[pos + 1]) | (int(payload[pos + 2]) << 8)
        pos += 3
        blen = min(ENTROPY_BLOCK, raw_len - done)
        if pos + elen > payload.size:
            raise ValueError("entropy stream truncated (body)")
        if flag == 0:
            if elen != blen:
                raise ValueError("raw block length mismatch")
            out[done:done + blen] = payload[pos:pos + elen]
        elif flag == 1:
            pairs = payload[pos:pos + elen]
            runs = pairs[0::2].astype(np.int64)
            vals = pairs[1::2]
            dec = np.repeat(vals, runs)
            if dec.size != blen:
                raise ValueError("rle block length mismatch")
            out[done:done + blen] = dec
        elif flag == 2:
            rans_jobs.append(((pos, elen), blen))
            rans_dst.append(done)
        else:
            raise ValueError(f"unknown entropy block flag {flag}")
        pos += elen
        done += blen
    if pos != payload.size:
        raise ValueError("entropy stream has trailing bytes")
    if rans_jobs:
        decs = _rans_decode_group([j[0] for j in rans_jobs],
                                  [j[1] for j in rans_jobs], payload)
        for dst, dec in zip(rans_dst, decs):
            out[dst:dst + dec.size] = dec
    return out


def plane_decode_chunks(payload, enc_lens, raw_lens, codec: str) -> np.ndarray:
    """Decode a concatenation of per-chunk encodings (the CAS payload a
    v7 manifest describes) back into the transformed stream."""
    u8 = payload if isinstance(payload, np.ndarray) \
        else np.frombuffer(payload, np.uint8)
    u8 = u8.reshape(-1).view(np.uint8)
    out = np.empty(int(sum(raw_lens)), np.uint8)
    eoff = roff = 0
    for elen, rlen in zip(enc_lens, raw_lens):
        out[roff:roff + rlen] = \
            plane_stream_decode(u8[eoff:eoff + elen], int(rlen), codec)
        eoff += int(elen)
        roff += int(rlen)
    if eoff != u8.size:
        raise ValueError("chunk-encoded payload has trailing bytes")
    return out


def entropy_block_stats(enc, raw_len: int):
    """Parse a framed block stream's headers WITHOUT decoding: yields
    (abs_offset, blen, flag, enc_len) per block — inspect_ckpt maps these
    onto byte planes for the per-plane report."""
    payload = enc if isinstance(enc, np.ndarray) \
        else np.frombuffer(enc, np.uint8)
    payload = payload.reshape(-1).view(np.uint8)
    pos = done = 0
    while done < raw_len:
        if pos + 3 > payload.size:
            raise ValueError("entropy stream truncated (header)")
        flag = int(payload[pos])
        elen = int(payload[pos + 1]) | (int(payload[pos + 2]) << 8)
        blen = min(ENTROPY_BLOCK, raw_len - done)
        yield done, blen, flag, elen
        pos += 3 + elen
        done += blen


def encode_preconditioned(transformed, codec: str):
    """Host stage of the device pre-conditioning pipeline: ``transformed``
    is the byteplane stream the device round-trip returned; this applies
    whatever entropy stage the codec adds. Byte-identical to
    ``encode(arr, codec)`` on the same array — property-tested.

    Chunk-encoded codecs return the stream UNCHANGED here: their entropy
    stage runs per chunk (after boundaries are cut on the transformed
    bytes), via ``plane_encode_chunk`` or the fused device dispatch."""
    if codec == "byteplane":
        return transformed
    if codec == "byteplane-zstd":
        return _zc().compress(transformed)
    if codec in CHUNK_ENCODED:
        return transformed
    raise ValueError(f"codec {codec!r} is not a preconditioned codec")


class Quantized:
    """An int8-coded leaf between its stages: ``q`` (int8, the element
    count rounded up to a BLOCK multiple), the f32 block ``scales``, the
    element count ``n``, and the logical ``dtype`` (numpy, bf16 as
    ``BF16``) and ``shape`` of the leaf it encodes. The snapshot's K5 route
    hands one to ``encode`` in place of the host array (``dtype``/``shape``
    /``nbytes`` describe what the snapshot pins); the restore's device
    route hands one to K6. ``decode`` is the host oracle's finish."""

    def __init__(self, q, scales, n: int, dtype, shape):
        self.q = np.asarray(q).reshape(-1).view(np.int8)
        self.scales = np.asarray(scales, np.float32).reshape(-1)
        self.n = int(n)
        self.dtype = _np_dtype(dtype_name(dtype))
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scales.nbytes

    def decode(self) -> np.ndarray:
        x = dequantize_int8(self.q, self.scales, self.n)
        if dtype_name(self.dtype) == "bfloat16":
            return _f32_to_bf16(x).reshape(self.shape)
        return x.astype(self.dtype, copy=False).reshape(self.shape)


def quantized_nbytes(n: int) -> int:
    """Bytes of a ``Quantized`` of `n` elements (q + scales): what the K5
    snapshot route pins for a leaf instead of its raw bytes."""
    nb = -(-int(n) // BLOCK)
    return nb * BLOCK + nb * 4


class Planes:
    """A byteplane-coded leaf after its entropy and zstd stages: the
    transformed ``stream`` (uint8), the element width ``k`` of the inverse,
    and the leaf's logical ``dtype`` and ``shape``. ``decode`` is the host
    inverse (the oracle); the restore's device route runs K4 on the
    stream instead."""

    def __init__(self, stream, k: int, dtype, shape):
        self.stream = stream if isinstance(stream, np.ndarray) \
            else np.frombuffer(stream, np.uint8)
        self.k = int(k)
        self.dtype = _np_dtype(dtype_name(dtype))
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return self.stream.nbytes

    def decode(self) -> np.ndarray:
        raw = byteplane_inverse(self.stream, self.k)
        return raw.view(self.dtype).reshape(self.shape)


def encode(arr, codec: str) -> tuple:
    """Returns (payload_bytes, meta_dict). For ``int8``, `arr` may be a
    ``Quantized`` (quantized on the device): the same payload and meta as
    quantizing the host array here."""
    if codec == "raw":
        return arr.tobytes(), {}
    if codec == "zstd":
        # compress straight from a C-contiguous view (zstandard accepts
        # the buffer protocol) — the old .tobytes() duplicated every
        # payload before the compressor even saw it
        return _zc().compress(contig_u8(arr)), {}
    if codec == "byteplane":
        t = byteplane_forward(contig_u8(arr), arr.dtype.itemsize)
        return t.tobytes(), byteplane_meta(arr)
    if codec == "byteplane-zstd":
        t = byteplane_forward(contig_u8(arr), arr.dtype.itemsize)
        return _zc().compress(t), byteplane_meta(arr)
    if codec in CHUNK_ENCODED:
        t = byteplane_forward(contig_u8(arr), arr.dtype.itemsize)
        return plane_stream_encode(t, codec)[0].tobytes(), byteplane_meta(arr)
    if codec == "int8":
        if isinstance(arr, Quantized):
            q, scales, n = arr.q, arr.scales, arr.n
        else:
            (q, scales), n = quantize_int8(arr), arr.size
        blob = q.tobytes() + scales.tobytes()
        meta = {"q_bytes": q.nbytes, "s_bytes": scales.nbytes, "n": n}
        if HAVE_ZSTD:
            return _zc().compress(blob), meta
        return blob, dict(meta, z=0)   # uncompressed, self-describing
    raise ValueError(f"unknown codec {codec!r}")


STAGED = PRECONDITIONED + ("int8",)   # codecs with a last transform


def decode_stages(payload: bytes, codec: str, shape, dtype, meta: dict):
    """The host stages of ``decode`` before its last transform, for the
    codecs in ``STAGED``: a ``Planes`` (byteplane codecs: the stream after
    the entropy/zstd stage) or a ``Quantized`` (int8: q and the scales).
    Their ``decode()`` is the rest of ``decode``; the restore's device route
    runs K4/K6 on them instead."""
    dtype = np.dtype(dtype) if not str(dtype).startswith("bfloat") else dtype
    if codec in PRECONDITIONED:
        k = int(meta.get("bp") or _np_dtype(dtype).itemsize)
        if codec in CHUNK_ENCODED:
            raw_len = int(np.prod(shape, dtype=np.int64)) \
                * _np_dtype(dtype).itemsize
            u8 = plane_stream_decode(payload, raw_len, codec)
        elif codec == "byteplane":
            u8 = payload
        else:
            u8 = _zd().decompress(payload)
        return Planes(u8, k, dtype, shape)
    if codec == "int8":
        raw = payload if not meta.get("z", 1) else _zd().decompress(payload)
        q = np.frombuffer(raw[:meta["q_bytes"]], np.int8)
        scales = np.frombuffer(raw[meta["q_bytes"]:], np.float32)
        return Quantized(q, scales, meta["n"], dtype, shape)
    raise ValueError(f"codec {codec!r} has no staged decode")


def decode(payload: bytes, codec: str, shape, dtype, meta: dict) -> np.ndarray:
    dtype = np.dtype(dtype) if not str(dtype).startswith("bfloat") else dtype
    if codec == "raw":
        return np.frombuffer(payload, dtype=_np_dtype(dtype)).reshape(shape)
    if codec == "zstd":
        raw = _zd().decompress(payload)
        return np.frombuffer(raw, dtype=_np_dtype(dtype)).reshape(shape)
    if codec in STAGED:
        return decode_stages(payload, codec, shape, dtype, meta).decode()
    raise ValueError(f"unknown codec {codec!r}")


def _np_dtype(dtype):
    s = str(dtype)
    if s == "bfloat16":
        return BF16
    return np.dtype(s)


def quantize_int8(arr: np.ndarray) -> tuple:
    """Symmetric per-block int8 quantization over the flattened array.

    Matches repro.kernels.ckpt_codec (the Pallas TPU kernel oracle):
      scale_b = max(|x_b|) / 127 ;  q = round(x / scale) clipped to ±127.
    """
    x = _to_f32(arr).reshape(-1)
    n = x.size
    pad = (-n) % BLOCK
    if pad:
        x = np.concatenate([x, np.zeros(pad, np.float32)])
    xb = x.reshape(-1, BLOCK)
    amax = np.abs(xb).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(xb / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1)[: n + pad], scale


def dequantize_int8(q: np.ndarray, scales: np.ndarray, n: int) -> np.ndarray:
    xb = q.reshape(-1, BLOCK).astype(np.float32) * scales[:, None]
    return xb.reshape(-1)[:n]


def lossy(codec: str) -> bool:
    return codec == "int8"
