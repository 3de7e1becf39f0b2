"""Device-side plane entropy stage (``byteplane-rle``, ``byteplane-rans``).

The numpy oracle and the framing live in ``core.codec``
(``entropy_encode_blocks`` + ``assemble_block_stream``); every path here
produces byte-identical streams. The transformed stream is encoded in
4 KiB plane blocks: a per-block RLE emission pass, then glue that compacts
(run, value) pairs, picks raw or RLE per block, and assembles the framed
``[flag][len u16][body]`` stream — all on the device, so the host receives
the encoded stream plus per-block lengths.

  rle_emission        wrapper of the hand-written CUDA kernel
                      ``csrc/rle_emit.cu`` (K3; replaces the Pallas
                      ``_rle_emission_pallas``). CUDA tensor → the kernel
                      (or an error); CPU tensor → the plain version;
  rle_emission_plain  the plain PyTorch version (the CPU tests' path and
                      the kernel's yardstick in ``chip_smoke.py``);
  encode              the glue (the JAX package's ``_encode_expr``, which
                      runs outside any Pallas kernel there too) as PyTorch
                      ops on the tensor's device, with either emitter.

``byteplane-rans`` adds ``_rans_stage`` (the JAX package's, which is jnp
outside any Pallas kernel there too): histogram, 12-bit frequency
quantization, the 16-lane interleaved rANS scan as a Python loop over the
256 symbol steps vectorized over blocks and lanes, and serialization — as
PyTorch ops on the tensor's device. Lane states are int64 masked to 32
bits (PyTorch has no wrapping uint32 add).
"""
from __future__ import annotations

import threading

import numpy as np

from ...core.codec import (ENTROPY_BLOCK, RANS_L, RANS_LANES,
                           RANS_PROB_BITS, _LANE_MAX, _RANS_STEPS)
from .. import build

B = ENTROPY_BLOCK
L = RANS_LANES
S = _RANS_STEPS
_RANS_W = 1 + 3 * 256 + 4 * L + 2 * L + L * _LANE_MAX
RANS_BATCH = 4096       # blocks per rANS pass: bounds the (nb, 16, 512)
                        # temporaries at a few hundred MB
ENCODE_BATCH = 16384    # blocks a pass of the glue (64 MiB of stream)
PORTED_CODECS = ("byteplane-rle", "byteplane-rans")

launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# RLE emission pass
# ---------------------------------------------------------------------------
# Emission semantics (== oracle ``_rle_emissions``): greedy runs cut at
# every block boundary and capped at 255; position i emits a (run_len,
# value) pair iff the run ends at i or the cap is hit.

def rle_emission_plain(blkmat, n: int):
    """Plain PyTorch emitter over the zero-padded [nb, B] block matrix of
    an n-byte stream. Returns (emit bool [nb, B], run uint8 [nb, B])."""
    import torch
    nb = blkmat.shape[0]
    dev = blkmat.device
    idx = torch.arange(B, dtype=torch.int32, device=dev).expand(nb, B)
    change = torch.ones((nb, B), dtype=torch.bool, device=dev)
    change[:, 1:] = blkmat[:, 1:] != blkmat[:, :-1]
    end = torch.ones((nb, B), dtype=torch.bool, device=dev)
    end[:, :-1] = change[:, 1:]
    last = (n - 1 - B * torch.arange(nb, dtype=torch.int64, device=dev))
    end |= idx == last[:, None]          # partial last block ends its run
    seg_start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    pos = idx - seg_start
    emit = end | (pos % 255 == 254)
    run = (pos % 255 + 1).to(torch.uint8)
    return emit, run


def rle_emission(blkmat, n: int):
    """Emitter over the [nb, B] block matrix. CUDA tensor → the K3 kernel
    on the current stream; CPU tensor → ``rle_emission_plain``."""
    import torch
    if blkmat.dtype != torch.uint8 or blkmat.dim() != 2 \
            or blkmat.shape[1] != B:
        raise TypeError(f"expected a uint8 [nb, {B}] block matrix, got "
                        f"{blkmat.dtype} {tuple(blkmat.shape)}")
    if not blkmat.is_cuda:
        return rle_emission_plain(blkmat, n)
    if not blkmat.is_contiguous() or blkmat.data_ptr() % 16:
        raise ValueError("RLE kernel needs a contiguous, 16-byte aligned "
                         "block matrix")
    nb = blkmat.shape[0]
    emit = torch.empty((nb, B), dtype=torch.bool, device=blkmat.device)
    run = torch.empty((nb, B), dtype=torch.uint8, device=blkmat.device)
    if nb == 0:
        return emit, run
    build.launch("rle_emit", blkmat, blkmat.data_ptr(), emit.data_ptr(),
                 run.data_ptr(), nb, int(n))
    global launches
    with _count_lock:
        launches += 1
    return emit, run


# ---------------------------------------------------------------------------
# glue: pair compaction, block choice, framed stream
# ---------------------------------------------------------------------------

def _rans_stage(blkmat, valid):
    """Histogram → quantize → lane-interleaved rANS scan → serialize over
    the [nb, B] block matrix (== the JAX package's ``_rans_stage``, and the
    oracle's ``_rans_quantize``/``_rans_encode_blocks``/``_rans_serialize``).
    Returns (rans_data u8 [nb, _RANS_W], rans_lens i64 [nb], eligible)."""
    import torch
    nb = blkmat.shape[0]
    dev = blkmat.device
    rows = torch.arange(nb, device=dev)
    sym = blkmat.long()
    blens = valid.sum(dim=1)
    counts = torch.zeros((nb, 256), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sym, valid.long())
    T = 1 << RANS_PROB_BITS
    nz = counts > 0
    f = torch.where(nz, torch.clamp(
        (counts * T) // torch.clamp(blens[:, None], min=1), min=1), 0)
    imax = torch.argmax(counts, dim=1)            # first max, as jnp.argmax
    f[rows, imax] += T - f.sum(dim=1)
    eligible = f[rows, imax] >= 1
    nsyms = nz.sum(dim=1)
    cum = torch.cumsum(f, dim=1) - f
    # encode: steps S-1 … 0, carry = 16 lane states (int64, < 2^32)
    fs = torch.gather(f, 1, sym).view(nb, S, L)
    cs = torch.gather(cum, 1, sym).view(nb, S, L)
    vs = valid.view(nb, S, L)
    x = torch.full((nb, L), RANS_L, dtype=torch.int64, device=dev)
    b0 = torch.empty((S, nb, L), dtype=torch.uint8, device=dev)
    b1 = torch.empty_like(b0)
    e0 = torch.empty((S, nb, L), dtype=torch.bool, device=dev)
    e1 = torch.empty_like(e0)
    for t in range(S - 1, -1, -1):
        v = vs[:, t]
        fv = torch.where(v, fs[:, t], 1)
        cv = torch.where(v, cs[:, t], 0)
        x_max = fv << (8 + 23 - RANS_PROB_BITS)
        e0[t] = v & (x >= x_max)
        b0[t] = (x & 0xFF).to(torch.uint8)
        x = torch.where(e0[t], x >> 8, x)
        e1[t] = v & (x >= x_max)
        b1[t] = (x & 0xFF).to(torch.uint8)
        x = torch.where(e1[t], x >> 8, x)
        xe = (((x // fv) << RANS_PROB_BITS) + x % fv + cv) & 0xFFFFFFFF
        x = torch.where(v, xe, x)
    # decode order: steps ascending, the second byte before the first
    db = torch.stack([b1, b0], dim=-1).permute(1, 2, 0, 3) \
        .reshape(nb, L, 2 * S)
    dv = torch.stack([e1, e0], dim=-1).permute(1, 2, 0, 3) \
        .reshape(nb, L, 2 * S)
    lane_len = dv.sum(dim=-1)                                  # [nb, L]
    pos = torch.cumsum(dv, dim=-1, dtype=torch.int32) - 1
    lane_buf = torch.zeros((nb, L, _LANE_MAX + 1), dtype=torch.uint8,
                           device=dev)
    lane_buf.scatter_(2, torch.where(dv, pos, _LANE_MAX).long(), db)
    lane_buf = lane_buf[:, :, :_LANE_MAX]
    # serialize (== oracle _rans_serialize); column _RANS_W is the sink
    W = _RANS_W
    data = torch.zeros((nb, W + 1), dtype=torch.uint8, device=dev)
    data[:, 0] = ((nsyms - 1) & 0xFF).to(torch.uint8)
    rank = torch.cumsum(nz, dim=1) - 1
    scol = torch.arange(256, device=dev).expand(nb, 256)
    fo = (1 + nsyms)[:, None]
    for col, val in ((1 + rank, scol), (fo + 2 * rank, f & 0xFF),
                     (fo + 2 * rank + 1, f >> 8)):
        data.scatter_(1, torch.where(nz, col, W), val.to(torch.uint8))
    o_states = 1 + 3 * nsyms                                   # [nb]
    lanes = torch.arange(L, device=dev)
    for byte in range(4):
        data.scatter_(1, o_states[:, None] + 4 * lanes + byte,
                      ((x >> (8 * byte)) & 0xFF).to(torch.uint8))
    o_lens = o_states + 4 * L
    cols = o_lens[:, None] + 2 * lanes
    data.scatter_(1, cols, (lane_len & 0xFF).to(torch.uint8))
    data.scatter_(1, cols + 1, (lane_len >> 8).to(torch.uint8))
    o_bytes = o_lens + 2 * L
    lane_off = torch.cumsum(lane_len, dim=1) - lane_len
    kcol = torch.arange(_LANE_MAX, device=dev)
    dst = o_bytes[:, None, None] + lane_off[:, :, None] + kcol
    dst = torch.where(kcol < lane_len[:, :, None], dst, W)
    data.scatter_(1, dst.reshape(nb, -1), lane_buf.reshape(nb, -1))
    return data[:, :W], o_bytes + lane_len.sum(dim=1), eligible


def encode(t, codec: str, emitter=rle_emission):
    """Encode the transformed uint8 stream `t` (1-D tensor) on its device.
    Returns (flags u8 [nb], dlens i32 [nb], stream u8 [n + 3·nb],
    total i64 scalar): the framed stream is ``stream[:total]``. JAX's
    out-of-range ``mode="drop"`` scatters become writes into one extra
    sink slot that is sliced off. Every block's encoding is independent of
    the others', so the blocks go through the emitter and the glue
    ``ENCODE_BATCH`` at a time: the glue's per-byte int32/int64
    temporaries stay at a few GB whatever the payload (a 2.7 GB expert
    stack would need ~100 GB in one pass)."""
    import torch
    if codec not in PORTED_CODECS:
        raise NotImplementedError(
            f"device entropy stage for {codec!r} is not ported; "
            f"ported: {PORTED_CODECS}")
    dev = t.device
    n = t.shape[0]
    nb = -(-n // B)
    if nb == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.uint8, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    size = n + 3 * nb
    out = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    flags = torch.empty(nb, dtype=torch.uint8, device=dev)
    dlens = torch.empty(nb, dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, nb, ENCODE_BATCH):
        hi = min(lo + ENCODE_BATCH, nb)
        flags[lo:hi], dlens[lo:hi], used = _encode_blocks(
            t[lo * B:min(hi * B, n)], codec, emitter, out, total, size)
        total += used
    return flags, dlens, out[:size], total


def _encode_blocks(t, codec, emitter, out, base, size):
    """Encode the blocks of the stream slice `t` (whole blocks but for the
    stream's last) into `out` from offset `base` (an int64 device scalar);
    writes past the framed bytes go to the sink slot `size`. Returns
    (flags, dlens, bytes written)."""
    import torch
    dev = t.device
    n = t.shape[0]
    nb = -(-n // B)
    blkmat = torch.zeros(nb * B, dtype=torch.uint8, device=dev)
    blkmat[:n] = t
    blkmat = blkmat.view(nb, B)
    blens = torch.full((nb,), B, dtype=torch.int32, device=dev)
    blens[-1] = n - (nb - 1) * B
    colm = torch.arange(B, dtype=torch.int32, device=dev).expand(nb, B)
    valid = colm < blens[:, None]
    emit, run = emitter(blkmat, n)
    emit = emit & valid
    # pair compaction: chosen RLE rows always fit (2·npairs < blen ≤ B);
    # pairs of other rows that would spill past B go to the sink column
    rle_lens = 2 * emit.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(emit, dim=1, dtype=torch.int32) - 1
    c0 = 2 * rank
    sink = torch.full_like(c0, B)
    rle_buf = torch.zeros((nb, B + 1), dtype=torch.uint8, device=dev)
    rle_buf.scatter_(1, torch.where(emit & (c0 < B), c0, sink).long(), run)
    rle_buf.scatter_(1, torch.where(emit & (c0 + 1 < B), c0 + 1,
                                    sink).long(), blkmat)
    del rank, c0, sink, run
    use_rle = rle_lens < blens
    flags = use_rle.to(torch.uint8)
    dlens = torch.where(use_rle, rle_lens, blens)
    body = torch.where(use_rle[:, None], rle_buf[:, :B], blkmat)
    if codec == "byteplane-rans":
        for lo in range(0, nb, RANS_BATCH):
            hi = min(lo + RANS_BATCH, nb)
            data, rans_lens, eligible = _rans_stage(blkmat[lo:hi],
                                                    valid[lo:hi])
            use = eligible & (rans_lens < dlens[lo:hi])
            flags[lo:hi] = torch.where(use, 2, flags[lo:hi])
            dlens[lo:hi] = torch.where(use, rans_lens.to(torch.int32),
                                       dlens[lo:hi])
            body[lo:hi] = torch.where(use[:, None], data[:, :B],
                                      body[lo:hi])
    keep = colm < dlens[:, None]
    # framed-stream compaction (== oracle assemble_block_stream)
    block_lens = (3 + dlens).to(torch.int64)
    offs = base + torch.cumsum(block_lens, 0) - block_lens
    out[offs] = flags
    out[offs + 1] = (dlens & 0xFF).to(torch.uint8)
    out[offs + 2] = (dlens >> 8).to(torch.uint8)
    dst = torch.where(keep, offs[:, None] + 3 + colm, size)
    out.scatter_(0, dst.reshape(-1), body.reshape(-1))
    return flags, dlens, block_lens.sum()


def encode_stream(t_u8: np.ndarray, codec: str, device="cpu",
                  emitter=rle_emission):
    """Host-callable wrapper: encode a transformed host stream on `device`
    and return (stream np.uint8, block_lens np.int64) — the contract of the
    oracle's ``plane_stream_encode``. Used by tests and ``chip_smoke.py``."""
    import torch
    t = torch.from_numpy(np.array(t_u8, np.uint8).reshape(-1)).to(device)
    _, dlens, out, total = encode(t, codec, emitter)
    stream = out[:int(total)].cpu().numpy()
    return stream, 3 + dlens.cpu().numpy().astype(np.int64)
