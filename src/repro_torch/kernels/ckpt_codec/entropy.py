"""Device-side plane entropy stage (``byteplane-rle``).

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

``byteplane-rans`` needs its own kernel for the lane-interleaved rANS scan
and is not ported yet: asking for it here raises.
"""
from __future__ import annotations

import threading

import numpy as np

from ...core.codec import ENTROPY_BLOCK
from .. import build

B = ENTROPY_BLOCK
PORTED_CODECS = ("byteplane-rle",)

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

def encode(t, codec: str, emitter=rle_emission):
    """Encode the transformed uint8 stream `t` (1-D tensor) on its device.
    Returns (flags u8 [nb], dlens i32 [nb], stream u8 [n + 3·nb],
    total i64 scalar): the framed stream is ``stream[:total]``. JAX's
    out-of-range ``mode="drop"`` scatters become writes into one extra
    sink slot that is sliced off."""
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
    use_rle = rle_lens < blens
    flags = use_rle.to(torch.uint8)
    dlens = torch.where(use_rle, rle_lens, blens)
    body = torch.where(use_rle[:, None], rle_buf[:, :B], blkmat)
    keep = colm < dlens[:, None]
    # framed-stream compaction (== oracle assemble_block_stream)
    block_lens = (3 + dlens).to(torch.int64)
    offs = torch.cumsum(block_lens, 0) - block_lens
    total = block_lens.sum()
    size = n + 3 * nb
    out = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    out[offs] = flags
    out[offs + 1] = (dlens & 0xFF).to(torch.uint8)
    out[offs + 2] = (dlens >> 8).to(torch.uint8)
    dst = torch.where(keep, offs[:, None] + 3 + colm, size)
    out.scatter_(0, dst.reshape(-1), body.reshape(-1))
    return flags, dlens, out[:size], total


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
