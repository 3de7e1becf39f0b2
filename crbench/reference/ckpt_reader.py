"""A plain reader of the v7 checkpoint format, in NumPy alone.

Layout under a store's root::

    LATEST                               the committed step, as text
    step_<8 digits>/_META/manifest.json  the round's manifest
    _CAS/objects/<d[:2]>/<d>.obj         a chunk, named by its blake2b-128

A manifest's ``leaves`` maps a leaf name to its shape, dtype and shards. A
shard lists its chunks in order; their bytes joined are the shard's
payload (``payload_bytes`` long, ``crc32`` over it). Codecs:

* ``raw``: the payload is the shard's bytes in C order;
* ``byteplane-rle``: each chunk is a framed block stream of its slice of
  the byte-plane stream (``chunk_raw_lens`` bytes). A block is ``[flag
  u8][len u16 le][body]``: flag 0 stores the block as is, flag 1 stores
  (run length, byte) pairs. Blocks hold 4,096 bytes, the last one less.
  The byte-plane stream of k-byte elements is k planes, plane p holding
  byte p of each element, each plane delta-coded mod 256 from its first
  element (``meta["bp"]`` is k).

Every check the format allows is made: each chunk's digest, the payload's
length and crc32, each block's length, and the covered range of each
leaf."""
from __future__ import annotations

import hashlib
import json
import zlib
from pathlib import Path

import numpy as np

BLOCK = 4096
STORAGE = {"bfloat16": np.uint16, "float32": np.float32, "int32": np.int32,
           "uint32": np.uint32, "float16": np.float16, "int64": np.int64,
           "uint8": np.uint8, "int8": np.int8}


class FormatError(ValueError):
    """The checkpoint does not read back as the format says."""


def latest_step(root) -> int:
    return int((Path(root) / "LATEST").read_text().strip())


def manifest(root, step: int) -> dict:
    path = Path(root) / f"step_{step:08d}" / "_META" / "manifest.json"
    return json.loads(path.read_text())


def read_object(root, digest: str) -> bytes:
    data = (Path(root) / "_CAS" / "objects" / digest[:2]
            / f"{digest}.obj").read_bytes()
    if hashlib.blake2b(data, digest_size=16).hexdigest() != digest:
        raise FormatError(f"chunk {digest} does not hash to its name")
    return data


def unframe(enc: bytes, raw_len: int) -> np.ndarray:
    """One chunk's framed block stream → its `raw_len` plane bytes."""
    src = np.frombuffer(enc, np.uint8)
    out = np.empty(raw_len, np.uint8)
    pos = done = 0
    while done < raw_len:
        want = min(BLOCK, raw_len - done)
        if pos + 3 > src.size:
            raise FormatError("block header past the end of the chunk")
        flag, n = int(src[pos]), int(src[pos + 1]) | int(src[pos + 2]) << 8
        body = src[pos + 3:pos + 3 + n]
        if body.size != n:
            raise FormatError("block body past the end of the chunk")
        if flag == 0:
            if n != want:
                raise FormatError("stored block of the wrong length")
            out[done:done + n] = body
        elif flag == 1:
            if n % 2:
                raise FormatError("odd run-length body")
            runs = body[0::2].astype(np.int64)
            if runs.sum() != want or (runs == 0).any():
                raise FormatError("runs do not fill their block")
            out[done:done + want] = np.repeat(body[1::2], runs)
        else:
            raise FormatError(f"block flag {flag} is not byteplane-rle's")
        pos += 3 + n
        done += want
    if pos != src.size:
        raise FormatError("bytes after the last block")
    return out


def unplane(stream: np.ndarray, k: int) -> np.ndarray:
    """The byte-plane stream of k-byte elements → the elements' bytes."""
    ne = stream.size // k
    out = np.empty(stream.size, np.uint8)
    planes = stream[:ne * k].reshape(k, ne)
    out[:ne * k].reshape(ne, k)[:] = np.cumsum(planes, axis=1,
                                               dtype=np.uint8).T
    out[ne * k:] = stream[ne * k:]
    return out


def read_shard(root, shard: dict) -> np.ndarray:
    """A shard's bytes, decoded."""
    payload = b"".join(read_object(root, d) for d in shard["chunks"])
    if len(payload) != shard["payload_bytes"]:
        raise FormatError("payload length differs from the manifest")
    if zlib.crc32(payload) & 0xFFFFFFFF != shard["crc32"]:
        raise FormatError("payload crc32 differs from the manifest")
    codec = shard["codec"]
    if codec == "raw":
        return np.frombuffer(payload, np.uint8)
    if codec != "byteplane-rle":
        raise FormatError(f"codec {codec!r} is not read here")
    planes, pos = [], 0
    for enc_len, raw_len in zip(shard["chunk_lens"], shard["chunk_raw_lens"]):
        planes.append(unframe(payload[pos:pos + enc_len], raw_len))
        pos += enc_len
    if pos != len(payload):
        raise FormatError("chunk lengths do not cover the payload")
    return unplane(np.concatenate(planes), int(shard["meta"]["bp"]))


def read_leaves(root, step: int | None = None):
    """(step, manifest, {leaf name: array}) of the round at `step` (the
    latest when None). Arrays hold the stored bits: bfloat16 as
    uint16."""
    step = latest_step(root) if step is None else step
    man = manifest(root, step)
    leaves = {}
    for name, rec in man["leaves"].items():
        dt = STORAGE[rec["dtype"]]
        arr = np.zeros(tuple(rec["shape"]), dt)
        covered = 0
        for s in rec["shards"]:
            if s["dtype"] != rec["dtype"]:
                raise FormatError(f"{name}: shard dtype {s['dtype']}")
            sl = tuple(slice(a, b) for a, b in zip(s["start"], s["stop"]))
            part = read_shard(root, s).view(dt)
            arr[sl] = part.reshape(arr[sl].shape)
            covered += part.size
        if covered != arr.size:
            raise FormatError(f"{name}: shards cover {covered} of "
                              f"{arr.size} elements")
        leaves[name] = arr
    return step, man, leaves
