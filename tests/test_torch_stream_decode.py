"""The port's framed-stream host codec held against the reference's on the
same bytes. The decoder (``codec.plane_stream_decode`` and
``plane_decode_chunks``: the header walk that probes runs of full raw
blocks, the strided copy of those runs, one ``np.repeat`` over every RLE
block, the rANS group): equal output on well-formed streams, and on
damaged ones either both raise ValueError or both return the same bytes.
The encoder (``plane_stream_encode``: the greedy RLE run over the blocks
with fewer runs than half their length, the stream taken from a record a
block): the reference's stream and block lengths byte for byte. About
30 s alone."""
import numpy as np
import pytest

from repro.core import codec as ref
from repro_torch.core import codec

B = codec.ENTROPY_BLOCK


def _layout(rng, n: int, kind: str) -> np.ndarray:
    """`n` bytes whose blocks encode as the named mix of block kinds."""
    if kind == "raw":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "alternating":           # raw, RLE, raw, RLE, ... blocks
        x = rng.integers(0, 256, n, dtype=np.uint8)
        for a in range(B, n, 2 * B):
            x[a:a + B] = 7
        return x
    if kind == "runs":                  # long runs of each kind
        x = rng.integers(0, 256, n, dtype=np.uint8)
        for _ in range(4):
            a = int(rng.integers(0, n + 1))
            x[a:a + int(rng.integers(0, 6 * B))] = 0
        return x
    if kind == "skewed":                # rANS-friendly where the codec has it
        return rng.choice(np.arange(4, dtype=np.uint8), n,
                          p=[0.85, 0.1, 0.04, 0.01])
    if kind == "bf16_planes":           # a bf16 weight leaf's byte planes
        f = (rng.standard_normal((n + 1) // 2) * 0.02).astype(np.float32)
        bf = (f.view(np.uint32) >> 16).astype(np.uint16)
        return codec.byteplane_forward(bf.view(np.uint8), 2)[:n]
    raise ValueError(kind)


KINDS = ("raw", "zeros", "alternating", "runs", "skewed", "bf16_planes")
SIZES = (0, 1, B - 1, B, B + 1, 17 * B, 17 * B + 333, 300_001)


def _headers(enc: np.ndarray, n: int) -> list:
    """Offsets of the block headers of a well-formed stream of `n` raw
    bytes (flag byte, then the body length, two bytes little-endian)."""
    heads, pos = [], 0
    for _ in range(-(-n // B)):
        heads.append(pos)
        pos += 3 + int(enc[pos + 1]) + (int(enc[pos + 2]) << 8)
    return heads


def _decode(mod, enc, n, c):
    try:
        return mod.plane_stream_decode(enc, n, c)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("codec_name", codec.CHUNK_ENCODED)
@pytest.mark.parametrize("kind", KINDS + ("few_runs",))
def test_stream_encode_equals_reference(codec_name, kind):
    """Every kind of block, and blocks whose runs number near half their
    length (where RLE just wins or just loses)."""
    rng = np.random.default_rng(17)
    for n in SIZES:
        if kind == "few_runs":
            # runs of 1 or 2 bytes: about B/3 to B/2 runs a block
            reps = rng.integers(1, 3 + (n % 3 == 0), n + 1)
            x = np.repeat(rng.integers(0, 256, n + 1, dtype=np.uint8),
                          reps)[:n]
        else:
            x = _layout(rng, n, kind)
        got, got_lens = codec.plane_stream_encode(x, codec_name)
        want, want_lens = ref.plane_stream_encode(x, codec_name)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_lens, want_lens)


@pytest.mark.parametrize("codec_name", codec.CHUNK_ENCODED)
@pytest.mark.parametrize("kind", KINDS)
def test_stream_decode_equals_reference(codec_name, kind):
    rng = np.random.default_rng(KINDS.index(kind))
    for n in SIZES:
        x = _layout(rng, n, kind)
        enc, _ = ref.plane_stream_encode(x, codec_name)
        got = codec.plane_stream_decode(enc, n, codec_name)
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(
            got, ref.plane_stream_decode(enc, n, codec_name))
        out = np.full(n + 8, 99, np.uint8)
        codec.plane_stream_decode(enc, n, codec_name, out=out[4:4 + n])
        np.testing.assert_array_equal(out[4:4 + n], x)
        assert (out[:4] == 99).all() and (out[4 + n:] == 99).all()


@pytest.mark.parametrize("codec_name", codec.CHUNK_ENCODED)
def test_damaged_streams_fail_as_the_reference(codec_name):
    """Truncations, trailing bytes and flipped bytes (headers and bodies)
    over every kind of block: the port raises ValueError exactly where the
    reference does, and otherwise returns the reference's bytes."""
    rng = np.random.default_rng(5)
    raised = 0
    for trial in range(240):
        kind = KINDS[trial % len(KINDS)]
        n = int(rng.choice(SIZES[1:]))
        enc, _ = ref.plane_stream_encode(_layout(rng, n, kind), codec_name)
        mode = trial % 4
        if mode == 0:
            bad = enc[:int(rng.integers(0, enc.size))]
        elif mode == 1:
            bad = np.concatenate([enc, np.zeros(int(rng.integers(1, 5)),
                                                np.uint8)])
        else:
            bad = enc.copy()
            heads = _headers(enc, n)
            at = int(rng.integers(0, enc.size)) if mode == 2 else \
                int(rng.choice(heads)) + int(rng.integers(0, 3))
            bad[at] ^= np.uint8(rng.integers(1, 256))
        want, got = _decode(ref, bad, n, codec_name), \
            _decode(codec, bad, n, codec_name)
        if isinstance(want, str):
            raised += 1
            assert got == want, (trial, kind, n, mode)
        else:
            assert not isinstance(got, str), (trial, kind, n, mode)
            np.testing.assert_array_equal(got, want)
    assert raised > 100


@pytest.mark.parametrize("codec_name", codec.CHUNK_ENCODED)
def test_chunk_payload_decode_equals_reference(codec_name):
    """A v7 payload: per-chunk encodings of CDC-like ragged chunks (each
    chunk's last block short), concatenated."""
    rng = np.random.default_rng(9)
    x = np.concatenate([_layout(rng, 40 * B, k) for k in KINDS])
    cuts = np.sort(rng.choice(np.arange(1, x.size), 23, replace=False))
    chunks = np.split(x, cuts)
    encs = [ref.plane_encode_chunk(c, codec_name) for c in chunks]
    payload = b"".join(encs)
    enc_lens = [len(e) for e in encs]
    raw_lens = [c.size for c in chunks]
    got = codec.plane_decode_chunks(payload, enc_lens, raw_lens, codec_name)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(
        got, ref.plane_decode_chunks(payload, enc_lens, raw_lens, codec_name))
    with pytest.raises(ValueError):
        codec.plane_decode_chunks(payload + b"\0", enc_lens, raw_lens,
                                  codec_name)
