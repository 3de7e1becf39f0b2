"""The port's CUDA kernels on the card: each against its plain PyTorch
version byte for byte, and the device save routes against the numpy
oracles. Imports neither JAX nor ``repro``, so it runs on a GPU machine
without them:

    python -m pytest -q tests/test_torch_cuda_kernels.py

Every test is marked ``cuda`` and skips without a card (kernels have no
CPU mode; the plain versions' parity with the JAX package is held on the
CPU by ``test_torch_ckpt_codec_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import cdc_scan
from repro_torch.core import codec
from repro_torch.core.cdc import GearChunker
from repro_torch.kernels.ckpt_codec import byteplane as bp
from repro_torch.kernels.ckpt_codec import entropy as ent
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn

pytestmark = pytest.mark.cuda
B = ent.B


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _masks(avg=1 << 20):
    ck = GearChunker(avg, device="cpu")
    return int(ck.mask_strict), int(ck.mask_loose)


def _payload(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    reps = rng.integers(1, 700, size=n // 100 + 1)
    vals = rng.integers(0, 256, size=reps.size, dtype=np.uint8)
    return np.resize(np.repeat(vals, reps), n).astype(np.uint8)


@pytest.mark.parametrize("kind", ["random", "zeros", "runs"])
@pytest.mark.parametrize("size", [1, 64, 4097, 1_000_003])
def test_kernels_match_plain(cuda, kind, size):
    ms, ml = _masks(4096)
    u8 = torch.from_numpy(_payload(size, kind, size)).to(cuda)
    for k in (1, 2, 4, 8):
        assert torch.equal(bp.forward_planes(u8, k), bp.forward_plain(u8, k))
    padded = torch.zeros(cdc_scan.padded_len(size), dtype=torch.uint8,
                         device=cuda)
    padded[cdc_scan.WINDOW:cdc_scan.WINDOW + size] = u8
    assert torch.equal(cdc_scan.gear_scan(padded, ms, ml),
                       cdc_scan.gear_scan_plain(padded, ms, ml))
    nb = -(-size // B)
    blk = torch.zeros(nb * B, dtype=torch.uint8, device=cuda)
    blk[:size] = u8
    blk = blk.view(nb, B)
    for a, b in zip(ent.rle_emission(blk, size),
                    ent.rle_emission_plain(blk, size)):
        assert torch.equal(a, b)


def test_segmented_scan_matches_oracle(cuda):
    ms, ml = _masks()
    data = _payload(3 * cdc_scan.SEGMENT_BYTES * 2 + 12_345, "random", 1)
    for backend in ("pallas", "jnp"):
        got = cdc_scan.GearScanner(ms, ml, backend=backend,
                                   device=cuda).scan(data)
        ref = cdc_scan.scan_candidates_numpy(data, ms, ml)
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fused_encode_matches_oracle(cuda, itemsize):
    ms, ml = _masks(65536)
    x = (np.random.default_rng(itemsize).standard_normal(3 << 20)
         * 0.02).astype(np.float32)
    data = codec.contig_u8(x)[:(5 << 20) + 3 * itemsize]
    (s, l), stream, bl = cdc_scan.GearScanner(
        ms, ml, backend="pallas", device=cuda).scan_transform_encode_async(
            data, itemsize, "byteplane-rle").result()
    t = codec.byteplane_forward(data, itemsize)
    rs, rl = cdc_scan.scan_candidates_numpy(t, ms, ml)
    rstream, rbl = codec.plane_stream_encode(t, "byteplane-rle")
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(l, rl)
    np.testing.assert_array_equal(stream, rstream)
    np.testing.assert_array_equal(bl, rbl)


def test_launch_counters_count_kernel_launches_only(cuda):
    u8 = torch.zeros(10_000, dtype=torch.uint8, device=cuda)
    before = bp.launches
    bp.forward_planes(u8, 2)
    bp.forward_planes(u8.cpu(), 2)          # plain version: not counted
    assert bp.launches == before + 1


@pytest.mark.parametrize("itemsize", [2, 4])
def test_scan_transform_routes_match_oracle(cuda, itemsize):
    """K2 then K1 without the entropy stage (device_entropy=False and the
    byteplane codec under CDC), and K2 alone (fixed chunking)."""
    ms, ml = _masks(65536)
    x = (np.random.default_rng(itemsize).standard_normal(1 << 20)
         * 0.02).astype(np.float32)
    data = codec.contig_u8(x)[:(3 << 20) + 3 * itemsize]
    (s, l), t = cdc_scan.GearScanner(
        ms, ml, backend="pallas", device=cuda).scan_transform_async(
            data, itemsize).result()
    rt = codec.byteplane_forward(data, itemsize)
    rs, rl = cdc_scan.scan_candidates_numpy(rt, ms, ml)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(l, rl)
    np.testing.assert_array_equal(
        cdc_scan.transform_async(data, itemsize, cuda).result(), rt)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,d", [((16,), 64), ((37,), 96), ((3, 5), 128),
                                    ((4096,), 1152), ((2048, 4), 256)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, tol, rows, d):
    g = torch.Generator(device=cuda)
    g.manual_seed(d)
    x = torch.randn((*rows, d), generator=g, device=cuda).to(dtype)
    s = (torch.randn((d,), generator=g, device=cuda) * 0.1).to(dtype)
    before = rn.launches
    got = rn.rmsnorm_fused(x, s)
    assert rn.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=0)


# K7's routes at the path's shapes (serving prefill, training step,
# decode), a ragged last stage, D 8192 and D 37
RMS_ROUTE_SHAPES = [(16_384, 1152), (65_536, 256), (16_384, 256),
                    (4096, 1152), (4096, 256), (8, 1152), (32, 256),
                    (8, 256), (16_384 + 3, 1152), (300, 8192), (37, 37)]


def _rms_inputs(cuda, n, d, dtype, offset=0):
    g = torch.Generator(device=cuda)
    g.manual_seed(n * 7 + d + offset)
    x = torch.randn((n * d + offset,), generator=g, device=cuda).to(dtype)
    s = (torch.randn((d,), generator=g, device=cuda) * 0.1).to(dtype)
    return x[offset:].view(n, d), s


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("route", [None, *rn.ROUTES])
@pytest.mark.parametrize("n,d", RMS_ROUTE_SHAPES)
def test_rmsnorm_routes_match_plain(cuda, n, d, route, dtype, tol):
    x, s = _rms_inputs(cuda, n, d, dtype)
    if route not in (None, "scalar") and (d * x.element_size()) % 16:
        with pytest.raises(ValueError):
            rn.rmsnorm_fused(x, s, route=route)
        return
    before = rn.launches
    got = rn.rmsnorm_fused(x, s, route=route)
    assert rn.launches == before + 1
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d", [(16_384, 1152), (8, 256), (37, 37)])
def test_rmsnorm_misaligned_view_matches_plain(cuda, n, d, dtype, tol):
    x, s = _rms_inputs(cuda, n, d, dtype, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16
    for route in (None, "scalar"):
        got = rn.rmsnorm_fused(x, s, route=route)
        torch.testing.assert_close(got.float(),
                                   rn.rmsnorm_plain(x, s).float(), atol=tol,
                                   rtol=0)
    with pytest.raises(ValueError):
        rn.rmsnorm_fused(x, s, route="stream")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", RMS_ROUTE_SHAPES[:-1])
def test_rmsnorm_vector_routes_are_bit_equal(cuda, n, d, dtype):
    """stream and warp sum a row in one order: the same bits, launch
    after launch (training resumes bit-exact on that)."""
    x, s = _rms_inputs(cuda, n, d, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    ref = rn.rmsnorm_fused(x, s, route="stream").view(bits)
    for route in ("stream", "warp", None):
        got = rn.rmsnorm_fused(x, s, route=route)
        assert torch.equal(got.view(bits), ref), route


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,S,H,K,D,causal,window,softcap", [
    (1, 64, 4, 4, 32, True, 0, 0.0), (2, 128, 4, 1, 16, True, 0, 0.0),
    (1, 96, 8, 2, 64, True, 0, 0.0), (1, 60, 2, 2, 16, True, 0, 0.0),
    (1, 80, 4, 2, 32, True, 16, 0.0), (1, 80, 4, 2, 32, True, 0, 30.0),
    (1, 80, 4, 2, 32, False, 24, 0.0), (1, 80, 4, 2, 32, False, 0, 0.0),
    (2, 700, 4, 1, 256, True, 512, 0.0), (1, 300, 4, 1, 128, True, 0, 0.0),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, B, S, H, K,
                                              D, causal, window, softcap):
    g = torch.Generator(device=cuda)
    g.manual_seed(S + D)
    q, k, v = (torch.randn((B, S, n, D), generator=g, device=cuda).to(dtype)
               for n in (H, K, K))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, **kw).float(),
                               atol=tol, rtol=0)


# (B, Sq, Sk, H, K, D, causal, window, softcap): the bf16 kernel's edges:
# every head dim (with and without the softcap), ragged S, Sq != Sk,
# windows on and beside the 64-key tile edges, the training step's shape
ATTN_EDGES = [
    *[(1, 200, 200, 4, 2, d, True, 0, 0.0) for d in fa.HEAD_DIMS],
    *[(2, 150, 150, 4, 1, d, False, 0, 20.0) for d in fa.HEAD_DIMS],
    *[(1, 257, 257, 2, 1, d, False, 70, 0.0) for d in fa.HEAD_DIMS],
    (1, 1000, 1000, 4, 1, 256, True, 0, 0.0),
    (1, 2047, 2047, 4, 1, 256, True, 0, 0.0),
    (1, 2047, 2047, 4, 1, 256, True, 512, 0.0),
    (1, 100, 300, 4, 1, 128, False, 0, 0.0),
    (1, 300, 100, 4, 2, 64, True, 0, 0.0),
    (2, 130, 700, 4, 1, 256, False, 65, 0.0),
    (1, 700, 130, 4, 1, 256, True, 600, 0.0),
    *[(1, 1100, 1100, 4, 1, 256, True, w, 0.0)
      for w in (63, 64, 65, 128, 511, 513)],
    *[(1, 600, 600, 2, 1, 128, False, w, 0.0) for w in (63, 64, 65, 128)],
    (4, 1024, 1024, 4, 1, 256, True, 0, 0.0),
    (4, 1024, 1024, 4, 1, 256, True, 512, 0.0),
]


def _attn_inputs(dev, B, Sq, Sk, H, K, D, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn((B, s, n, D), generator=g, device=dev)
            .to(torch.bfloat16) for s, n in ((Sq, H), (Sk, K), (Sk, K)))


@pytest.mark.parametrize("block_q", [0, 64, 128])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,softcap", ATTN_EDGES)
def test_flash_attention_bf16_edges_match_plain(cuda, block_q, B, Sq, Sk, H,
                                                K, D, causal, window,
                                                softcap):
    q, k, v = _attn_inputs(cuda, B, Sq, Sk, H, K, D, Sq + Sk + D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa.launches
    got = fa.flash_attention(q, k, v, block_q=block_q, **kw)
    assert fa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, **kw).float(),
                               atol=3e-2, rtol=0)


# (B, Sq, Sk, H, K, D, causal, window, softcap, q_offset): one rank's
# query rows of a longer sequence, at an offset of 0, on a 64-key tile
# edge and beside it
ATTN_OFFSETS = [
    *[(1, 256, 1024, 4, 2, 128, True, 0, 0.0, o) for o in (0, 512, 511,
                                                           513)],
    *[(1, 200, 1024, 4, 1, 256, True, 128, 0.0, o) for o in (448, 449)],
    (1, 130, 700, 4, 1, 64, False, 65, 0.0, 300),
    (2, 256, 1024, 4, 2, 128, True, 0, 50.0, 768),
]


@pytest.mark.parametrize("dtype,tol,block_q", [
    (torch.float32, 2e-5, 0), *[(torch.bfloat16, 3e-2, bq)
                                for bq in (0, 64, 128)]])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,softcap,q_offset",
                         ATTN_OFFSETS)
def test_flash_attention_q_offset_matches_plain(cuda, dtype, tol, block_q, B,
                                                Sq, Sk, H, K, D, causal,
                                                window, softcap, q_offset):
    q, k, v = (t.to(dtype) for t in _attn_inputs(cuda, B, Sq, Sk, H, K, D,
                                                  Sq + Sk + q_offset))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    before = fa.launches
    got = fa.flash_attention(q, k, v, block_q=block_q, **kw)
    assert fa.launches == before + 1
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, **kw).float(),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("window", [0, 512])
def test_flash_attention_bf16_is_deterministic(cuda, window):
    """Two launches on the same inputs are bit-equal (no atomics: the
    training resume is bit-exact)."""
    q, k, v = _attn_inputs(cuda, 2, 1024, 1024, 4, 1, 256, 5)
    a = fa.flash_attention(q, k, v, causal=True, window=window)
    b = fa.flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("kind", ["random", "zeros", "runs"])
@pytest.mark.parametrize("size", [0, 1, 7, 4097, 65_541, 1_000_003,
                                  64 * (1 << 20) + 12_345])
def test_byteplane_inverse_kernel_matches_plain(cuda, kind, size):
    """K4 byte for byte, ragged tails and ne = 0 included; K4 of K2 is the
    identity. The 64 MiB case spans thousands of tiles: the look-back
    crosses many waves of CTAs."""
    u8 = torch.from_numpy(_payload(size, kind, size + 1)).to(cuda)
    for k in (1, 2, 4, 8):
        before = bp.inverse_launches
        got = bp.inverse_planes(u8, k)
        assert bp.inverse_launches == before + (1 if size else 0)
        assert torch.equal(got, bp.inverse_plain(u8, k))
        assert torch.equal(bp.inverse_planes(bp.forward_planes(u8, k), k),
                           u8)
    np.testing.assert_array_equal(bp.inverse_planes(u8, 2).cpu().numpy(),
                                  codec.byteplane_inverse(u8.cpu().numpy(),
                                                          2))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
def test_byteplane_inverse_repeated_launches_are_bit_equal(cuda, k, offset):
    """20 launches of K4 on one 64 MiB input all equal ``inverse_plain``:
    a flag seen before its byte in the look-back would show only now and
    then. Offset 1 is a view off 16-byte alignment (the byte-load route)."""
    buf = torch.from_numpy(_payload(64 * (1 << 20) + offset, "random",
                                    k + 17 * offset)).to(cuda)
    u8 = buf[offset:]
    want = bp.inverse_plain(u8, k)
    for _ in range(20):
        assert torch.equal(bp.inverse_planes(u8, k), want)


def _int8_input(kind, n, g, dev):
    if kind == "ties":      # amax 127 → scale 1.0: exact k + 0.5 quotients
        x = torch.randint(-253, 254, (n,), generator=g, device=dev) * 0.5
        x[::256] = 127.0
        return x
    if kind == "zeros":
        x = torch.zeros(n, device=dev)
        x[n // 2] = 0.375
        return x
    scale = 0.02 if kind == "normal" else 1e-39
    return torch.randn(n, generator=g, device=dev) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "tiny"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 65_537, 1_000_003])
def test_int8_kernels_match_plain_and_oracle(cuda, dtype, kind, n):
    """K5 byte for byte on q and bit for bit on the scales, K6 bit for bit
    on both output dtypes, and both equal to the host codec."""
    from repro_torch.kernels.ckpt_codec import int8_codec as ic
    g = torch.Generator(device=cuda)
    g.manual_seed(n)
    x = _int8_input(kind, n, g, cuda).to(dtype)
    before = ic.quantize_launches
    q, s = ic.quantize_blocks(x)
    assert ic.quantize_launches == before + 1
    pq, ps = ic.quantize_plain(x)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    from repro_torch.core.save_path import to_host
    oq, os_ = codec.quantize_int8(to_host(x))
    np.testing.assert_array_equal(q.cpu().numpy(), oq)
    np.testing.assert_array_equal(s.cpu().numpy().view(np.int32),
                                  os_.view(np.int32))
    for out in (torch.float32, torch.bfloat16):
        before = ic.dequantize_launches
        got = ic.dequantize_blocks(q, s, n, out)
        assert ic.dequantize_launches == before + 1
        ref = ic.dequantize_plain(q, s, n, out)
        assert torch.equal(_bits(got), _bits(ref))
        host = codec.Quantized(oq, os_, n, str(out).split(".")[-1],
                               (n,)).decode()
        np.testing.assert_array_equal(
            to_host(got).view(f"i{got.element_size()}"),
            np.asarray(host).view(f"i{got.element_size()}"))


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("dtype", ["float16", "float64", "int32", "uint32",
                                   "bool"])
@pytest.mark.parametrize("n", [1, 257, 65_537])
def test_int8_kernels_take_any_leaf_dtype(cuda, dtype, n):
    """A leaf of another dtype than bf16/f32 crosses to f32 on the card
    before K5 and from K6's f32 after it, to the host codec's q, scales and
    restored bits (ints up to their type's edge)."""
    from repro_torch.core.save_path import to_host
    from repro_torch.kernels.ckpt_codec import int8_codec as ic
    rng = np.random.default_rng(n)
    if dtype == "bool":
        x = rng.integers(0, 2, n).astype(bool)
    elif dtype in ("float16", "float64"):
        x = (rng.standard_normal(n) * 3).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
        x[::7] = info.max
    t = torch.from_numpy(x.view(np.int32) if dtype == "uint32" else x)
    t = (t.view(torch.uint32) if dtype == "uint32" else t).to(cuda)
    before = (ic.quantize_launches, ic.dequantize_launches)
    q, s = ic.quantize_blocks(t)
    oq, os_ = codec.quantize_int8(x)
    np.testing.assert_array_equal(q.cpu().numpy(), oq)
    np.testing.assert_array_equal(s.cpu().numpy().view(np.int32),
                                  os_.view(np.int32))
    got = ic.dequantize_blocks(q, s, n, t.dtype)
    assert (ic.quantize_launches, ic.dequantize_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == t.dtype and got.is_cuda
    with np.errstate(invalid="ignore"):     # 2**31 past int32's edge
        host = codec.Quantized(oq, os_, n, dtype, (n,)).decode()
    np.testing.assert_array_equal(to_host(got).view(host.dtype), host)


def _split_shards(state):
    """Every leaf of two or more rows saved as two shards."""
    from repro_torch.core.elastic import ShardRange
    from repro_torch.core.split_state import leaf_paths
    for name, leaf in leaf_paths(state):
        shape = tuple(leaf.shape)
        if not shape or shape[0] < 2:
            yield name, ShardRange((0,) * len(shape), shape), leaf
            continue
        cut = shape[0] // 3 + 1
        for a, b in ((0, cut), (cut, shape[0])):
            yield (name, ShardRange((a,) + (0,) * (len(shape) - 1),
                                    (b,) + shape[1:]), leaf[a:b])


@pytest.mark.parametrize("codec_name", ["int8", "byteplane-rle"])
def test_device_decode_of_split_shards_matches_host(cuda, codec_name,
                                                    tmp_path, monkeypatch):
    """Leaves saved as two shards each, in bf16, f32, int32 and uint32,
    decode shard by shard on the card (one K4/K6 launch per shard) into
    the host route's bits, and the K5 route saves the host route's
    manifest."""
    from repro_torch.core import save_path
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                         CodecPolicy, DurabilityPolicy,
                                         PipelinePolicy)
    from repro_torch.core.split_state import leaf_paths
    from repro_torch.core.storage import Tier, TieredStore
    from repro_torch.kernels.ckpt_codec import int8_codec as ic
    monkeypatch.setattr(save_path, "iter_snapshot_shards", _split_shards)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    state = {"params": {"w": torch.randn(64, 96, generator=g, device=cuda)
                        .to(torch.bfloat16),
                        "b": torch.randn(8, 100, generator=g, device=cuda)},
             "rng": torch.tensor([7, -9], dtype=torch.int32, device=cuda)
             .view(torch.uint32),
             "step": torch.tensor(5, dtype=torch.int32, device=cuda)}

    def manager(name, **kw):
        return CheckpointManager(TieredStore(Tier("fast", tmp_path / name)),
                                 CheckpointPolicy(
            mode="incremental",
            chunking=ChunkingPolicy(scheme="cdc", chunk_size=4096),
            pipeline=PipelinePolicy(io_threads=4),
            durability=DurabilityPolicy(keepalive_s=60.0),
            codec=CodecPolicy(codec=codec_name, params_codec=codec_name,
                              **kw)), device=cuda)

    dev, host = manager("dev"), manager("host", device_precondition=False)
    dev.save(state, 1)
    host.save(state, 1)
    leaves = dev.load_manifest(1)["leaves"]
    assert leaves == host.load_manifest(1)["leaves"]
    shards = sum(len(r["shards"]) for r in leaves.values())
    assert shards == 7
    before = (bp.inverse_launches, ic.dequantize_launches)
    got, _ = dev.restore(state)
    launched = (bp.inverse_launches - before[0],
                ic.dequantize_launches - before[1])
    assert launched == ((0, shards) if codec_name == "int8"
                        else (shards, 0))
    ref, _ = host.restore(state)
    assert (bp.inverse_launches, ic.dequantize_launches) == \
        (before[0] + launched[0], before[1] + launched[1])
    for (name, a), (_, b) in zip(leaf_paths(got), leaf_paths(ref)):
        assert a.is_cuda and a.dtype == b.dtype, name
        assert np.array_equal(save_path.to_host(a), save_path.to_host(b)), \
            name
    dev.close()
    host.close()
