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
