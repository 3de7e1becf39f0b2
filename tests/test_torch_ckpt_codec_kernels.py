"""The port's device encode (gear scan K1, byteplane forward K2, RLE
emission K3 + glue) and decode (byteplane inverse K4), and its int8 codec
(quantizer K5, dequantizer K6), against the JAX package's Pallas kernels
run in interpret mode and the numpy oracles, byte for byte (tolerance 0:
candidates, transformed bytes and encoded streams are the dedup keyspace;
restored leaves and int8 payloads are bit-exact).

On this CPU machine every wrapper takes its plain PyTorch version (the
tensors lie on the CPU), which is exactly the arithmetic the CUDA kernels
are held to on the card (``test_torch_cuda_kernels.py``)."""
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import cdc_scan as jscan
from repro.core import codec as jcodec
from repro.core.cdc import GearChunker as JGearChunker
from repro.kernels.ckpt_codec import byteplane as jbp
from repro.kernels import ckpt_codec as jck
from repro.kernels.ckpt_codec import entropy as jent
from repro_torch.core import cdc_scan as tscan
from repro_torch.core import codec as tcodec
from repro_torch.kernels.ckpt_codec import byteplane as tbp
from repro_torch.kernels.ckpt_codec import entropy as tent
from repro_torch.kernels.ckpt_codec import int8_codec as tic

B = jcodec.ENTROPY_BLOCK
BLK = tic.BLOCK
W = jscan.WINDOW


def _masks(avg=1024):
    ck = JGearChunker(avg)
    return int(ck.mask_strict), int(ck.mask_loose)


def _payload(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "runs":              # run lengths cross the 255 cap and the
        reps = rng.integers(1, 700, size=max(n // 100, 1))   # block ends
        vals = rng.integers(0, 256, size=reps.size, dtype=np.uint8)
        return np.resize(np.repeat(vals, reps), n).astype(np.uint8)
    if kind == "planes":            # byteplane'd small floats
        f = (rng.standard_normal(max(n // 4, 1)) * 0.02).astype(np.float32)
        t = jcodec.byteplane_forward(jcodec.contig_u8(f), 4)
        return np.resize(t, n).astype(np.uint8)
    raise AssertionError(kind)


def _t(a):
    return torch.from_numpy(np.array(a, np.uint8).reshape(-1))


# ---------------------------------------------------------------------------
# K1 — gear scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, W - 1, W, W + 1, 1000, 70_000,
                                  200_001])
def test_gear_scan_candidates_match_pallas_interpret(size):
    ms, ml = _masks()
    data = _payload(size, "random", seed=size).tobytes()
    ref = jscan.GearScanner(ms, ml, backend="pallas", pallas_interpret=True)
    port = tscan.GearScanner(ms, ml, backend="pallas", device="cpu")
    rs, rl = ref.scan(data)
    ps, pl_ = port.scan(data)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl_, rl)


def test_gear_scan_full_mask_matches_pallas_kernel():
    """Every mask byte, including the first window's halo positions that
    extraction discards, equals the Pallas kernel's (two grid programs)."""
    ms, ml = _masks(512)
    padded = _payload(2 * tscan.PALLAS_BLOCK, "random", seed=3)
    ref = np.asarray(jscan._pallas_scan_expr(jnp.asarray(padded), ms, ml,
                                             interpret=True))
    got = tscan.gear_scan(_t(padded), ms, ml).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["zeros", "runs"])
def test_gear_scan_low_entropy_and_segmented(kind):
    """Constant/run payloads, and a payload past SEGMENT_BYTES with more
    segments than the in-flight window: the segmented scan's halos and
    deferred dispatches reproduce the numpy oracle exactly."""
    ms, ml = _masks()
    n = tscan.SEGMENT_BYTES * (tscan.MAX_INFLIGHT_SEGMENTS + 1) // 8 \
        if kind == "zeros" else 100_000
    data = _payload(n, kind, seed=5)
    rs, rl = jscan.scan_candidates_numpy(data, ms, ml)
    port = tscan.GearScanner(ms, ml, backend="pallas", device="cpu")
    ps, pl_ = port.scan(data)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl_, rl)


def test_segmented_scan_crosses_segments(monkeypatch):
    ms, ml = _masks()
    monkeypatch.setattr(tscan, "SEGMENT_BYTES", 70_000)
    data = _payload(70_000 * (tscan.MAX_INFLIGHT_SEGMENTS + 2) + 1234,
                    "random", seed=7)
    rs, rl = jscan.scan_candidates_numpy(data, ms, ml)
    for backend in ("pallas", "jnp"):
        ps, pl_ = tscan.GearScanner(ms, ml, backend=backend,
                                    device="cpu").scan(data)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pl_, rl)


# ---------------------------------------------------------------------------
# K2 — byteplane forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("size", [0, 1, 7, 4096, 65_541, 200_003])
def test_byteplane_forward_matches_pallas_interpret(itemsize, size):
    u8 = _payload(size, "planes" if size > 8 else "random", seed=size)
    ref = np.asarray(jbp.forward_pallas(jnp.asarray(u8), itemsize=itemsize,
                                        interpret=True))
    got = tbp.forward_planes(_t(u8), itemsize).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jcodec.byteplane_forward(u8, itemsize))


# ---------------------------------------------------------------------------
# K4 — byteplane inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("size", [0, 1, 7, 4096, 65_541, 200_003])
def test_byteplane_inverse_matches_pallas_interpret(itemsize, size):
    """Ragged tails (size % itemsize != 0) and ne = 0 included."""
    u8 = _payload(size, "planes" if size > 8 else "random", seed=size + 1)
    ref = np.asarray(jbp.inverse_pallas(jnp.asarray(u8), itemsize=itemsize,
                                        interpret=True))
    got = tbp.inverse_planes(_t(u8), itemsize).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jcodec.byteplane_inverse(u8, itemsize))
    np.testing.assert_array_equal(
        tbp.inverse_planes(tbp.forward_planes(_t(u8), itemsize),
                           itemsize).numpy(), u8)


def _inv_cu():
    """The C entry of ``csrc/byteplane_inv.cu``: its integer constants, its
    tile table and the statements that size the scratch it refuses below."""
    src = (Path(tbp.__file__).resolve().parents[2] / "csrc"
           / "byteplane_inv.cu").read_text()
    consts = {m[1]: int(m[2]) for m in
              re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    table = re.search(r"constexpr int TILE_ELEMS\[\d+\] = \{([^}]*)\};",
                      src)[1]
    consts["TILE_ELEMS"] = tuple(int(x) for x in table.split(","))
    entry = src[src.index('extern "C" int rt_byteplane_inv'):]
    sizing = re.findall(r"const int64_t (\w+) = ([^;]*);", entry)
    assert [name for name, _ in sizing] == ["ne", "ntiles", "words", "need"]
    assert "if (scratch_bytes < need" in entry
    return consts, sizing


def test_byteplane_inverse_tiles_follow_the_kernel():
    """``INV_TILE`` is the kernel's tile table: TILE_BYTES over the
    itemsize rounded up to a power of two, whole rows of 16 elements a
    thread."""
    consts, _ = _inv_cu()
    tiles = consts["TILE_ELEMS"]
    assert tbp.INV_TILE == tiles
    assert len(tiles) == consts["MAX_K"] + 1
    for k in range(1, consts["MAX_K"] + 1):
        assert tiles[k] * (1 << (k - 1).bit_length()) == consts["TILE_BYTES"]
        assert tiles[k] % (16 * consts["THREADS"]) == 0
    assert (tbp.INV_STATUS_BYTES, tbp.INV_COUNTER_BYTES) == \
        (consts["STATUS_BYTES"], consts["COUNTER_BYTES"])


@pytest.mark.parametrize("itemsize", range(1, 9))
@pytest.mark.parametrize("n", [0, 7, 131_073, 603_979_776, 2_684_354_560])
def test_byteplane_inverse_scratch_matches_the_kernel(n, itemsize):
    """The wrapper allocates exactly the scratch that the C entry asks for
    (its own statements, evaluated here): a short scratch never reaches the
    card. Sizes: none, a ragged few, a tile past 2^17, ``params/embed``,
    llama4-scout's 2.7 GB ``moe/wg``."""
    consts, sizing = _inv_cu()
    env = {**consts, "n": n, "k": itemsize}
    for name, expr in sizing:
        env[name] = eval(expr.replace("/", "//"), {}, env)  # C: n >= 0
    assert tbp.inverse_scratch_bytes(n, itemsize) == env["need"]


# ---------------------------------------------------------------------------
# K5/K6 — int8 block quantizer and dequantizer
# ---------------------------------------------------------------------------

def _int8_input(kind, n, seed):
    """f32 values of `kind`: ``ties`` holds blocks of amax 127 (scale 1.0)
    and 254 (scale 2.0) whose quotients are exact k + 0.5 ties; ``zeros``
    is all-zero blocks but one; ``tiny`` has subnormal scales."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(n) * 0.02
    elif kind == "ties":
        x = rng.integers(-253, 254, n) * 0.5
        x[::BLK] = 127.0
        x = np.where(np.arange(n) // BLK % 2, x * 2.0, x)
    elif kind == "zeros":
        x = np.zeros(n)
        x[n // 2] = 0.375
    else:
        x = rng.standard_normal(n) * 1e-39
    return x.astype(np.float32)


def _as_dtype(x, dtype):
    """f32 numpy → (torch tensor, jnp array) of `dtype` with equal bits."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    if dtype == "float32":
        return t, jnp.asarray(x)
    return t, jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype]).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "tiny"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096, 65_537])
def test_int8_codec_matches_pallas_interpret_and_oracle(dtype, kind, n):
    x = _int8_input(kind, n, seed=n)
    tx, jx = _as_dtype(x, dtype)
    q, s = tic.quantize_blocks(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numel() == -(-n // BLK) * BLK
    oq, os_ = tcodec.quantize_int8(np.asarray(jx))
    np.testing.assert_array_equal(q.numpy(), oq)
    np.testing.assert_array_equal(_bits(s), os_.view(np.int32))
    # XLA on the CPU flushes subnormals to zero (the oracle, whose bytes
    # the checkpoint holds, and the port keep them), and it folds
    # ``amax / 127`` into ``amax · (1/127)``: the interpret-mode scales are
    # the oracle's to one ulp (test_kernels.py allows 1e-7), and q is the
    # oracle's wherever the scales agree — in every block of the tie and
    # zero inputs, whose scales are exactly 1, 2 or 1.0
    jax_too = kind != "tiny"
    if jax_too:
        jq, js = jck.quantize_blocks(jx, interpret=True)
        jq, js = np.asarray(jq), np.asarray(js)
        np.testing.assert_allclose(js, os_, rtol=1.2e-7, atol=0)
        same = np.repeat(js == os_, BLK)
        assert kind == "normal" or same.all()
        np.testing.assert_array_equal(q.numpy()[same], jq[same])
        assert np.abs(q.numpy().astype(np.int32) - jq).max() <= 1
    for out in ("float32", "bfloat16"):
        got = tic.dequantize_blocks(q, s, n, getattr(torch, out))
        assert got.shape == (n,)
        if jax_too:
            ref = jck.dequantize_blocks(jnp.asarray(oq), jnp.asarray(os_),
                                        n=n, out_dtype=getattr(jnp, out),
                                        interpret=True)
            np.testing.assert_array_equal(
                _bits(got), np.asarray(ref).view(_bits(got).dtype))
        host = tcodec.Quantized(oq, os_, n, out, (n,)).decode()
        np.testing.assert_array_equal(
            _bits(got), np.asarray(host).view(_bits(got).dtype))


@pytest.mark.parametrize("dtype", ["float16", "float64", "int32", "uint32",
                                   "int8", "bool"])
@pytest.mark.parametrize("n", [1, 257, 4096])
def test_int8_codec_wrappers_take_any_leaf_dtype(dtype, n):
    """A leaf of another dtype than bf16/f32 crosses to f32 before K5 and
    back from K6's f32 after it, as the host codec's casts: the same q,
    scales and restored bits (int32 steps, the uint32 rng key, wide ints
    near the type's edge)."""
    rng = np.random.default_rng(n)
    if dtype == "bool":
        x = rng.integers(0, 2, n).astype(bool)
    elif dtype in ("float16", "float64"):
        x = (rng.standard_normal(n) * 3).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
        x[:: 7] = info.max
    t = torch.from_numpy(x.view(np.int32) if dtype == "uint32" else x)
    if dtype == "uint32":
        t = t.view(torch.uint32)
    q, s = tic.quantize_blocks(t)
    oq, os_ = tcodec.quantize_int8(x)
    np.testing.assert_array_equal(q.numpy(), oq)
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  os_.view(np.int32))
    got = tic.dequantize_blocks(q, s, n, t.dtype)
    assert got.dtype == t.dtype and got.shape == (n,)
    with np.errstate(invalid="ignore"):     # 2**31 past int32's edge
        host = tcodec.Quantized(oq, os_, n, dtype, (n,)).decode()
    if dtype == "uint32":
        got = got.view(torch.int32)
        host = host.view(np.int32)
    np.testing.assert_array_equal(got.numpy(), host)


# ---------------------------------------------------------------------------
# K3 — RLE emission, and the encode glue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "zeros", "runs", "planes"])
@pytest.mark.parametrize("size", [1, 255, 4095, 4096, 4097, 9_000, 65_549])
def test_rle_emission_matches_pallas_kernel(kind, size):
    u8 = _payload(size, kind, seed=size)
    nb = -(-size // B)
    blk = np.zeros(nb * B, np.uint8)
    blk[:size] = u8
    blk = blk.reshape(nb, B)
    r_emit, r_run = jent._rle_emission_pallas(jnp.asarray(blk), size,
                                              interpret=True)
    emit, run = tent.rle_emission(torch.from_numpy(blk), size)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(r_emit))
    np.testing.assert_array_equal(run.numpy(), np.asarray(r_run))


@pytest.mark.parametrize("kind", ["random", "zeros", "runs", "planes"])
@pytest.mark.parametrize("size", [0, 1, 256, 4096, 4097, 8193, 65_549])
def test_rle_encode_stream_matches_pallas_interpret(kind, size):
    u8 = _payload(size, kind, seed=size + 1)
    ref_s, ref_bl = jent.encode_stream(u8, "byteplane-rle",
                                       backend="pallas", interpret=True)
    got_s, got_bl = tent.encode_stream(u8, "byteplane-rle", device="cpu")
    np.testing.assert_array_equal(got_s, ref_s)
    np.testing.assert_array_equal(got_bl, ref_bl)
    ora_s, ora_bl = jcodec.plane_stream_encode(u8, "byteplane-rle")
    np.testing.assert_array_equal(got_s, ora_s)
    np.testing.assert_array_equal(got_bl, ora_bl)


def test_rans_device_stage_is_not_silently_substituted():
    """Asking for byteplane-rans runs the rANS stage (rANS-framed blocks,
    byte-identical to the JAX jnp encoder), never RLE in its place; a codec
    without a device entropy stage raises."""
    u8 = np.random.default_rng(2).geometric(0.3, 3 * B + 5).astype(np.uint8)
    flags, _, _, _ = tent.encode(_t(u8), "byteplane-rans")
    assert flags[:3].tolist() == [2, 2, 2]
    ref_s, ref_bl = jent.encode_stream(u8, "byteplane-rans", backend="jnp")
    got_s, got_bl = tent.encode_stream(u8, "byteplane-rans", device="cpu")
    np.testing.assert_array_equal(got_s, ref_s)
    np.testing.assert_array_equal(got_bl, ref_bl)
    with pytest.raises(NotImplementedError):
        tent.encode(_t(u8), "byteplane-zstd")


# ---------------------------------------------------------------------------
# the fused three-stage dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize,size,kind", [
    (2, 150_002, "planes"), (4, 131_072, "planes"), (2, 90_001, "random"),
    (4, 70_000, "zeros"), (1, 3_000, "runs"), (2, W, "random")])
def test_fused_encode_matches_jax_pallas(itemsize, size, kind):
    ms, ml = _masks(4096)
    data = _payload(size, kind, seed=size)
    ref = jscan.GearScanner(ms, ml, backend="pallas", pallas_interpret=True)
    (rs, rl), rstream, rbl = ref.scan_transform_encode_async(
        data, itemsize, "byteplane-rle").result()
    port = tscan.GearScanner(ms, ml, backend="pallas", device="cpu")
    (ps, pl_), pstream, pbl = port.scan_transform_encode_async(
        data, itemsize, "byteplane-rle").result()
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl_, rl)
    np.testing.assert_array_equal(pstream, rstream)
    np.testing.assert_array_equal(pbl, rbl)


def test_concurrent_scans_share_the_staging_arena():
    """Writer ranks scan from several threads at once; the staging arena
    and the launch path are shared. Results must equal the oracle's."""
    ms, ml = _masks()
    payloads = [_payload(70_000 * 5 + i, "random", seed=i) for i in range(12)]
    refs = [jscan.scan_candidates_numpy(p, ms, ml) for p in payloads]
    errors = []

    def worker(i):
        try:
            sc = tscan.GearScanner(ms, ml, backend="pallas", device="cpu")
            for _ in range(3):
                got = sc.scan(payloads[i])
                if not all(np.array_equal(x, y)
                           for x, y in zip(got, refs[i])):
                    errors.append(i)
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tscan, "SEGMENT_BYTES", 70_000)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(payloads))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_unported_routes_raise():
    """Every JAX route exists in the port now; what still raises is a
    device route asked for on a machine without the device."""
    ms, ml = _masks()
    sc = tscan.GearScanner(ms, ml, backend="pallas", device="cpu")
    (s, l), t = sc.scan_transform_async(b"\x00" * 100, 2).result()
    np.testing.assert_array_equal(t, np.zeros(100, np.uint8))
    np.testing.assert_array_equal(
        tscan.transform_async(b"\x00" * 100, 2).result(), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tscan.transform_async(b"\x01" * tscan.MIN_ACCEL_BYTES, 2)


def test_backend_resolution_keeps_jax_vocabulary():
    ms, ml = _masks()
    sc = tscan.GearScanner(ms, ml, backend="auto", device="cpu")
    assert sc.resolve(tscan.MIN_ACCEL_BYTES - 1) == "numpy"
    assert sc.resolve(tscan.MIN_ACCEL_BYTES) == "jnp"
    assert not sc.accelerator_present()
    assert tscan.GearScanner(ms, ml, backend="pallas",
                             device="cpu").resolve(10) == "pallas"
    with pytest.raises(ValueError):
        tscan.GearScanner(ms, ml, backend="xla", device="cpu")
