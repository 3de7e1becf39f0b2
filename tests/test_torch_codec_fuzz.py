"""The codec fuzz families of ``tests/test_byteplane.py``,
``tests/test_entropy.py`` and ``tests/test_cdc_scan.py`` that
``test_torch_host.py``, ``test_torch_routes.py`` and
``test_torch_ckpt_codec_kernels.py`` do not hold, run through the port:
every size and itemsize the reference parametrises, byte for byte against
the JAX package's oracles (streams, transforms, candidates, cut points);
the staging arena; the codec entries and policy names; and the
end-to-end byteplane saves (device / host / serial writers, replicas and
a second save, zstd, adoption), whose manifests must equal the
reference's. The device routes (``backend="pallas"``, the kernel
wrappers) run their plain versions on the CPU."""
import numpy as np
import pytest

import test_byteplane as refbp
import test_entropy as refent
import test_torch_checkpoint_engine as eng
from repro.core import cdc_scan as jscan
from repro.core import codec as jcodec
from repro.core.cdc import GearChunker as JGearChunker
from repro_torch.core import cdc_scan
from repro_torch.core import codec as codec_mod
from repro_torch.core import save_path
from repro_torch.core.cdc import GearChunker
from repro_torch.core.cdc_scan import (WINDOW, GearScanner, ScanTicket,
                                       scan_candidates_numpy)
from repro_torch.core.codec import ENTROPY_BLOCK
from repro_torch.core.policy import CheckpointPolicy, CodecPolicy
from repro_torch.kernels.ckpt_codec import byteplane as bp
from repro_torch.kernels.ckpt_codec import entropy as ent

MS, ML = refbp.MS, refbp.ML
CODECS = refent.CODECS
KINDS = refent.KINDS


def _rand(n, seed=0):
    return refbp._rand(n, seed)


def _u8(b):
    return np.frombuffer(b, np.uint8)


# ---------------------------------------------------------------------------
# test_byteplane.py: the oracle at every size and itemsize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", refbp.ITEMSIZES)
@pytest.mark.parametrize("n", refbp.SIZES)
def test_byteplane_oracle_round_trip(n, k):
    """The port's host oracle and its kernel's plain version give the
    reference oracle's transform, and invert it."""
    u8 = _rand(n, seed=n + k)
    t = codec_mod.byteplane_forward(u8, k)
    assert t.dtype == np.uint8 and t.size == n
    np.testing.assert_array_equal(t, jcodec.byteplane_forward(u8, k))
    np.testing.assert_array_equal(codec_mod.byteplane_inverse(t, k), u8)
    if k in bp.KERNEL_ITEMSIZES:
        import torch
        plain = bp.forward_plain(torch.from_numpy(u8.copy()), k)
        np.testing.assert_array_equal(plain.numpy(), t)
        back = bp.inverse_plain(torch.from_numpy(t.copy()), k)
        np.testing.assert_array_equal(back.numpy(), u8)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "uint32",
                                   "bfloat16"])
def test_byteplane_oracle_round_trip_real_dtypes(dtype):
    rng = np.random.default_rng(7)
    if dtype == "int8":
        arr = rng.integers(-127, 128, 5003, dtype=np.int8)
    elif dtype == "uint32":
        arr = rng.integers(0, 1 << 32, 2049, dtype=np.uint32)
    else:
        arr = (rng.standard_normal(4097) * 0.02).astype(np.float32)
        if dtype == "float16":
            arr = arr.astype(np.float16)
        elif dtype == "bfloat16":
            # the port's host carrier of a bf16 tensor: its bytes are the
            # reference's bf16 array's
            import jax.numpy as jnp
            import torch
            ref_u8 = jcodec.contig_u8(np.asarray(
                jnp.asarray(arr).astype(jnp.bfloat16)))
            arr = save_path.to_host(torch.from_numpy(arr)
                                    .to(torch.bfloat16))
            np.testing.assert_array_equal(codec_mod.contig_u8(arr), ref_u8)
    u8 = codec_mod.contig_u8(arr)
    k = arr.dtype.itemsize
    t = codec_mod.byteplane_forward(u8, k)
    np.testing.assert_array_equal(t, jcodec.byteplane_forward(u8, k))
    np.testing.assert_array_equal(codec_mod.byteplane_inverse(t, k), u8)


def test_byteplane_oracle_rejects_bad_itemsize():
    with pytest.raises(ValueError):
        codec_mod.byteplane_forward(_rand(16), 0)
    with pytest.raises(ValueError):
        codec_mod.byteplane_inverse(_rand(16), -2)


def test_byteplane_ragged_tail_passes_through():
    u8 = _rand(4 * 10 + 3, seed=1)
    t = codec_mod.byteplane_forward(u8, 4)
    np.testing.assert_array_equal(t[-3:], u8[-3:])


@pytest.mark.parametrize("k", refbp.ITEMSIZES)
@pytest.mark.parametrize("n", [0, 5, 63, 1000, 4097, 65549])
def test_byteplane_kernel_wrappers_match_oracle(n, k):
    """The reference's jnp and Pallas backend grids, through the port's
    kernel wrappers (K2 forward, K4 inverse) on CPU tensors."""
    import torch
    u8 = _rand(n, seed=n * 7 + k)
    t_ref = jcodec.byteplane_forward(u8, k)
    t = bp.forward_planes(torch.from_numpy(u8.copy()), k)
    np.testing.assert_array_equal(t.numpy(), t_ref)
    back = bp.inverse_planes(torch.from_numpy(t_ref.copy()), k)
    np.testing.assert_array_equal(back.numpy(), u8)


# ---------------------------------------------------------------------------
# the fused transform+scan dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "jnp", "pallas"])
def test_fused_scan_matches_oracle_of_transformed(backend):
    n, k = 3_000_000, 4
    u8 = _rand(n, seed=11)
    u8[n // 4:n // 4 + 50_000] = 3
    t_ref = jcodec.byteplane_forward(u8, k)
    cand_ref = jscan.scan_candidates_numpy(t_ref, MS, ML)
    sc = GearScanner(MS, ML, backend=backend, device="cpu")
    (strict, loose), t = sc.scan_transform_async(u8, k).result()
    np.testing.assert_array_equal(np.asarray(t), t_ref)
    np.testing.assert_array_equal(strict, cand_ref[0])
    np.testing.assert_array_equal(loose, cand_ref[1])
    assert len(cand_ref[1]) > 0


@pytest.mark.parametrize("n", [0, 5, 64, 1000])
def test_fused_scan_tiny_payloads(n):
    u8 = _rand(n, seed=n)
    sc = GearScanner(MS, ML, backend="jnp", device="cpu")
    (strict, loose), t = sc.scan_transform_async(u8, 2).result()
    np.testing.assert_array_equal(np.asarray(t),
                                  jcodec.byteplane_forward(u8, 2))
    ref = jscan.scan_candidates_numpy(jcodec.byteplane_forward(u8, 2),
                                      MS, ML)
    np.testing.assert_array_equal(strict, ref[0])
    np.testing.assert_array_equal(loose, ref[1])


@pytest.mark.parametrize("n", [1000, 3_000_000])
def test_transform_async_matches_oracle(n):
    u8 = _rand(n, seed=n)
    t = cdc_scan.transform_async(u8, 4, "cpu").result()
    np.testing.assert_array_equal(t, jcodec.byteplane_forward(u8, 4))


# ---------------------------------------------------------------------------
# staging arena (keyed by size and pinning in the port)
# ---------------------------------------------------------------------------

def test_staging_arena_recycles_after_extraction():
    sc = GearScanner(MS, ML, backend="jnp", device="cpu")
    sc.scan_async(_rand(3_000_000, seed=2)).result()
    keys = [key for key, bufs in cdc_scan._ARENA._free.items() if bufs]
    assert keys, "no staging buffer returned to the arena"
    n, pinned = keys[0]
    before = len(cdc_scan._ARENA._free[keys[0]])
    buf = cdc_scan._ARENA.acquire(n, pinned)
    assert buf.numel() == n
    assert len(cdc_scan._ARENA._free[keys[0]]) == before - 1
    cdc_scan._ARENA.release(buf)


def test_staging_arena_bounds_pool():
    arena = cdc_scan._StagingArena()
    bufs = [arena.acquire(1024, False)
            for _ in range(arena.MAX_PER_SIZE + 3)]
    for b in bufs:
        arena.release(b)
    assert len(arena._free[(1024, False)]) == arena.MAX_PER_SIZE


# ---------------------------------------------------------------------------
# codec entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8", "float16"])
def test_byteplane_codec_round_trip(dtype):
    rng = np.random.default_rng(5)
    arr = (rng.standard_normal(4099) * 0.1).astype(dtype) \
        if dtype != "int8" else rng.integers(-127, 128, 4099, dtype=np.int8)
    payload, meta = codec_mod.encode(arr, "byteplane")
    assert meta == {"bp": arr.dtype.itemsize}
    assert len(payload) == arr.nbytes
    assert bytes(payload) == bytes(jcodec.encode(arr, "byteplane")[0])
    back = codec_mod.decode(payload, "byteplane", arr.shape, str(arr.dtype),
                            meta)
    np.testing.assert_array_equal(back, arr)


def test_encode_preconditioned_matches_host_encoder():
    arr = (np.random.default_rng(6).standard_normal(8192) * 0.02) \
        .astype(np.float32)
    t = codec_mod.byteplane_forward(codec_mod.contig_u8(arr),
                                    arr.dtype.itemsize)
    host, _ = codec_mod.encode(arr, "byteplane")
    assert bytes(codec_mod.encode_preconditioned(t, "byteplane")) == host


@pytest.mark.skipif(not codec_mod.HAVE_ZSTD, reason="zstandard not installed")
def test_byteplane_zstd_round_trip_and_equivalence():
    arr = (np.random.default_rng(8).standard_normal(16384) * 0.02) \
        .astype(np.float32)
    payload, meta = codec_mod.encode(arr, "byteplane-zstd")
    assert bytes(payload) == bytes(jcodec.encode(arr, "byteplane-zstd")[0])
    back = codec_mod.decode(payload, "byteplane-zstd", arr.shape,
                            "float32", meta)
    np.testing.assert_array_equal(back, arr)
    t = codec_mod.byteplane_forward(codec_mod.contig_u8(arr), 4)
    assert codec_mod.encode_preconditioned(t, "byteplane-zstd") == payload


def test_byteplane_availability():
    assert codec_mod.available("byteplane")
    assert codec_mod.available("byteplane-zstd") == codec_mod.HAVE_ZSTD
    assert not codec_mod.lossy("byteplane")
    assert not codec_mod.lossy("byteplane-zstd")


def test_decode_falls_back_to_dtype_itemsize_without_meta():
    arr = np.arange(512, dtype=np.float32)
    payload, _ = codec_mod.encode(arr, "byteplane")
    back = codec_mod.decode(payload, "byteplane", arr.shape, "float32", {})
    np.testing.assert_array_equal(back, arr)


@pytest.mark.skipif(not codec_mod.HAVE_ZSTD, reason="zstandard not installed")
def test_zstd_encode_has_no_double_copy():
    import tracemalloc
    arr = np.random.default_rng(9).integers(
        0, 256, 8 << 20, dtype=np.uint8).view(np.float32)
    codec_mod.encode(arr, "zstd")
    tracemalloc.start()
    payload, _ = codec_mod.encode(arr, "zstd")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < int(arr.nbytes * 1.5), (peak, arr.nbytes)


def test_codec_policy_accepts_byteplane_names():
    CodecPolicy(codec="byteplane")
    CodecPolicy(codec="byteplane-zstd", params_codec="byteplane")
    with pytest.raises(ValueError):
        CodecPolicy(codec="byteplanes")


def test_device_precondition_resolution():
    auto = CodecPolicy(codec="byteplane")
    assert auto.precondition_enabled(serial=False) is True
    assert auto.precondition_enabled(serial=True) is False
    off = CodecPolicy(codec="byteplane", device_precondition=False)
    assert off.precondition_enabled(serial=False) is False
    on = CodecPolicy(codec="byteplane", device_precondition=True)
    assert on.precondition_enabled(serial=True) is False


def test_device_precondition_flat_and_env_overrides():
    p = CheckpointPolicy().with_overrides(codec="byteplane",
                                          device_precondition=False)
    assert p.codec.codec == "byteplane"
    assert p.codec.device_precondition is False
    p = CheckpointPolicy.from_env(
        {"REPRO_CKPT_DEVICE_PRECONDITION": "true",
         "REPRO_CKPT_CODEC": "byteplane"})
    assert p.codec.device_precondition is True
    assert p.codec.codec == "byteplane"


# ---------------------------------------------------------------------------
# test_byteplane.py: engine integration
# ---------------------------------------------------------------------------

def _np_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": (rng.standard_normal(400_000) * 0.02)
                       .astype(np.float32),
                       "b": rng.standard_normal(300).astype(np.float32)},
            "opt": {"m": rng.integers(0, 100, 5_000, dtype=np.int32)}}


def _flat(**flat):
    flat.setdefault("mode", "incremental")
    flat.setdefault("chunking", "cdc")
    flat.setdefault("chunk_size", 65536)
    return flat


def _mk(tmp_path, sub, **flat):
    return eng.mgr_at(tmp_path / sub, **_flat(**flat))


def _restores(mgr, step, st):
    restored, _ = mgr.restore(eng.abstract(eng.torch_state(st)), step=step)
    eng.assert_bits(restored, st)


def test_device_host_serial_paths_write_identical_manifests(tmp_path):
    st = _np_state()
    mans = {}
    for name, flat in [
        ("dev", dict(io_threads=4, device_precondition=True)),
        ("host", dict(io_threads=4, device_precondition=False)),
        ("serial", dict(io_threads=1)),
    ]:
        m = _mk(tmp_path, name, codec="byteplane", **flat)
        m.save(eng.torch_state(st), 1)
        mans[name] = refbp._records(m.load_manifest(1))
        _restores(m, 1, st)
        m.close()
    assert mans["dev"] == mans["host"], \
        "device pre-conditioning changed the stored bytes"
    assert mans["dev"] == mans["serial"], \
        "serial engine drifted from the pipelined chunk grid"
    jm = eng.jmgr_at(tmp_path / "ref", **_flat(codec="byteplane",
                                               io_threads=4,
                                               device_precondition=True))
    jm.save(eng.jax_state(st), 1)
    assert mans["dev"] == refbp._records(jm.load_manifest(1))
    eng.assert_same_store(tmp_path / "dev", tmp_path / "ref")
    jm.close()


def test_serial_engine_never_touches_device_path(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("device pre-conditioning ran on the serial "
                             "engine")
    monkeypatch.setattr(save_path.SaveSession, "submit_preconditioned", boom)
    monkeypatch.setattr(cdc_scan, "transform_async", boom)
    m = _mk(tmp_path, "serial", codec="byteplane", io_threads=1)
    st = _np_state()
    m.save(eng.torch_state(st), 1)
    _restores(m, 1, st)
    m.close()


def test_fused_path_actually_engages(tmp_path, monkeypatch):
    calls = []
    orig = GearScanner.scan_transform_async

    def spy(self, payload, itemsize):
        calls.append(len(payload))
        return orig(self, payload, itemsize)
    monkeypatch.setattr(GearScanner, "scan_transform_async", spy)
    m = _mk(tmp_path, "dev", codec="byteplane", io_threads=4,
            device_precondition=True)
    rng = np.random.default_rng(0)
    st = {"params": {"w": (rng.standard_normal(900_000) * 0.02)
                     .astype(np.float32)}}
    m.save(eng.torch_state(st), 1)
    m.close()
    assert calls and max(calls) >= cdc_scan.MIN_ACCEL_BYTES, \
        "fused scan_transform_async never invoked"


def test_save_restore_byteplane_with_replicas_and_second_save(tmp_path):
    flat = dict(codec="byteplane", io_threads=4, n_writers=2, replicas=2,
                retain=2)
    m = _mk(tmp_path, "bb", **flat)
    jm = eng.jmgr_at(tmp_path / "ref", **_flat(**flat))
    s1, s2 = _np_state(1), _np_state(2)
    for step, st in ((1, s1), (2, s2)):
        eng.save_both(tmp_path, st, step, port=m, jax_mgr=jm)
    m.gc()
    jm.gc()
    for step, st in ((1, s1), (2, s2)):
        _restores(m, step, st)
    eng.assert_same_store(tmp_path / "bb", tmp_path / "ref")
    m.close()
    jm.close()


@pytest.mark.skipif(not codec_mod.HAVE_ZSTD, reason="zstandard not installed")
def test_save_restore_byteplane_zstd_end_to_end(tmp_path):
    m = _mk(tmp_path, "bbz", codec="byteplane-zstd", io_threads=4)
    st = _np_state(3)
    rep = m.save(eng.torch_state(st), 1)
    assert rep["payload_bytes"] < rep["bytes"]
    _restores(m, 1, st)
    m.close()


def test_manifest_adoption_keeps_readers_device_precondition(tmp_path):
    st = _np_state()
    w = _mk(tmp_path, "adopt", codec="byteplane", io_threads=4,
            device_precondition=True)
    w.save(eng.torch_state(st), 1)
    w.close()
    r = eng.mgr_at(tmp_path / "adopt", mode="incremental", chunking="cdc",
                   chunk_size=65536, codec="raw", io_threads=4,
                   device_precondition=False)
    _restores(r, 1, st)
    assert r.codec == "byteplane"
    assert r.policy.codec.device_precondition is False
    assert r.device_precondition is False
    r.close()


# ---------------------------------------------------------------------------
# test_entropy.py: the oracle, the framing, the device route's grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", refent.SIZES)
def test_oracle_stream_round_trip(n, kind, codec):
    u8 = refent._payload(n, kind, seed=n + len(kind))
    enc, bl = codec_mod.plane_stream_encode(u8, codec)
    ref, ref_bl = jcodec.plane_stream_encode(u8, codec)
    np.testing.assert_array_equal(enc, ref)
    np.testing.assert_array_equal(bl, ref_bl)
    np.testing.assert_array_equal(
        codec_mod.plane_stream_decode(enc, n, codec), u8)
    enc2, _ = codec_mod.plane_stream_encode(u8.copy(), codec)
    np.testing.assert_array_equal(enc, enc2)


@pytest.mark.parametrize("codec", CODECS)
def test_block_framing_and_escape_semantics(codec):
    u8 = np.concatenate([refent._payload(ENTROPY_BLOCK, "random", seed=1),
                         refent._payload(ENTROPY_BLOCK, "zeros"),
                         refent._payload(ENTROPY_BLOCK, "skewed", seed=2)])
    enc, _ = codec_mod.plane_stream_encode(u8, codec)
    stats = list(codec_mod.entropy_block_stats(enc, len(u8)))
    assert stats == list(jcodec.entropy_block_stats(enc, len(u8)))
    assert len(stats) == 3
    flags = [s[2] for s in stats]
    assert flags[0] == 0
    assert flags[1] != 0
    if codec == "byteplane-rans":
        assert 2 in flags
    for _off, blen, flag, enc_len in stats:
        if flag == 0:
            assert enc_len == blen
        else:
            assert enc_len < blen
    assert len(enc) == sum(3 + s[3] for s in stats)


@pytest.mark.parametrize("codec", CODECS)
def test_raw_escape_bounds_expansion(codec):
    u8 = refent._payload(1 << 20, "random", seed=9)
    enc, _ = codec_mod.plane_stream_encode(u8, codec)
    nb = -(-len(u8) // ENTROPY_BLOCK)
    assert len(enc) <= len(u8) + 3 * nb


def test_rle_run_cap_crosses_255():
    u8 = np.full(ENTROPY_BLOCK, 7, dtype=np.uint8)
    enc, _ = codec_mod.plane_stream_encode(u8, "byteplane-rle")
    (_, _, flag, enc_len), = codec_mod.entropy_block_stats(enc, len(u8))
    assert flag == 1 and enc_len == 2 * (-(-ENTROPY_BLOCK // 255))
    np.testing.assert_array_equal(
        codec_mod.plane_stream_decode(enc, len(u8), "byteplane-rle"), u8)


@pytest.mark.parametrize("codec", CODECS)
def test_decode_rejects_corrupt_framing(codec):
    u8 = refent._payload(8192, "skewed", seed=3)
    enc = codec_mod.plane_stream_encode(u8, codec)[0].copy()
    enc[0] = 9
    with pytest.raises(ValueError):
        codec_mod.plane_stream_decode(enc, len(u8), codec)
    with pytest.raises(ValueError):
        codec_mod.plane_stream_decode(enc[:-5], len(u8), codec)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1, 255, 4095, 4096, 4097, 65549])
def test_device_entropy_route_matches_oracle(n, kind, codec):
    """The reference's jnp grid (its Pallas grid is a subset of it), through
    the port's device entropy stage: K3 and the glue on the CPU."""
    u8 = refent._payload(n, kind, seed=n * 3 + 1)
    ref, _ = jcodec.plane_stream_encode(u8, codec)
    stream, block_lens = ent.encode_stream(u8, codec, device="cpu")
    np.testing.assert_array_equal(stream, ref)
    stats = list(jcodec.entropy_block_stats(ref, n))
    np.testing.assert_array_equal(block_lens,
                                  np.array([3 + s[3] for s in stats],
                                           dtype=np.int64))


@pytest.mark.parametrize("k", refent.ITEMSIZES)
def test_backends_on_byteplaned_itemsizes(k):
    rng = np.random.default_rng(k)
    raw = rng.integers(0, 256, 13 * ENTROPY_BLOCK + 3, dtype=np.uint8)
    raw[: 6 * ENTROPY_BLOCK] = (raw[: 6 * ENTROPY_BLOCK] % 5) * 17
    t = codec_mod.byteplane_forward(raw, k)
    for codec in CODECS:
        ref, _ = jcodec.plane_stream_encode(t, codec)
        got, _ = ent.encode_stream(t, codec, device="cpu")
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            codec_mod.plane_stream_decode(ref, t.size, codec), t)


@pytest.mark.parametrize("codec", CODECS)
def test_chunk_encodings_are_slices_of_the_stream(codec):
    ck = GearChunker(16384, scan_backend="numpy", device="cpu")
    t = refent._payload(300_001, "planes", seed=11)
    cuts = ck.align_cuts(ck.cut_points(t), len(t), ENTROPY_BLOCK)
    jck = JGearChunker(16384, scan_backend="numpy")
    assert cuts == jck.align_cuts(jck.cut_points(t), len(t), ENTROPY_BLOCK)
    assert len(cuts) > 3 and cuts[-1] == len(t)
    whole, _ = codec_mod.plane_stream_encode(t, codec)
    parts, pos = [], 0
    for c in cuts:
        parts.append(codec_mod.plane_encode_chunk(t[pos:c], codec))
        pos = c
    assert b"".join(parts) == whole.tobytes()
    enc_lens = [len(p) for p in parts]
    raw_lens = np.diff([0] + cuts).tolist()
    back = codec_mod.plane_decode_chunks(whole, enc_lens, raw_lens, codec)
    np.testing.assert_array_equal(back, t)


def test_align_cuts_properties():
    cuts = [1, 4096, 5000, 12289, 20000]
    out = GearChunker.align_cuts(cuts, 20000, ENTROPY_BLOCK)
    assert out == [4096, 8192, 16384, 20000]
    assert all(c % ENTROPY_BLOCK == 0 or c == 20000 for c in out)
    assert GearChunker.align_cuts([], 0, ENTROPY_BLOCK) == []


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_codec_entry_round_trip(dtype, codec):
    rng = np.random.default_rng(4)
    arr = rng.integers(-127, 128, 4099, dtype=np.int8) if dtype == "int8" \
        else (rng.standard_normal(4099) * 0.02).astype(dtype)
    payload, meta = codec_mod.encode(arr, codec)
    assert meta == {"bp": arr.dtype.itemsize}
    assert bytes(payload) == bytes(jcodec.encode(arr, codec)[0])
    back = codec_mod.decode(payload, codec, arr.shape, dtype, meta)
    np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("codec", CODECS)
def test_chunk_encoded_availability_and_classes(codec):
    assert codec in codec_mod.CODECS
    assert codec in codec_mod.PRECONDITIONED
    assert codec in codec_mod.CHUNK_ENCODED
    assert codec_mod.available(codec)
    assert not codec_mod.lossy(codec)


def test_compresses_real_float_payloads():
    rng = np.random.default_rng(12)
    arr = (rng.standard_normal(1 << 16) * 0.02).astype(np.float32)
    rans, _ = codec_mod.encode(arr, "byteplane-rans")
    assert len(rans) < arr.nbytes * 0.90
    rle, _ = codec_mod.encode(arr, "byteplane-rle")
    nb = -(-arr.nbytes // ENTROPY_BLOCK)
    assert len(rle) <= arr.nbytes + 3 * nb


# ---------------------------------------------------------------------------
# test_cdc_scan.py: candidate parity, cut points, the scanner API
# ---------------------------------------------------------------------------

def _masks(avg=1024):
    ck = GearChunker(avg, device="cpu")
    return int(ck.mask_strict), int(ck.mask_loose)


def _assert_scan_parity(scanner, payload):
    """The port's candidates equal the reference's numpy oracle's."""
    s, l_ = scanner.scan(payload)
    rs, rl = jscan.scan_candidates_numpy(_u8(payload), scanner.mask_strict,
                                         scanner.mask_loose)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(l_, rl)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("size", [
    0, 1, WINDOW - 1, WINDOW, WINDOW + 1, 256, 1024, 65_536, 300_000,
    cdc_scan.SEGMENT_BYTES + 12_345,
    cdc_scan.SEGMENT_BYTES * (cdc_scan.MAX_INFLIGHT_SEGMENTS + 1) + 54_321,
])
def test_candidate_parity(size, backend, rng):
    """The reference's jnp sizes (segment cuts and the windowed re-dispatch
    included) through the port's plain route and its kernel route."""
    ms, ml = _masks()
    _assert_scan_parity(GearScanner(ms, ml, backend=backend, device="cpu"),
                        rng.bytes(size))


def test_parity_fuzz(rng):
    for avg in (512, 4096):
        ms, ml = _masks(avg)
        sc = GearScanner(ms, ml, backend="jnp", device="cpu")
        for _ in range(10):
            _assert_scan_parity(sc, rng.bytes(int(rng.integers(0, 200_000))))
    ms, ml = _masks()
    sc = GearScanner(ms, ml, backend="jnp", device="cpu")
    B = jscan.BLOCK
    for size in (B - 1, B, B + 1, 64 * B - 1, 64 * B, 64 * B + 1):
        _assert_scan_parity(sc, rng.bytes(size))


@pytest.mark.parametrize("fill", [b"\x00", b"\xa7"])
def test_low_entropy_payload_parity(fill):
    ms, ml = _masks()
    _assert_scan_parity(GearScanner(ms, ml, backend="jnp", device="cpu"),
                        fill * 100_000)


def test_cut_point_parity_through_chunker(rng):
    for payload in (b"", rng.bytes(WINDOW - 1), rng.bytes(256),
                    rng.bytes(100_000), b"\x00" * 50_000,
                    rng.bytes(1 << 20)):
        ref = JGearChunker(1024).cut_points(payload)
        assert GearChunker(1024, device="cpu").cut_points(payload) == ref
        ck = GearChunker(1024, scan_backend="jnp", device="cpu")
        assert ck.cut_points(payload) == ref
        assert b"".join(ck.chunk(payload)) == payload


def test_scan_async_matches_sync(rng):
    ms, ml = _masks()
    sc = GearScanner(ms, ml, backend="jnp", device="cpu")
    payloads = [rng.bytes(n) for n in (50_000, 120_000, 80_000)]
    tickets = [sc.scan_async(p) for p in payloads]
    assert all(isinstance(t, ScanTicket) for t in tickets)
    for t, p in zip(tickets, payloads):
        s, l_ = t.result()
        rs, rl = sc.scan(p)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(l_, rl)
        s2, l2 = t.result()
        assert s2 is s and l2 is l_


def test_auto_backend_size_gate():
    ms, ml = _masks()
    sc = GearScanner(ms, ml, backend="auto", device="cpu")
    assert sc.resolve(1000) == "numpy"
    assert sc.resolve(cdc_scan.MIN_ACCEL_BYTES) == "jnp"


def test_pallas_on_a_cpu_device_runs_the_plain_versions(rng):
    """The reference resolves ``pallas`` to ``jnp`` without an accelerator;
    the port keeps ``pallas`` on a CPU device, where its kernel wrappers
    take their plain versions (no launch is counted), with the same
    candidates."""
    ms, ml = _masks()
    sc = GearScanner(ms, ml, backend="pallas", device="cpu")
    assert sc.resolve(1 << 20) == "pallas"
    before = cdc_scan.launches
    _assert_scan_parity(sc, rng.bytes(50_000))
    assert cdc_scan.launches == before


def test_invalid_backend_rejected():
    ms, ml = _masks()
    with pytest.raises(ValueError):
        GearScanner(ms, ml, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        GearChunker(1024, scan_backend="nope", device="cpu")
    with pytest.raises(ValueError):
        GearScanner(0x0F, 0xF0, device="cpu")


def test_oracle_matches_legacy_semantics(rng):
    ms, ml = _masks()
    s, l_ = scan_candidates_numpy(_u8(rng.bytes(WINDOW)), ms, ml)
    assert len(s) == 0 and len(l_) == 0
    data = _u8(rng.bytes(100_000))
    s, l_ = scan_candidates_numpy(data, ms, ml)
    assert set(s) <= set(l_)
    if len(l_):
        assert l_.min() >= WINDOW and l_.max() <= len(data)
    rs, rl = jscan.scan_candidates_numpy(data, ms, ml)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(l_, rl)


def test_chunk_returns_zero_copy_views(rng):
    payload = rng.bytes(100_000)
    chunks = GearChunker(1024, device="cpu").chunk(payload)
    assert all(isinstance(c, memoryview) for c in chunks)
    assert all(c.obj is payload for c in chunks)
    assert b"".join(chunks) == payload


def test_chunk_accepts_ndarray_views(rng):
    arr = _u8(rng.bytes(64_000))
    chunks = GearChunker(1024, device="cpu").chunk(arr)
    assert b"".join(chunks) == arr.tobytes()
    assert all(np.shares_memory(np.frombuffer(c, np.uint8), arr)
               for c in chunks)
