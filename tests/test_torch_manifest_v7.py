"""Manifest v7 in the port, held to the cases of ``tests/test_manifest_v7.py``
that ``tests/test_torch_manifest_history.py`` does not hold: raw and
encoded chunk lengths (both chunk-encoded codecs × both chunkings), the
save report's encoded bytes, device / host-entropy / serial writers giving
identical manifests, the serial engine's purity and the fused dispatch,
policy adoption that keeps the reader's device-entropy knob, the crash
between the fused dispatch and chunk submission, the mixed v5/v6/v7 and
zstd histories with a GC that leaks nothing, and the inspector's entropy
planes. (Direct placement of encoded chunks, its damage fallback and the
future-format rejection are held there, at ``:115``, ``:136`` and
``:198``.)

The reference's own ``_state``, ``_records`` and ``_downgrade`` make the
inputs and read the manifests. Where the reference defines bytes the JAX
package writes the same state under the same policy: its chunk records
and CAS objects must equal the port's. The port's managers run on the
CPU, so the device routes take their kernels' plain versions."""
import json

import jax
import numpy as np
import pytest

import test_manifest_v7 as ref
import test_torch_checkpoint_engine as eng
from repro_torch.core import cas, cdc_scan
from repro_torch.core import codec as codec_mod
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.cdc_scan import GearScanner
from repro_torch.core.checkpoint import FORMAT_VERSION
from repro_torch.core.errors import AbortedError
from repro_torch.kernels.ckpt_codec import entropy as ent
from repro_torch.launch.inspect_ckpt import inspect


def _np_state(seed=0):
    """``test_manifest_v7._state(seed)`` as numpy arrays."""
    return jax.tree.map(np.asarray, ref._state(seed))


def _flat(**kw):
    kw.setdefault("codec", "byteplane-rans")
    kw.setdefault("n_writers", 2)
    kw.setdefault("mode", "incremental")
    kw.setdefault("chunking", "cdc")
    kw.setdefault("chunk_size", 65536)
    kw.setdefault("io_threads", 4)
    return kw


def _writer(tmp_path, sub="fast", **kw):
    return eng.mgr_at(tmp_path / sub, **_flat(**kw))


def _jwriter(tmp_path, sub="fast", **kw):
    return eng.jmgr_at(tmp_path / "ref" / sub, **_flat(**kw))


def _restores(mgr, step, st):
    restored, _ = mgr.restore(eng.abstract(eng.torch_state(st)), step=step)
    eng.assert_bits(restored, st)


def _save(mgr, st, step, **kw):
    return mgr.save(eng.torch_state(st), step, **kw)


# ---------------------------------------------------------------------------
# the v7 record shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunking", ["cdc", "fixed"])
@pytest.mark.parametrize("codec", ["byteplane-rle", "byteplane-rans"])
def test_v7_records_carry_raw_and_encoded_lengths(tmp_path, codec,
                                                  chunking):
    st = _np_state()
    mgr = _writer(tmp_path, codec=codec, chunking=chunking)
    _save(mgr, st, 1)
    m = json.loads(ref._manifest_path(mgr.store.root, 1).read_text())
    assert m["format"] == FORMAT_VERSION == 7
    seen = 0
    for spec in m["leaves"].values():
        for s in spec["shards"]:
            if s["codec"] not in codec_mod.CHUNK_ENCODED:
                continue
            seen += 1
            assert len(s["chunk_raw_lens"]) == len(s["chunk_lens"]) \
                == len(s["chunks"])
            assert sum(s["chunk_lens"]) == s["payload_bytes"]
            assert sum(s["chunk_raw_lens"]) == s["raw_payload_bytes"]
            assert all(n > 0 for n in s["chunk_lens"])
            assert all(n > 0 for n in s["chunk_raw_lens"])
            raw = np.cumsum(s["chunk_raw_lens"])
            assert all(int(c) % codec_mod.ENTROPY_BLOCK == 0
                       for c in raw[:-1])
    assert seen, "no chunk-encoded shard records written"
    w = m["leaves"]["params/w"]["shards"][0]
    if codec == "byteplane-rans":
        assert w["payload_bytes"] < w["raw_payload_bytes"]
    _restores(mgr, 1, st)
    jm = _jwriter(tmp_path, codec=codec, chunking=chunking)
    jm.save(eng.jax_state(st), 1)
    eng.assert_same_store(mgr.store.root, jm.store.root)
    mgr.close()
    jm.close()


def test_save_report_counts_encoded_bytes(tmp_path):
    mgr = _writer(tmp_path)
    jm = _jwriter(tmp_path)
    st = _np_state()
    rep = _save(mgr, st, 1)
    jrep = jm.save(eng.jax_state(st), 1)
    assert rep["payload_bytes"] < rep["bytes"]
    for key in ("payload_bytes", "bytes", "chunks", "new_object_bytes"):
        assert rep[key] == jrep[key], key
    mgr.close()
    jm.close()


# ---------------------------------------------------------------------------
# engine identity and serial purity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["byteplane-rle", "byteplane-rans"])
def test_device_host_serial_write_identical_v7_manifests(tmp_path, codec):
    """The device entropy route (its plain versions here), the host route
    and the serial engine write one set of records, the reference's."""
    st = _np_state()
    mans = {}
    for name, flat in [
        ("dev", dict(io_threads=4, device_entropy=True)),
        ("host", dict(io_threads=4, device_entropy=False)),
        ("serial", dict(io_threads=1)),
    ]:
        m = _writer(tmp_path, name, codec=codec, **flat)
        _save(m, st, 1)
        mans[name] = ref._records(m.load_manifest(1))
        _restores(m, 1, st)
        m.close()
    assert mans["dev"] == mans["host"], \
        "device entropy coding changed the stored bytes"
    assert mans["dev"] == mans["serial"], \
        "serial engine drifted from the pipelined encoded-chunk grid"
    jm = _jwriter(tmp_path, codec=codec, device_entropy=True)
    jm.save(eng.jax_state(st), 1)
    assert mans["dev"] == ref._records(jm.load_manifest(1))
    jm.close()


def test_serial_engine_never_touches_device_entropy(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("device entropy stage ran on the serial "
                             "engine")
    monkeypatch.setattr(GearScanner, "scan_transform_encode_async", boom)
    monkeypatch.setattr(cdc_scan, "transform_async", boom)
    monkeypatch.setattr(ent, "encode_stream", boom)
    mgr = _writer(tmp_path, io_threads=1)
    st = _np_state()
    _save(mgr, st, 1)
    _restores(mgr, 1, st)
    mgr.close()


def test_fused_entropy_dispatch_actually_engages(tmp_path, monkeypatch):
    calls = []
    orig = GearScanner.scan_transform_encode_async

    def spy(self, payload, itemsize, entropy_codec):
        calls.append(len(payload))
        return orig(self, payload, itemsize, entropy_codec)
    monkeypatch.setattr(GearScanner, "scan_transform_encode_async", spy)
    mgr = _writer(tmp_path, io_threads=4, device_entropy=True)
    rng = np.random.default_rng(0)
    st = {"params": {"w": (rng.standard_normal(900_000) * 0.02)
                     .astype(np.float32)}}
    _save(mgr, st, 1)
    _restores(mgr, 1, st)
    mgr.close()
    assert calls and max(calls) >= cdc_scan.MIN_ACCEL_BYTES, \
        "fused scan_transform_encode_async never invoked"


def test_adoption_keeps_readers_device_entropy(tmp_path):
    st = _np_state()
    w = _writer(tmp_path, "adopt", device_entropy=True)
    _save(w, st, 1)
    w.close()
    r = eng.mgr_at(tmp_path / "adopt", mode="incremental", chunking="cdc",
                   chunk_size=65536, codec="raw", io_threads=4,
                   device_entropy=False)
    _restores(r, 1, st)
    assert r.codec == "byteplane-rans"
    assert r.policy.codec.device_entropy is False
    assert r.device_entropy is False
    r.close()


# ---------------------------------------------------------------------------
# crash matrix extension: die between fused dispatch and chunk submission
# ---------------------------------------------------------------------------

def test_crash_between_fused_dispatch_and_chunk_submission(tmp_path):
    states = {s: _np_state(s) for s in (1, 2, 3)}

    def mk():
        return _writer(tmp_path, retain=4, max_retries=0)

    _save(mk(), states[1], 1)
    with pytest.raises((CrashPoint, AbortedError)):
        _save(mk(), states[2], 2,
              crash=CrashInjector("rank0_after_fused_dispatch"))
    mgr = mk()
    mgr.gc()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    assert mgr.latest_step() == 1
    _restores(mgr, 1, states[1])
    _save(mgr, states[3], 3)
    _restores(mgr, 3, states[3])
    # the reference, through the same crash and recovery, holds the same
    # committed bytes
    jm = _jwriter(tmp_path, retain=4, max_retries=0)
    jm.save(eng.jax_state(states[1]), 1)
    with pytest.raises((ref.CrashPoint, ref.AbortedError)):
        _jwriter(tmp_path, retain=4, max_retries=0).save(
            eng.jax_state(states[2]), 2,
            crash=ref.CrashInjector("rank0_after_fused_dispatch"))
    jm = _jwriter(tmp_path, retain=4, max_retries=0)
    jm.gc()
    jm.save(eng.jax_state(states[3]), 3)
    eng.assert_same_store(mgr.store.root, jm.store.root)
    mgr.close()
    jm.close()


# ---------------------------------------------------------------------------
# cross-version history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ladder", [
    ("raw", "byteplane"),
    pytest.param(("zstd", "byteplane-zstd"), marks=pytest.mark.skipif(
        not codec_mod.HAVE_ZSTD, reason="zstandard not installed"))],
    ids=["v5raw_v6byteplane", "v5zstd_v6byteplane_zstd"])
def test_mixed_v5_v6_v7_history_restores_and_gc_leaks_nothing(tmp_path,
                                                              ladder):
    """A v7-rans step over a v6 step over a v5 step (the raw ladder, and
    the zstd ladder of ``test_mixed_zstd_history_restores_bit_exact``):
    every step restores bit-exact under the port, and mark-and-sweep over
    the mixed history reclaims an orphan without touching live chunks."""
    states = {s: _np_state(s) for s in (1, 2, 3)}
    w1 = _writer(tmp_path, codec=ladder[0], retain=8)
    _save(w1, states[1], 1)
    w1.close()
    ref._downgrade(tmp_path / "fast", 1, 5)
    w2 = _writer(tmp_path, codec=ladder[1], retain=8)
    _save(w2, states[2], 2)
    w2.close()
    ref._downgrade(tmp_path / "fast", 2, 6)
    mgr = _writer(tmp_path, codec="byteplane-rans", retain=8)
    _save(mgr, states[3], 3)
    orphan = mgr.store.fast.root / cas.object_rel("ff" * 16)
    orphan.parent.mkdir(parents=True, exist_ok=True)
    orphan.write_bytes(b"junk")
    mgr.gc()
    assert not orphan.exists()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    for step, fmt in ((1, 5), (2, 6), (3, 7)):
        assert mgr.load_manifest(step)["format"] == fmt
        _restores(mgr, step, states[step])
    mgr.close()


def test_inspector_reports_entropy_planes(tmp_path):
    """The port's inspector over a v7 step: per-plane raw/encoded bytes
    and escape counts, the same report as the reference's inspector over
    the reference's checkpoint of the same state."""
    from repro.launch.inspect_ckpt import inspect as jinspect
    st = _np_state()
    mgr = _writer(tmp_path)
    _save(mgr, st, 1)
    mgr.close()
    rep = inspect(tmp_path / "fast", verify=True, out=lambda *a: None)
    assert rep["ok"], rep["problems"]
    planes = rep["entropy_planes"]["byteplane-rans"]
    assert set(planes) >= {"0", "1", "2", "3"}
    assert any(p["rans_blocks"] for p in planes.values())
    assert any(p["raw_escape_blocks"] for p in planes.values())
    for p in planes.values():
        assert p["blocks"] == p["raw_escape_blocks"] + p["rle_blocks"] \
            + p["rans_blocks"]
        assert 0 < p["encoded_bytes"] <= p["raw_bytes"] + 3 * p["blocks"]
    jm = _jwriter(tmp_path)
    jm.save(eng.jax_state(st), 1)
    jm.close()
    jrep = jinspect(tmp_path / "ref" / "fast", verify=True,
                    out=lambda *a: None)
    assert rep["entropy_planes"] == jrep["entropy_planes"]
