"""The save routes the port completes beside the fused RLE dispatch —
``transform_async``, ``GearScanner.scan_transform_async`` and the
``byteplane-rans`` device entropy stage — against the JAX package's on
shared numpy fixtures, byte for byte; then whole saves through the four
policies that reach them, whose manifest leaf records and CAS objects must
equal the JAX package's. The port runs on a CPU manager, so its kernel
wrappers take their plain versions."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from repro.core import cdc_scan as jscan
from repro.core import codec as jcodec
from repro.core import policy as jpolicy
from repro.core.cdc import GearChunker as JGearChunker
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.kernels.ckpt_codec import entropy as jent
from repro_torch.convert import from_jax_state
from repro_torch.core import cdc_scan as tscan
from repro_torch.core import policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.kernels.ckpt_codec import entropy as tent

ACCEL = jscan.MIN_ACCEL_BYTES


def _payload(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "skewed":            # few symbols: rANS wins these blocks
        return rng.geometric(0.3, n).astype(np.uint8)
    f = (rng.standard_normal(-(-n // 4)) * 0.02).astype(np.float32)
    return jcodec.contig_u8(f)[:n].copy()


def _masks(avg=4096):
    ck = JGearChunker(avg)
    return int(ck.mask_strict), int(ck.mask_loose)


@pytest.mark.parametrize("size", [1000, ACCEL + 1234])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_transform_async_matches_jax(size, itemsize):
    data = _payload(size, "floats", seed=size)
    ref = jscan.transform_async(data, itemsize).result()
    got = tscan.transform_async(data, itemsize, "cpu").result()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size,kind", [(ACCEL + 4097, "floats"),
                                       (ACCEL, "zeros"), (5000, "random")])
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_scan_transform_async_matches_jax(size, kind, backend):
    ms, ml = _masks()
    data = _payload(size, kind, seed=size)
    (rs, rl), rt = jscan.GearScanner(ms, ml, backend="jnp") \
        .scan_transform_async(data, 2).result()
    (ps, pl_), pt = tscan.GearScanner(ms, ml, backend=backend,
                                      device="cpu") \
        .scan_transform_async(data, 2).result()
    np.testing.assert_array_equal(pt, rt)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl_, rl)


@pytest.mark.parametrize("kind", ["random", "zeros", "skewed", "floats"])
@pytest.mark.parametrize("size", [1, 4096, 4097, 30_001])
def test_rans_stage_matches_jax_and_oracle(kind, size):
    u8 = _payload(size, kind, seed=size + 3)
    ref_s, ref_bl = jent.encode_stream(u8, "byteplane-rans", backend="jnp")
    got_s, got_bl = tent.encode_stream(u8, "byteplane-rans", device="cpu")
    np.testing.assert_array_equal(got_s, ref_s)
    np.testing.assert_array_equal(got_bl, ref_bl)
    ora_s, ora_bl = jcodec.plane_stream_encode(u8, "byteplane-rans")
    np.testing.assert_array_equal(got_s, ora_s)
    np.testing.assert_array_equal(got_bl, ora_bl)


def test_fused_rans_dispatch_matches_jax():
    ms, ml = _masks()
    data = _payload(ACCEL + 999, "floats", seed=9)
    (rs, rl), rstream, rbl = jscan.GearScanner(ms, ml, backend="jnp") \
        .scan_transform_encode_async(data, 4, "byteplane-rans").result()
    (ps, pl_), pstream, pbl = tscan.GearScanner(
        ms, ml, backend="pallas", device="cpu") \
        .scan_transform_encode_async(data, 4, "byteplane-rans").result()
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl_, rl)
    np.testing.assert_array_equal(pstream, rstream)
    np.testing.assert_array_equal(pbl, rbl)


# ---------------------------------------------------------------------------
# whole saves through the four policies
# ---------------------------------------------------------------------------

POLICIES = {
    # CDC + device transform/scan, host entropy stage
    "device_entropy_off": dict(scheme="cdc", params_codec="byteplane-rle",
                               device_entropy=False),
    # fixed chunk grid: standalone device transform, host entropy stage
    "fixed_rle": dict(scheme="fixed", params_codec="byteplane-rle"),
    # the byteplane codec itself under CDC: transform fused with the scan
    "cdc_byteplane": dict(scheme="cdc", params_codec="byteplane"),
    # the rANS device entropy stage in the fused dispatch
    "rans": dict(scheme="cdc", params_codec="byteplane-rans"),
}


def _policy(mod, scheme, params_codec, device_entropy=None, backend="auto"):
    return mod.CheckpointPolicy(
        mode="incremental",
        chunking=mod.ChunkingPolicy(scheme=scheme, chunk_size=64 << 10,
                                    scan_backend=backend),
        pipeline=mod.PipelinePolicy(io_threads=4),
        durability=mod.DurabilityPolicy(keepalive_s=60.0),
        codec=mod.CodecPolicy(codec="raw", params_codec=params_codec,
                              device_entropy=device_entropy))


@pytest.fixture(scope="module")
def state_np():
    """Params past the acceleration threshold (so the device routes run),
    a small bf16 leaf (host route) and raw f32 moments."""
    rng = np.random.default_rng(21)
    embed = (rng.standard_normal((ACCEL // 256 + 33, 128)) * 0.02) \
        .astype(ml_dtypes.bfloat16)
    w = rng.standard_normal((300, 64)).astype(np.float32)
    return {"params": {"embed": embed, "w": w},
            "m": (rng.standard_normal(5000) * 1e-3).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_saves_match_jax_manifest_and_objects(tmp_path, state_np, name):
    kw = POLICIES[name]
    jmgr = JManager(JStore(JTier("fast", tmp_path / "jax")),
                    policy=_policy(jpolicy, **kw))
    jmgr.save({k: (jnp.asarray(v) if not isinstance(v, dict) else
                   {a: jnp.asarray(b) for a, b in v.items()})
               for k, v in state_np.items()}, 1)
    tmgr = CheckpointManager(TieredStore(Tier("fast", tmp_path / "port")),
                             _policy(tpolicy, backend="pallas", **kw),
                             device="cpu")
    state = from_jax_state(state_np, device="cpu")
    tmgr.save(state, 1)
    jm, tm = jmgr.load_manifest(1), tmgr.load_manifest(1)
    assert tm["leaves"] == jm["leaves"]
    assert tmgr.chunks.digests_on_disk() == jmgr.chunks.digests_on_disk()
    rec = tm["leaves"]["params/embed"]["shards"][0]
    assert rec["codec"] == kw["params_codec"]
    if kw["scheme"] == "cdc":
        assert len(rec["chunks"]) > 1
    got, _ = tmgr.restore(state)
    for a, b in ((got["params"]["embed"], state["params"]["embed"]),
                 (got["params"]["w"], state["params"]["w"])):
        assert a.dtype == b.dtype and a.equal(b)
    jmgr.close()
    tmgr.close()
