"""The port's host layer against the JAX package's, exactly: the gear
table, the policy block a manifest embeds, the codec oracles, CDC cut
points, leaf naming, and the bf16 host carrier that replaces ml_dtypes."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import cdc as jcdc
from repro.core import cdc_scan as jscan
from repro.core import codec as jcodec
from repro.core import policy as jpolicy
from repro.core.split_state import leaf_paths as jleaf_paths
from repro_torch.core import cdc as tcdc
from repro_torch.core import cdc_scan as tscan
from repro_torch.core import codec as tcodec
from repro_torch.core import policy as tpolicy
from repro_torch.core.split_state import leaf_paths, tree_unflatten
from repro_torch.devices import resolve_device

MiB = 1 << 20


def _slice_policy(mod, **chunking):
    chunking.setdefault("scan_backend", "auto")
    return mod.CheckpointPolicy(
        mode="incremental",
        chunking=mod.ChunkingPolicy(scheme="cdc", chunk_size=MiB,
                                    **chunking),
        pipeline=mod.PipelinePolicy(io_threads=8),
        codec=mod.CodecPolicy(codec="raw", params_codec="byteplane-rle"))


def test_gear_table_identical():
    np.testing.assert_array_equal(tscan.GEAR, jscan.GEAR)
    assert tscan.GEAR.dtype == jscan.GEAR.dtype
    assert (tscan.WINDOW, tscan.MIN_ACCEL_BYTES, tscan.SEGMENT_BYTES,
            tscan.PALLAS_BLOCK, tscan.BACKENDS) == \
        (jscan.WINDOW, jscan.MIN_ACCEL_BYTES, jscan.SEGMENT_BYTES,
         jscan.PALLAS_BLOCK, jscan.BACKENDS)


@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp", "numpy"])
def test_policy_dict_identical(backend):
    t = _slice_policy(tpolicy, scan_backend=backend)
    j = _slice_policy(jpolicy, scan_backend=backend)
    assert t.to_dict() == j.to_dict()
    assert tpolicy.CheckpointPolicy.from_dict(j.to_dict()) == t
    assert t.codec.resolved() == j.codec.resolved() == \
        ("raw", "byteplane-rle")


@pytest.mark.parametrize("itemsize", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("size", [0, 5, 4096, 100_003])
def test_byteplane_oracle_identical(itemsize, size, rng):
    u8 = rng.integers(0, 256, size, dtype=np.uint8)
    t = tcodec.byteplane_forward(u8, itemsize)
    np.testing.assert_array_equal(t, jcodec.byteplane_forward(u8, itemsize))
    np.testing.assert_array_equal(tcodec.byteplane_inverse(t, itemsize), u8)


@pytest.mark.parametrize("codec", ["byteplane-rle", "byteplane-rans"])
@pytest.mark.parametrize("kind", ["normal", "runs", "random"])
def test_plane_stream_encode_identical(codec, kind, rng):
    if kind == "normal":
        x = (rng.standard_normal(30_000) * 0.02).astype(np.float32)
        u8 = jcodec.byteplane_forward(jcodec.contig_u8(x), 4)
    elif kind == "runs":
        u8 = np.repeat(rng.integers(0, 4, 300, dtype=np.uint8),
                       rng.integers(1, 600, 300))
    else:
        u8 = rng.integers(0, 256, 20_000, dtype=np.uint8)
    ts, tbl = tcodec.plane_stream_encode(u8, codec)
    js, jbl = jcodec.plane_stream_encode(u8, codec)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tbl, jbl)
    np.testing.assert_array_equal(
        tcodec.plane_stream_decode(ts, u8.size, codec), u8)


@pytest.mark.parametrize("avg", [256, 4096, 65536])
def test_gear_chunker_cut_points_identical(avg, rng):
    payloads = [b"", rng.bytes(63), rng.bytes(300), rng.bytes(200_000),
                b"\x00" * 150_000, rng.bytes(1 << 20)]
    for p in payloads:
        ref = jcdc.GearChunker(avg)
        port = tcdc.GearChunker(avg, device="cpu")
        assert (port.mask_strict, port.mask_loose, port.min_size,
                port.max_size) == (ref.mask_strict, ref.mask_loose,
                                   ref.min_size, ref.max_size)
        cuts = port.cut_points(p)
        assert cuts == ref.cut_points(p)
        assert port.align_cuts(cuts, len(p), tcodec.ENTROPY_BLOCK) == \
            ref.align_cuts(cuts, len(p), jcodec.ENTROPY_BLOCK)
        dev = tcdc.GearChunker(avg, scan_backend="pallas", device="cpu")
        assert dev.cut_points(p) == cuts


def test_leaf_paths_order_matches_jax():
    tree = {"step": np.int32(0), "params": {"b": {"z": np.zeros(2),
                                                  "a": np.ones(3)},
                                            "a": np.zeros(1)},
            "opt": {"m": {"a": np.zeros(1)}, "count": np.int32(0)},
            "rng": np.zeros(2, np.uint32)}
    names = [n for n, _ in leaf_paths(tree)]
    assert names == [n for n, _ in jleaf_paths(tree)]
    assert names[0] == "opt/count" and names[-1] == "step"
    leaves = [leaf for _, leaf in leaf_paths(tree)]
    rebuilt = tree_unflatten(tree, leaves)
    assert [n for n, _ in leaf_paths(rebuilt)] == names


def test_bf16_host_carrier_replaces_ml_dtypes(rng):
    """bf16 crosses the host as uint16 bits under codec.BF16; raw and int8
    decodes agree bit for bit with the JAX codec's ml_dtypes arrays."""
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    x[:3] = [np.nan, np.inf, -0.0]
    jb = x.astype(ml_dtypes.bfloat16)
    bits = jb.view(np.uint16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    assert tcodec.dtype_name(t) == "bfloat16"
    carrier = bits.view(tcodec.BF16)
    assert tcodec.dtype_name(carrier) == "bfloat16"
    assert tcodec.dtype_name(carrier.reshape(10, 100).copy()) == "bfloat16"
    raw, meta = tcodec.encode(carrier, "raw")
    back = tcodec.decode(raw, "raw", (1000,), "bfloat16", meta)
    assert tcodec.dtype_name(back) == "bfloat16"
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    # int8: quantize bf16 as its float value, dequantize with RNE rounding
    tp, tmeta = tcodec.encode(carrier[3:], "int8")
    jp, jmeta = jcodec.encode(jb[3:], "int8")
    assert tp == jp
    tdec = tcodec.decode(tp, "int8", (997,), "bfloat16", tmeta)
    jdec = jcodec.decode(jp, "int8", (997,), "bfloat16", jmeta)
    np.testing.assert_array_equal(tdec.view(np.uint16),
                                  jdec.view(np.uint16))
    # the rounding itself, NaN included
    np.testing.assert_array_equal(tcodec._f32_to_bf16(x).view(np.uint16)[1:],
                                  bits[1:])
    assert np.isnan(tcodec._to_f32(tcodec._f32_to_bf16(x[:1])))[0]


@pytest.mark.parametrize("dt", [torch.float32, torch.int32, torch.uint32,
                                torch.bfloat16, torch.uint8])
def test_dtype_names_use_numpy_spelling(dt):
    name = tcodec.dtype_name(torch.empty(1, dtype=dt))
    assert name == str(dt).split(".")[1]
    assert tcodec._np_dtype(name).itemsize == dt.itemsize


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        tscan.GearScanner(3, 1, device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_gemma3_config_identical():
    from repro.configs import gemma3_1b as jg
    from repro_torch.configs import gemma3_1b as tg
    assert dataclasses.asdict(tg.CONFIG) == dataclasses.asdict(jg.CONFIG)


def test_lower_half_descriptor_names_torch():
    from repro_torch.configs import gemma3_1b as tg
    from repro_torch.core.split_state import lower_half_descriptor
    d = lower_half_descriptor(tg.CONFIG)
    assert d.runtime == f"torch-{torch.__version__}"
    assert d.n_devices == 1 and len(d.config_digest) == 16
