"""The hypothesis properties of ``tests/test_properties.py`` through the
port, with the reference's own ``settings``: the int8 round trip's error
bound, the codec round trips (each payload also byte-equal to the JAX
package's encoding), reassembly from arbitrary 2-D partitions, overlap's
symmetry, ``normalize_index`` and the MoE capacity positions (equal to the
reference's ``_positions_in_expert`` on the same routing)."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import codec as jcodec  # noqa: E402
from repro_torch.core.codec import (HAVE_ZSTD, decode,  # noqa: E402
                                    dequantize_int8, encode, quantize_int8)
from repro_torch.core.elastic import (ShardRange, assemble,  # noqa: E402
                                      normalize_index, overlap)

CODECS = ["raw", "int8"] + (["zstd"] if HAVE_ZSTD else [])


@given(st.lists(st.floats(-1e6, 1e6, allow_nan=False, width=32),
                min_size=1, max_size=2048))
@settings(max_examples=60, deadline=None)
def test_int8_roundtrip_error_bound(xs):
    x = np.asarray(xs, np.float32)
    q, s = quantize_int8(x)
    jq, js = jcodec.quantize_int8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))
    y = dequantize_int8(q, s, x.size)
    scales = np.repeat(s, 256)[:x.size]
    assert np.all(np.abs(y - x) <= scales * 0.5 + 1e-6)


@given(st.sampled_from(CODECS),
       st.integers(1, 500), st.sampled_from(["float32", "int32"]))
@settings(max_examples=40, deadline=None)
def test_codec_roundtrip(codec, n, dtype):
    rng = np.random.default_rng(n)
    if dtype == "int32":
        if codec == "int8":
            return  # int leaves never use the lossy codec
        arr = rng.integers(-1000, 1000, n).astype(np.int32)
    else:
        arr = rng.standard_normal(n).astype(np.float32)
    payload, meta = encode(arr, codec)
    jpayload, jmeta = jcodec.encode(arr, codec)
    assert bytes(payload) == bytes(jpayload) and meta == jmeta
    out = decode(payload, codec, arr.shape, arr.dtype, meta)
    if codec == "int8":
        assert np.max(np.abs(out - arr)) <= np.abs(arr).max() / 127 + 1e-6
    else:
        np.testing.assert_array_equal(out, arr)


@st.composite
def _splits(draw, n):
    cuts = sorted(draw(st.sets(st.integers(1, n - 1), max_size=4))) \
        if n > 1 else []
    bounds = [0] + list(cuts) + [n]
    return list(zip(bounds[:-1], bounds[1:]))


@given(st.integers(1, 40), st.integers(1, 12), st.data())
@settings(max_examples=60, deadline=None)
def test_assemble_from_arbitrary_2d_partitions(rows, cols, data):
    arr = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    row_splits = data.draw(_splits(rows))
    col_splits = data.draw(_splits(cols))
    pieces = []
    for r0, r1 in row_splits:
        for c0, c1 in col_splits:
            pieces.append((ShardRange((r0, c0), (r1, c1)),
                           arr[r0:r1, c0:c1]))
    tr0 = data.draw(st.integers(0, rows - 1))
    tr1 = data.draw(st.integers(tr0 + 1, rows))
    tc0 = data.draw(st.integers(0, cols - 1))
    tc1 = data.draw(st.integers(tc0 + 1, cols))
    target = ShardRange((tr0, tc0), (tr1, tc1))
    out = assemble(target, pieces, np.float32)
    np.testing.assert_array_equal(out, arr[tr0:tr1, tc0:tc1])


@given(st.integers(1, 30), st.integers(1, 30), st.integers(1, 30),
       st.integers(1, 30))
@settings(max_examples=50, deadline=None)
def test_overlap_commutative_and_contained(a0, a1, b0, b1):
    ra = ShardRange((min(a0, a1) - 1,), (max(a0, a1) + 1,))
    rb = ShardRange((min(b0, b1) - 1,), (max(b0, b1) + 1,))
    ov1, ov2 = overlap(ra, rb), overlap(rb, ra)
    assert ov1 == ov2
    if ov1 is not None:
        assert ov1.start[0] >= max(ra.start[0], rb.start[0])
        assert ov1.stop[0] <= min(ra.stop[0], rb.stop[0])


def test_normalize_index_handles_nones():
    r = normalize_index((slice(None), slice(2, 5)), (10, 8))
    assert r == ShardRange((0, 2), (10, 5))


@given(st.integers(2, 16), st.integers(1, 4), st.integers(16, 128))
@settings(max_examples=20, deadline=None)
def test_moe_positions_capacity_property(n_experts, k, tokens):
    import jax
    import torch

    from repro.models.moe import _positions_in_expert as jpositions
    from repro_torch.models.moe import _positions_in_expert
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(tokens),
                                        (tokens * k,), 0, n_experts))
    pos, counts = _positions_in_expert(torch.from_numpy(idx), n_experts,
                                       block=32)
    pos, counts = pos.numpy(), counts.numpy()
    assert counts.sum() == tokens * k
    for e in range(n_experts):
        mine = np.sort(pos[idx == e])
        np.testing.assert_array_equal(mine, np.arange(len(mine)))
    jpos, jcounts = jpositions(idx, n_experts, block=32)
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
