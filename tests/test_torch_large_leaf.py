"""The device encode route on a leaf past 2^31 bytes, rehearsed on the CPU
at a small size: the plane entropy glue run in block batches gives the
stream of one pass (byte for byte, against the JAX package's oracle), and
``chip_smoke.straddle_check`` — which holds the device route's cut points
and chunk digests of the 2.7 GB llama4-scout expert stack against the host
oracle in a window across byte 2^31 on the card — passes on a leaf saved
by the port's manager through the device route's plain versions, and
fails on a record whose digest or cut was changed."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro_torch.core import policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.kernels.ckpt_codec import entropy as tent

ROOT = Path(__file__).resolve().parents[1]
B = tent.B


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("codec", ["byteplane-rle", "byteplane-rans"])
def test_encode_in_block_batches_matches_one_pass(monkeypatch, codec):
    rng = np.random.default_rng(5)
    n = 10 * B + 1234
    u8 = rng.geometric(0.3, n).astype(np.uint8)
    u8[3 * B:5 * B] = 7                      # runs across batch edges
    ref_s, ref_bl = jcodec.plane_stream_encode(u8, codec)
    one_s, one_bl = tent.encode_stream(u8, codec, device="cpu")
    monkeypatch.setattr(tent, "ENCODE_BATCH", 3)
    got_s, got_bl = tent.encode_stream(u8, codec, device="cpu")
    for s, bl in ((one_s, one_bl), (got_s, got_bl)):
        np.testing.assert_array_equal(s, ref_s)
        np.testing.assert_array_equal(bl, ref_bl)


def _saved_leaf(tmp_path, n_elems, chunk):
    g = torch.Generator().manual_seed(3)
    leaf = (torch.randn(n_elems, generator=g) * 0.02).to(torch.bfloat16)
    mgr = CheckpointManager(
        TieredStore(Tier("fast", tmp_path / "s")),
        tpolicy.CheckpointPolicy(
            mode="incremental",
            chunking=tpolicy.ChunkingPolicy(scheme="cdc", chunk_size=chunk,
                                            scan_backend="pallas"),
            pipeline=tpolicy.PipelinePolicy(io_threads=4),
            durability=tpolicy.DurabilityPolicy(keepalive_s=60.0),
            codec=tpolicy.CodecPolicy(codec="raw",
                                      params_codec="byteplane-rle")),
        device="cpu")
    mgr.save({"params": {"w": leaf}}, 1)
    rec = mgr.load_manifest(1)["leaves"]["params/w"]["shards"][0]
    mgr.close()
    return leaf.view(torch.int16).numpy().view(np.uint8), rec


def test_straddle_check_holds_the_device_route_to_the_oracle(tmp_path):
    cs = _chip_smoke()
    chunk = 64 << 10
    u8, rec = _saved_leaf(tmp_path, 6 << 20, chunk)       # 12 MiB
    assert rec["codec"] == "byteplane-rle"
    at = 9 << 20                                  # inside plane 1
    out = cs.straddle_check(rec, u8, 2, at, chunk)
    assert out["window"][0] < at < out["window"][1]
    assert out["chunks"] >= 8 and out["cuts_after_at"] >= 2
    bad = dict(rec, chunks=list(rec["chunks"]))
    j = int(np.searchsorted(np.cumsum(rec["chunk_raw_lens"]), at))
    bad["chunks"][j] = "0" * 32
    with pytest.raises(SystemExit):
        cs.straddle_check(bad, u8, 2, at, chunk)
    moved = dict(rec, chunk_raw_lens=list(rec["chunk_raw_lens"]))
    moved["chunk_raw_lens"][j] -= B
    moved["chunk_raw_lens"][j + 1] += B
    with pytest.raises(SystemExit):
        cs.straddle_check(moved, u8, 2, at, chunk)
