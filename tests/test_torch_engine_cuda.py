"""The checkpoint engine's device routes on the card, where they differ
from the CPU: the fused K2+K1+K3 dispatch and the segmented K1 scan on
save, K4/K6 on restore, the streaming restore, the crash between the fused
dispatch and chunk submission, and the damaged-chunk and replica reads.
Each case saves the same seeded state through a CUDA manager and a CPU
manager under one policy and holds the two stores equal file for file
(the CPU route is held to the JAX package byte for byte by the other
engine parity files), and every restore onto the card bit for bit.

Every test is marked ``cuda`` and skips without a card. The file imports
no JAX, so it runs on a machine that has none:

    python -m pytest -q tests/test_torch_engine_cuda.py
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import atomic, cas
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.errors import AbortedError
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.split_state import leaf_paths, map_leaves
from repro_torch.core.storage import Tier, TieredStore

pytestmark = pytest.mark.cuda

# f32 leaves past MIN_ACCEL_BYTES take the device routes
N = 900_000

POLICIES = {
    "raw": dict(codec="raw"),
    "byteplane-rle": dict(codec="raw", params_codec="byteplane-rle"),
    "byteplane-rans": dict(codec="byteplane-rans"),
    "byteplane": dict(codec="byteplane"),
    "int8": dict(codec="raw", params_codec="int8"),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _np_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": (rng.standard_normal(N) * 0.02)
                       .astype(np.float32),
                       "e": (rng.standard_normal((512, 1024)) * 0.02)
                       .astype(np.float32)},
            "opt": {"m": (rng.standard_normal(N) * 1e-3)
                    .astype(np.float32),
                    "count": np.asarray(3, np.int32)},
            "step": np.asarray(3, np.int32)}


def _state(np_tree, device):
    return map_leaves(lambda a: torch.from_numpy(np.array(a)).to(device),
                      np_tree)


def _policy(**flat):
    flat.setdefault("mode", "incremental")
    flat.setdefault("chunking", "cdc")
    flat.setdefault("chunk_size", 65536)
    flat.setdefault("io_threads", 4)
    flat.setdefault("n_writers", 2)
    flat.setdefault("keepalive_s", 60.0)
    return CheckpointPolicy().with_overrides(**flat)


def _mgr(root, device, **flat):
    return CheckpointManager(TieredStore(Tier("fast", Path(root))),
                             _policy(**flat), device=device)


def _store_files(root: Path) -> dict:
    out = {}
    for s in atomic.list_committed_steps(root):
        for p in sorted(atomic.committed_dir(root, s).rglob("*")):
            if p.is_file():
                rel = str(p.relative_to(root))
                out[rel] = p.read_bytes()
                if rel.endswith(atomic.MANIFEST):
                    m = json.loads(out[rel])
                    m.pop("created")
                    out[rel] = m
    for p in sorted((root / "_CAS" / "objects").rglob("*")):
        if p.is_file():
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def _assert_on_card(got, want):
    for (name, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
        assert a.device.type == "cuda", name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a).cpu(), _bits(b).cpu()), name


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_card_route_writes_the_cpu_routes_bytes(tmp_path, card, name):
    st = _np_state()
    flat = POLICIES[name]
    gpu = _mgr(tmp_path / "gpu", card, **flat)
    cpu = _mgr(tmp_path / "cpu", "cpu", **flat)
    gpu.save(_state(st, card), 1)
    cpu.save(_state(st, "cpu"), 1)
    assert _store_files(tmp_path / "gpu") == _store_files(tmp_path / "cpu")
    got, _ = gpu.restore(_state(st, card))
    if name == "int8":
        want, _ = cpu.restore(_state(st, "cpu"))
    else:
        want = _state(st, "cpu")
    _assert_on_card(got, want)


@pytest.mark.parametrize("io_threads", [1, 4])
def test_streaming_restore_on_the_card(tmp_path, card, io_threads):
    st = _np_state()
    mgr = _mgr(tmp_path, card, io_threads=io_threads, streaming_restore=True,
               **POLICIES["byteplane-rle"])
    mgr.save(_state(st, card), 1)
    blocking, _ = mgr.restore(_state(st, card))
    stream, _ = mgr.restore_streaming(_state(st, card))
    stream.wait_frontier()
    for name in stream.frontier_names:
        assert stream.landed(name)
    got = stream.state()
    _assert_on_card(got, _state(st, "cpu"))
    _assert_on_card(got, blocking)


def test_crash_after_fused_dispatch_on_the_card(tmp_path, card):
    states = {s: _np_state(s) for s in (1, 2, 3)}
    flat = dict(codec="byteplane-rans", retain=4, max_retries=0)
    for where, device in (("card", card), ("host", "cpu")):
        root = tmp_path / where
        _mgr(root, device, **flat).save(_state(states[1], device), 1)
        with pytest.raises((CrashPoint, AbortedError)):
            _mgr(root, device, **flat).save(
                _state(states[2], device), 2,
                crash=CrashInjector("rank0_after_fused_dispatch"))
        mgr = _mgr(root, device, **flat)
        mgr.gc()
        assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
        assert mgr.latest_step() == 1
        mgr.save(_state(states[3], device), 3)
        got, _ = mgr.restore(_state(states[3], device), step=3)
        if where == "card":
            _assert_on_card(got, _state(states[3], "cpu"))
    assert _store_files(tmp_path / "card") == _store_files(tmp_path / "host")


def test_damaged_chunk_and_replica_on_the_card(tmp_path, card):
    st = _np_state()
    mgr = _mgr(tmp_path, card, replicas=2, **POLICIES["byteplane-rle"])
    mgr.save(_state(st, card), 1)
    rec = mgr.load_manifest(1)["leaves"]["params/w"]["shards"][0]
    obj = tmp_path / cas.object_rel(rec["chunks"][0])
    obj.write_bytes(b"\x00" * obj.stat().st_size)
    got, _ = mgr.restore(_state(st, card))
    _assert_on_card(got, _state(st, "cpu"))
    obj.unlink()
    got, _ = mgr.restore(_state(st, card))
    _assert_on_card(got, _state(st, "cpu"))
