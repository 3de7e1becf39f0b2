"""Manifest history in the port, held against ``tests/test_manifest_v5.py``
and ``tests/test_manifest_v6.py``: v3/v4/v5 history (a v7 manifest
rewritten as its older writer's, by that module's own ``_downgrade``)
restores under the port's reader, whichever package wrote it; GC over a
mixed v3–v6 history leaks nothing; a restart adopts the writer's policy
and keeps deduplicating; a future format is rejected. Plus the v5 length
lists, the direct placement they enable, and the v6 policy block."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_manifest_v5 as ref5
from conftest import make_ckpt_policy
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro_torch.convert import from_jax_state
from repro_torch.core import cas
from repro_torch.core.cas import ChunkStore
from repro_torch.core.checkpoint import FORMAT_VERSION, CheckpointManager
from repro_torch.core.errors import CkptError
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.storage import Tier, TieredStore


def _np_state(seed=0, n=40_000):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((n,), dtype=np.float32)}}


def _state(seed=0):
    return from_jax_state(_np_state(seed), device="cpu")


def _abstract(state):
    if isinstance(state, dict):
        return {k: _abstract(v) for k, v in state.items()}
    return torch.empty_like(state, device="meta")


def _store(tmp_path):
    return TieredStore(Tier("fast", tmp_path / "fast"))


def _flat(**kw):
    kw.setdefault("codec", "raw")
    kw.setdefault("n_writers", 2)
    kw.setdefault("mode", "incremental")
    kw.setdefault("chunking", "cdc")
    kw.setdefault("chunk_size", 512)
    kw.setdefault("io_threads", 4)
    kw.setdefault("keepalive_s", 60.0)
    return kw


def _mgr(tmp_path, **kw):
    return CheckpointManager(_store(tmp_path),
                             CheckpointPolicy().with_overrides(**_flat(**kw)),
                             device="cpu")


def _jmgr(tmp_path, **kw):
    return JManager(JStore(JTier("fast", tmp_path / "fast")),
                    policy=make_ckpt_policy(**_flat(**kw)))


def _write(writer, tmp_path, seed, step, **kw):
    """Save `_np_state(seed)` at `step` with `writer`'s package."""
    if writer == "port":
        mgr = _mgr(tmp_path, **kw)
        mgr.save(_state(seed), step)
    else:
        mgr = _jmgr(tmp_path, **kw)
        mgr.save(jax.tree.map(jnp.asarray, _np_state(seed)), step)
    mgr.close()


def _assert_restores(mgr, step, seed):
    want = _state(seed)
    got, _ = mgr.restore(_abstract(want), step=step)
    assert torch.equal(got["params"]["w"].view(torch.int32),
                       want["params"]["w"].view(torch.int32))


def _manifest(root, step):
    return json.loads(ref5._manifest_path(root, step).read_text())


# ---------------------------------------------------------------------------
# v5 writer output and direct placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("io_threads", [1, 4])
def test_writer_emits_chunk_len_lists(tmp_path, io_threads):
    mgr = _mgr(tmp_path, io_threads=io_threads)
    mgr.save(_state(), 1)
    m = _manifest(mgr.store.root, 1)
    assert m["format"] == FORMAT_VERSION
    assert m["chunk_bounds"] == [mgr._chunker.min_size,
                                 mgr._chunker.avg_size,
                                 mgr._chunker.max_size]
    recs = ref5._cdc_records(m)
    assert recs
    for s in recs:
        assert len(s["chunk_lens"]) == len(s["chunks"])
        assert sum(s["chunk_lens"]) == s["payload_bytes"]
        assert all(n > 0 for n in s["chunk_lens"])
    mgr.close()


def test_cdc_restore_uses_direct_placement(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path)
    mgr.save(_state(), 1)
    calls = {"direct": 0}
    real_direct = ChunkStore.read_payload_direct

    def counting_direct(self, *a, **kw):
        calls["direct"] += 1
        return real_direct(self, *a, **kw)

    def forbidden_join(self, *a, **kw):
        raise AssertionError("join-path read_payload used for a v5 CDC "
                             "record on the pipelined engine")

    monkeypatch.setattr(ChunkStore, "read_payload_direct", counting_direct)
    monkeypatch.setattr(ChunkStore, "read_payload", forbidden_join)
    _assert_restores(mgr, 1, 0)
    assert calls["direct"] > 0
    mgr.close()


def test_direct_placement_damage_falls_back_and_heals(tmp_path):
    mgr = _mgr(tmp_path, replicas=2)
    mgr.save(_state(), 1)
    digest = ref5._cdc_records(_manifest(mgr.store.root, 1))[0]["chunks"][0]
    obj = mgr.store.fast.root / cas.object_rel(digest)
    obj.write_bytes(b"\x00" * obj.stat().st_size)
    _assert_restores(mgr, 1, 0)
    mgr.close()


# ---------------------------------------------------------------------------
# cross-version history, written by either package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [4, 5])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reader_restores_older_history(tmp_path, writer, fmt):
    """A v4 (no length lists) or v5 (no policy block) step restores
    bit-exact under the port's reader, and a current step written on top
    restores too."""
    _write(writer, tmp_path, 1, 1, retain=4)
    ref5._downgrade(tmp_path / "fast", 1, fmt)
    mgr = _mgr(tmp_path, retain=4)
    assert mgr.load_manifest(1)["format"] == fmt
    _assert_restores(mgr, 1, 1)
    mgr.save(_state(2), 2)
    assert mgr.load_manifest(2)["format"] == FORMAT_VERSION
    _assert_restores(mgr, 1, 1)
    _assert_restores(mgr, 2, 2)
    mgr.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gc_over_mixed_v3_to_v6_history_leaks_nothing(tmp_path, writer):
    """Mark-and-sweep over v3 + v4 + v5 + v6 steps (and the current
    writer's): every version's chunks stay live, an orphan is reclaimed,
    and every step still restores."""
    for step in (1, 2, 3, 4):
        _write(writer, tmp_path, step, step, retain=8)
    for step, fmt in ((1, 3), (2, 4), (3, 5)):
        ref5._downgrade(tmp_path / "fast", step, fmt)
    m4 = _manifest(tmp_path / "fast", 4)
    m4["format"] = 6
    ref5._manifest_path(tmp_path / "fast", 4).write_text(json.dumps(m4))
    mgr = _mgr(tmp_path, retain=8)
    mgr.save(_state(5), 5)
    orphan = mgr.store.fast.root / cas.object_rel("ff" * 16)
    orphan.parent.mkdir(parents=True, exist_ok=True)
    orphan.write_bytes(b"junk")
    mgr.gc()
    assert not orphan.exists()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    want = {1: 3, 2: 4, 3: 5, 4: 6, 5: FORMAT_VERSION}
    for step, fmt in want.items():
        m = mgr.load_manifest(step)
        assert m["format"] == fmt
        assert ("policy" in m) == (fmt >= 6)
        _assert_restores(mgr, step, step)
    mgr.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_future_manifest_format_rejected(tmp_path, writer):
    _write(writer, tmp_path, 0, 1)
    mpath = ref5._manifest_path(tmp_path / "fast", 1)
    m = json.loads(mpath.read_text())
    m["format"] = FORMAT_VERSION + 1
    mpath.write_text(json.dumps(m))
    with pytest.raises(CkptError):
        _mgr(tmp_path).load_manifest(1)


# ---------------------------------------------------------------------------
# v6: the writer's policy rides the manifest
# ---------------------------------------------------------------------------

def test_v6_manifest_round_trips_the_writing_policy(tmp_path):
    mgr = _mgr(tmp_path, chunk_size=1024)
    mgr.save(_state(), 1)
    m = _manifest(mgr.store.root, 1)
    embedded = CheckpointPolicy.from_dict(m["policy"])
    assert embedded.chunking == mgr.policy.chunking
    assert embedded.codec.codec == mgr.codec == "raw"
    assert m["policy"] == mgr._effective_policy_dict()
    mgr.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mismatched_caller_adopts_writer_policy_and_keeps_dedup(
        tmp_path, writer):
    """History written cdc@1K; a restart configured fixed@4K restores
    byte-identically, adopts the writer's chunking, and its next save of
    the unchanged state writes no new object bytes."""
    _write(writer, tmp_path, 7, 1, chunk_size=1024)
    caller = _mgr(tmp_path, chunking="fixed", chunk_size=4096)
    _assert_restores(caller, 1, 7)
    assert caller.policy.chunking.scheme == "cdc"
    assert caller.policy.chunking.chunk_size == 1024
    assert caller.chunks.chunk_size == 1024
    assert caller._chunker is not None and caller._chunker.avg_size == 1024
    rep = caller.save(_state(7), 2)
    assert rep["new_object_bytes"] == 0
    m2 = CheckpointPolicy.from_dict(caller.load_manifest(2)["policy"])
    assert m2.chunking == caller.policy.chunking
    caller.close()


def test_matched_caller_adopts_nothing(tmp_path):
    mgr = _mgr(tmp_path, chunk_size=1024)
    mgr.save(_state(), 1)
    before = mgr.policy
    mgr.restore(_abstract(_state()))
    assert mgr.policy is before
    mgr.close()


def test_corrupted_policy_block_degrades_to_warning(tmp_path):
    _mgr(tmp_path, chunk_size=1024).save(_state(3), 1)
    mpath = ref5._manifest_path(tmp_path / "fast", 1)
    for garbage in ({"mode": "bogus"}, "not-a-mapping",
                    {"chunking": {"scheme": 999}},
                    {"mode": "incremental",
                     "chunking": {"scheme": "cdc", "chunk_size": 100}}):
        m = json.loads(mpath.read_text())
        m["policy"] = garbage
        mpath.write_text(json.dumps(m))
        caller = _mgr(tmp_path, chunking="fixed", chunk_size=4096)
        _assert_restores(caller, 1, 3)
        assert caller.policy.chunking.scheme == "fixed"
        caller.close()
