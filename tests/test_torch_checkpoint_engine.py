"""The port's checkpoint engine held to ``tests/test_checkpoint.py``: every
scenario of that suite (codec round trips and the int8 bound, ``latest``
and retention, the extra payload, rank-failure abort/retry/all dead, the
crash-consistency points, the blocking-save failure's counters, the buddy
replica, the corrupt primary, the missing shard, the coded errors, v2/v3
manifests, mixed chunking history with GC, the parallel restore, the read
cache's LRU accounting, the unsupported format, the topology change and
the single manifest handle) runs through ``repro_torch`` on the CPU with
that test's own assertions.

Where the reference defines bytes, the same seeded numpy state is also
saved by the JAX package under the same policy, and the two stores are
compared file for file (manifests without their ``created`` time, shard
files, CAS object names and contents). Restored leaves are compared bit
for bit. The helpers here are shared by the other engine parity files."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_checkpoint as ref
from conftest import make_ckpt_policy
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro_torch.convert import from_jax_state
from repro_torch.core import atomic
from repro_torch.core import codec as codec_mod
from repro_torch.core.atomic import CrashInjector, CrashPoint
from repro_torch.core.checkpoint import FORMAT_VERSION, CheckpointManager
from repro_torch.core.elastic import ShardRange, assemble, plan_reads
from repro_torch.core.errors import (AbortedError, CkptError,
                                     CodecUnavailableError,
                                     CorruptShardError, MissingShardError,
                                     NamespaceError, NoCheckpointError,
                                     RegistryMismatchError, SpaceError)
from repro_torch.core.namespace import check_leaf_name
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.registry import validate_against
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore

requires_zstd = pytest.mark.skipif(not codec_mod.HAVE_ZSTD,
                                   reason="zstandard not installed "
                                          "(compress extra)")

# ---------------------------------------------------------------------------
# shared helpers: one seeded numpy state, saved by both packages
# ---------------------------------------------------------------------------


def np_state(seed=0):
    """The reference suite's ``_state()`` shapes and dtypes, from a seed:
    an f32 matrix, a stacked block leaf, an int32 count and step, and the
    uint32 rng key data."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((16, 8), dtype=np.float32),
            "stage_0": {"b0": {"wg": rng.standard_normal(
                (2, 8, 4), dtype=np.float32)}},
        },
        "opt": {"count": np.zeros((), np.int32)},
        "step": np.asarray(5, np.int32),
        "rng": rng.integers(0, 2 ** 32, 2, dtype=np.uint32),
    }


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def torch_state(np_tree):
    return from_jax_state(np_tree, device="cpu")


def jax_state(np_tree):
    return tree_map(jnp.asarray, np_tree)


def abstract(state):
    """Shapes and dtypes only: meta tensors."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), state)


def jabstract(np_tree):
    return tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                    np_tree)


def tpolicy(**flat):
    """The port's policy from the reference suite's flat overrides, with
    the shared ``keepalive_s=60`` of ``conftest.make_ckpt_policy``."""
    flat.setdefault("keepalive_s", 60.0)
    return CheckpointPolicy().with_overrides(**flat)


def mgr_at(root, **flat):
    """The port's manager over a one-tier store at `root`."""
    return CheckpointManager(TieredStore(Tier("fast", Path(root))),
                             tpolicy(**flat), device="cpu")


def jmgr_at(root, **flat):
    return JManager(JStore(JTier("fast", Path(root))),
                    policy=make_ckpt_policy(**flat))


def bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def np_bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind in "fV" or \
        str(a.dtype) == "bfloat16" else a


def assert_bits(restored, np_tree):
    """Every restored leaf equals the numpy tree's bit for bit, with its
    name, shape and dtype."""
    got, want = leaf_paths(restored), leaf_paths(np_tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, name
        host = bits(t).numpy()
        np.testing.assert_array_equal(host.view(np_bits(a).dtype)
                                      if host.dtype.itemsize ==
                                      a.dtype.itemsize else host,
                                      np_bits(a), name)


def assert_same_tensors(a, b):
    pa, pb = leaf_paths(a), leaf_paths(b)
    assert [n for n, _ in pa] == [n for n, _ in pb]
    for (name, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(bits(x), bits(y)), name


def manifest_bytes(m: dict) -> dict:
    """A manifest without its wall-clock ``created`` field."""
    return {k: v for k, v in m.items() if k != "created"}


def store_files(root: Path) -> dict:
    """What a store defines as bytes: LATEST, every committed step's files
    (the manifest as JSON without its time) and every CAS object."""
    root = Path(root)
    out = {}
    latest = root / atomic.LATEST
    if latest.exists():
        out[atomic.LATEST] = latest.read_bytes()
    for s in atomic.list_committed_steps(root):
        d = atomic.committed_dir(root, s)
        for p in sorted(d.rglob("*")):
            if not p.is_file():
                continue
            rel = str(p.relative_to(root))
            if rel.endswith(atomic.MANIFEST):
                out[rel] = manifest_bytes(json.loads(p.read_text()))
            else:
                out[rel] = p.read_bytes()
    objs = root / "_CAS" / "objects"
    if objs.is_dir():
        for p in sorted(objs.rglob("*")):
            if p.is_file():
                out[str(p.relative_to(root))] = p.read_bytes()
    return out


def assert_same_store(port_root, ref_root):
    """Both packages wrote the same bytes: same file set, same contents."""
    got, want = store_files(port_root), store_files(ref_root)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


def save_both(tmp_path, np_tree, step, *, port=None, jax_mgr=None, **flat):
    """Save `np_tree` at `step` through the port and through the JAX
    package under the same flat policy; returns (port, reference)
    managers, by default over stores at `tmp_path`/port/fast and
    `tmp_path`/ref/fast."""
    port = port or mgr_at(tmp_path / "port" / "fast", **flat)
    jax_mgr = jax_mgr or jmgr_at(tmp_path / "ref" / "fast", **flat)
    port.save(torch_state(np_tree), step)
    jax_mgr.save(jax_state(np_tree), step)
    return port, jax_mgr


# ---------------------------------------------------------------------------
# test_checkpoint.py, scenario by scenario
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [
    "raw", pytest.param("zstd", marks=requires_zstd)])
def test_roundtrip_exact(tmp_path, codec):
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 5, codec=codec, n_writers=3)
    assert_same_store(mgr.store.root, jm.store.root)
    restored, extra = mgr.restore(abstract(torch_state(st)))
    assert_bits(restored, st)
    assert extra == {}


def test_int8_params_codec_bounded_error(tmp_path):
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 1, codec=None, params_codec="int8")
    assert_same_store(mgr.store.root, jm.store.root)
    restored, _ = mgr.restore(abstract(torch_state(st)))
    w0 = st["params"]["w"]
    w1 = restored["params"]["w"].numpy()
    assert np.max(np.abs(w0 - w1)) <= np.abs(w0).max() / 127 + 1e-6
    # the dequantized values are the reference's, bit for bit
    jr, _ = jm.restore(jabstract(st))
    np.testing.assert_array_equal(np_bits(w1),
                                  np_bits(np.asarray(jr["params"]["w"])))
    np.testing.assert_array_equal(bits(restored["rng"]).numpy()
                                  .view(np.uint32), st["rng"])


def test_latest_and_retention(tmp_path):
    st = np_state()
    mgr = mgr_at(tmp_path / "port", retain=2)
    jm = jmgr_at(tmp_path / "ref", retain=2)
    for s in (1, 2, 3, 4):
        save_both(tmp_path, st, s, port=mgr, jax_mgr=jm)
    assert mgr.latest_step() == 4
    assert atomic.list_committed_steps(mgr.store.root) == [3, 4]
    assert_same_store(mgr.store.root, jm.store.root)


def test_extra_payload_roundtrip(tmp_path):
    extra = {"data_state": {"seed": 3, "step": 9, "source_counts": [1, 2]}}
    st = np_state()
    mgr = mgr_at(tmp_path / "port")
    jm = jmgr_at(tmp_path / "ref")
    mgr.save(torch_state(st), 9, extra=extra)
    jm.save(jax_state(st), 9, extra=extra)
    assert_same_store(mgr.store.root, jm.store.root)
    _, got = mgr.restore(abstract(torch_state(st)))
    assert got["data_state"]["step"] == 9
    assert got == extra


def test_abort_on_injected_rank_failure_preserves_previous(tmp_path):
    st = np_state()
    mgr = mgr_at(tmp_path, n_writers=3, max_retries=0)
    mgr.save(torch_state(st), 1)
    mgr.coordinator.inject_failure(1)
    with pytest.raises(AbortedError):
        mgr.save(torch_state(st), 2)
    assert mgr.latest_step() == 1
    assert atomic.list_committed_steps(mgr.store.root) == [1]
    assert not list(mgr.store.root.glob("*.tmp-*"))
    restored, _ = mgr.restore(abstract(torch_state(st)))
    assert_bits(restored, st)


def test_rank_failure_retry_redistributes_and_commits(tmp_path):
    st = np_state()
    mgr = mgr_at(tmp_path / "port", n_writers=4, max_retries=1)
    jm = jmgr_at(tmp_path / "ref", n_writers=4, max_retries=1)
    mgr.coordinator.inject_failure(2)
    jm.coordinator.inject_failure(2)
    rep = mgr.save(torch_state(st), 7)
    jm.save(jax_state(st), 7)
    assert rep["step"] == 7
    assert mgr.coordinator.metrics["aborts"] == 1
    assert mgr.coordinator.metrics["commits"] == 1
    assert mgr.coordinator.metrics == jm.coordinator.metrics
    # the survivors write the dead rank's shards: the same files
    assert_same_store(mgr.store.root, jm.store.root)
    restored, _ = mgr.restore(abstract(torch_state(st)))
    assert_bits(restored, st)


def test_all_ranks_dead_still_aborts(tmp_path):
    mgr = mgr_at(tmp_path, n_writers=2, max_retries=3)
    for r in range(2):
        mgr.coordinator.inject_failure(r)
    with pytest.raises(AbortedError):
        mgr.save(torch_state(np_state()), 1)
    assert mgr.latest_step() is None


@pytest.mark.parametrize("point", ["rank0_before_write", "before_manifest",
                                   "before_commit_rename",
                                   "after_commit_rename", "after_tmp_write"])
def test_crash_consistency(tmp_path, point):
    """A crash at any protocol step leaves a valid latest checkpoint, the
    same one the reference is left with, over the same committed bytes."""
    st = np_state()
    st2 = np_state(1)
    mgr = mgr_at(tmp_path / "port", n_writers=2)
    jm = jmgr_at(tmp_path / "ref", n_writers=2)
    save_both(tmp_path, st, 1, port=mgr, jax_mgr=jm)
    try:
        mgr.save(torch_state(st2), 2, crash=CrashInjector(point))
    except (CrashPoint, AbortedError):
        pass
    try:
        jm.save(jax_state(st2), 2, crash=ref.CrashInjector(point))
    except (ref.CrashPoint, ref.AbortedError):
        pass
    atomic.gc_staging(mgr.store.root)
    ref.atomic.gc_staging(jm.store.root)
    mgr2 = mgr_at(tmp_path / "port", n_writers=2)
    latest = mgr2.latest_step()
    assert latest in (1, 2)
    assert latest == jmgr_at(tmp_path / "ref", n_writers=2).latest_step()
    restored, _ = mgr2.restore(abstract(torch_state(st)), step=latest)
    assert_bits(restored, st if latest == 1 else st2)
    assert_same_store(mgr.store.root, jm.store.root)


def test_blocking_save_failure_still_drains_counters(tmp_path):
    st = np_state()
    mgr = mgr_at(tmp_path, codec="raw", n_writers=2, save_timeout_s=5.0)
    with pytest.raises(CrashPoint):
        mgr.save(torch_state(st), 1,
                 crash=CrashInjector("before_latest_write"))
    assert mgr.counters.drained()
    atomic.gc_staging(mgr.store.root)
    rep = mgr.save(torch_state(st), 2)
    assert rep["step"] == 2


def _primary_shard(root):
    return next(p for p in sorted(Path(root).rglob("shard-*.bin"))
                if not p.name.endswith(".r1"))


@pytest.mark.parametrize("damage", ["deleted", "flipped"])
def test_buddy_replica_restores_after_primary_loss(tmp_path, damage):
    """The reference's primary-loss and corrupt-primary cases: a deleted
    primary shard file, or one whose last payload byte is flipped (crc
    mismatch), restores from its ``.r1`` buddy bit-exact."""
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 3, replicas=2, n_writers=2)
    assert_same_store(mgr.store.root, jm.store.root)
    prim = _primary_shard(mgr.store.root)
    if damage == "deleted":
        prim.unlink()
    else:
        data = bytearray(prim.read_bytes())
        data[-1] ^= 0xFF
        prim.write_bytes(bytes(data))
    restored, _ = mgr.restore(abstract(torch_state(st)))
    assert_bits(restored, st)


def test_missing_shard_without_replica_raises(tmp_path):
    st = np_state()
    mgr = mgr_at(tmp_path, replicas=1, n_writers=2)
    mgr.save(torch_state(st), 3)
    next(iter(mgr.store.root.rglob("shard-00000.bin"))).unlink()
    with pytest.raises((MissingShardError, CorruptShardError)):
        mgr.restore(abstract(torch_state(st)))


def test_no_checkpoint_error(tmp_path):
    with pytest.raises(NoCheckpointError):
        mgr_at(tmp_path).restore(abstract(torch_state(np_state())))


def test_registry_validation_catches_shape_drift(tmp_path):
    st = torch_state(np_state())
    mgr = mgr_at(tmp_path)
    mgr.save(st, 1)
    bad = dict(mgr.load_manifest(1)["leaves"])
    validate_against(st, bad)
    bad["params/w"] = dict(bad["params/w"], shape=[4, 4])
    with pytest.raises(RegistryMismatchError):
        validate_against(st, bad)


@pytest.mark.parametrize("name,ok", [("_META/evil", False),
                                     ("LATEST", False),
                                     ("params/stage_0/b0/wg", True)])
def test_namespace_collision_rejected(name, ok):
    if ok:
        assert check_leaf_name(name)
    else:
        with pytest.raises(NamespaceError):
            check_leaf_name(name)


def test_space_preflight(tmp_path):
    tier = Tier("tiny", tmp_path / "t", capacity_bytes=100)
    with pytest.raises(SpaceError):
        tier.preflight(1000)


def test_zstd_codec_unavailable_raises(monkeypatch):
    """Without the optional `zstandard` package, asking for zstd is a
    coded error. Where the package is installed, its absence is what the
    codec module records at import (``HAVE_ZSTD``, ``zstandard``)."""
    if codec_mod.HAVE_ZSTD:
        monkeypatch.setattr(codec_mod, "HAVE_ZSTD", False)
        monkeypatch.setattr(codec_mod, "zstandard", None)
    with pytest.raises(CodecUnavailableError):
        codec_mod.encode(np.zeros(4, np.float32), "zstd")
    assert codec_mod.default_codec() == "raw"
    assert not codec_mod.available("zstd")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v2_manifest_restores_under_v4_reader(tmp_path, writer):
    """A v2 (full-mode) checkpoint, written by either package and rewritten
    by the reference suite's own ``_rewrite_manifest_as_v2``, restores under
    the port's reader."""
    st = np_state()
    flat = dict(codec="raw", n_writers=3)
    if writer == "port":
        mgr_at(tmp_path, **flat).save(torch_state(st), 4)
    else:
        jmgr_at(tmp_path, **flat).save(jax_state(st), 4)
    ref._rewrite_manifest_as_v2(tmp_path, 4)
    mgr2 = mgr_at(tmp_path)
    assert mgr2.load_manifest(4)["format"] == 2
    restored, _ = mgr2.restore(abstract(torch_state(st)))
    assert_bits(restored, st)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v3_chunked_manifest_restores_and_gcs_under_v4_reader(tmp_path,
                                                              writer):
    st = np_state()
    flat = dict(codec="raw", n_writers=2, mode="incremental",
                chunk_size=512)
    if writer == "port":
        mgr_at(tmp_path, **flat).save(torch_state(st), 1)
    else:
        jmgr_at(tmp_path, **flat).save(jax_state(st), 1)
    ref._rewrite_manifest_as_v3(tmp_path, 1)
    mgr2 = mgr_at(tmp_path, **flat)
    assert mgr2.load_manifest(1)["format"] == 3
    restored, _ = mgr2.restore(abstract(torch_state(st)))
    assert_bits(restored, st)
    st2 = np_state()
    st2["params"]["w"] = st2["params"]["w"] + np.float32(2.0)
    mgr2.save(torch_state(st2), 2)
    mgr2.gc()
    assert mgr2.chunks.fsck(mgr2._live_chunk_refs())["ok"]
    restored, _ = mgr2.restore(abstract(torch_state(st)), step=1)
    assert_bits(restored, st)


def test_mixed_chunking_history_restores_and_gcs(tmp_path):
    def flat(chunking):
        return dict(codec="raw", n_writers=2, mode="incremental",
                    chunk_size=512, chunking=chunking, retain=4)

    s1, s2, s3 = np_state(), np_state(), np_state(2)
    s2["params"]["w"] = s2["params"]["w"] + np.float32(1.0)
    save_both(tmp_path, s1, 1, **flat("fixed"))
    save_both(tmp_path, s2, 2, **flat("cdc"))
    mgr = mgr_at(tmp_path / "port" / "fast", **flat("fixed"))
    jm = jmgr_at(tmp_path / "ref" / "fast", **flat("fixed"))
    for step, expect in ((1, s1), (2, s2)):
        restored, _ = mgr.restore(abstract(torch_state(expect)), step=step)
        assert_bits(restored, expect)
        # the reference reads the same steps, so both adopt the same policy
        jm.restore(jabstract(expect), step=step)
    assert dataclasses.asdict(mgr.policy) == dataclasses.asdict(jm.policy)
    mgr.gc()
    jm.gc()
    assert mgr.chunks.fsck(mgr._live_chunk_refs())["ok"]
    m1, m2 = mgr.load_manifest(1), mgr.load_manifest(2)
    assert m1["chunking"] == "fixed" and m2["chunking"] == "cdc"
    save_both(tmp_path, s3, 3, port=mgr, jax_mgr=jm)
    restored, _ = mgr.restore(abstract(torch_state(s3)), step=3)
    assert_bits(restored, s3)
    assert_same_store(mgr.store.root, jm.store.root)


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_parallel_restore_matches_serial(tmp_path, mode):
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 1, codec="raw", n_writers=3,
                        mode=mode, chunk_size=512)
    assert_same_store(mgr.store.root, jm.store.root)
    serial, _ = mgr_at(mgr.store.root, io_threads=1).restore(
        abstract(torch_state(st)))
    parallel, _ = mgr_at(mgr.store.root, io_threads=8).restore(
        abstract(torch_state(st)))
    assert_same_tensors(serial, parallel)
    assert_bits(parallel, st)


def test_read_cache_accounting_and_lru(tmp_path):
    mgr = mgr_at(tmp_path, codec="raw")
    a = np.zeros(100, np.uint8)
    mgr.read_cache_limit = 350
    mgr._cache_put("a", a)
    mgr._cache_put("a", a)
    assert mgr._read_cache_bytes == 100
    mgr._cache_put("b", np.zeros(100, np.uint8))
    mgr._cache_put("c", np.zeros(100, np.uint8))
    assert mgr._cache_get("a") is not None
    mgr._cache_put("d", np.zeros(100, np.uint8))
    assert "b" not in mgr._read_cache
    assert "a" in mgr._read_cache
    assert mgr._read_cache_bytes == 300
    for i in range(20):
        mgr._cache_put(f"k{i}", np.zeros(100, np.uint8))
    assert len(mgr._read_cache) == 3
    assert mgr._read_cache_bytes == 300


@pytest.mark.parametrize("fmt", [99, FORMAT_VERSION + 1, 1])
def test_unsupported_manifest_format_rejected(tmp_path, fmt):
    mgr = mgr_at(tmp_path, codec="raw")
    mgr.save(torch_state(np_state()), 1)
    mpath = mgr.store.root / "step_00000001" / atomic.MANIFEST
    m = json.loads(mpath.read_text())
    m["format"] = fmt
    mpath.write_text(json.dumps(m))
    with pytest.raises(CkptError):
        mgr_at(tmp_path).load_manifest(1)


def test_incremental_restore_across_topology_change(tmp_path):
    """Saved as 8 row shards a large leaf (the reference suite's own
    ``_split_rows`` over the port's snapshot), restored on one device and
    assembled on a 4-way split through ``plan_reads``."""
    st = np_state()
    flat = dict(codec="raw", n_writers=4, mode="incremental", chunk_size=256)
    mgr = ref._split_rows(mgr_at(tmp_path / "port", **flat), parts=8)
    jm = ref._split_rows(jmgr_at(tmp_path / "ref", **flat), parts=8)
    save_both(tmp_path, st, 1, port=mgr, jax_mgr=jm)
    assert_same_store(mgr.store.root, jm.store.root)
    w_rec = mgr.load_manifest(1)["leaves"]["params/w"]
    assert len(w_rec["shards"]) == 8
    assert all("chunks" in s for s in w_rec["shards"])
    mgr1 = mgr_at(tmp_path / "port")
    restored, _ = mgr1.restore(abstract(torch_state(st)))
    assert_bits(restored, st)
    w = st["params"]["w"]
    available = [(ShardRange(tuple(s["start"]), tuple(s["stop"])), s)
                 for s in w_rec["shards"]]
    cuts = np.linspace(0, w.shape[0], 5, dtype=int)
    for a, b in zip(cuts[:-1], cuts[1:]):
        target = ShardRange((int(a), 0), (int(b), w.shape[1]))
        picks = plan_reads(target, available)
        pieces = [(rng, mgr1._read_shard("step_00000001", s))
                  for rng, s in picks]
        np.testing.assert_array_equal(assemble(target, pieces, w.dtype),
                                      w[a:b])


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_buddy_replica_chunk_loss_recovery(tmp_path, mode):
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 3, codec="raw", replicas=2,
                        n_writers=2, mode=mode, chunk_size=512)
    assert_same_store(mgr.store.root, jm.store.root)
    if mode == "incremental":
        prim = next(p for p in sorted(mgr.store.root.rglob("*.obj")))
    else:
        prim = _primary_shard(mgr.store.root)
    prim.unlink()
    restored, _ = mgr.restore(abstract(torch_state(st)))
    assert_bits(restored, st)


def test_manifest_is_single_handle(tmp_path):
    st = np_state()
    mgr, jm = save_both(tmp_path, st, 1, n_writers=4)
    m = mgr.load_manifest(1)
    files = [s["file"] for rec in m["leaves"].values()
             for s in rec["shards"]]
    assert len(files) == len(leaf_paths(st))
    for f in files:
        assert (mgr.store.root / "step_00000001" / f).exists()
    assert manifest_bytes(m) == manifest_bytes(jm.load_manifest(1))
