"""The port's public API snapshot: ``tests/test_api_surface.py``'s five
pins held on ``repro_torch.core``, each against the reference suite's
pinned values and against the reference's own objects — the exported
names, ``CheckpointManager``'s policy-first signature, ``LEGACY_KWARGS``,
the policy fields and defaults, ``DEFAULT_IO_THREADS`` and
``DEFAULT_REMOTE_PART_BYTES``.

One difference by design: the port's manager also takes the keyword-only
``device`` (``None`` → the card) and ``group`` (a process group for a
sharded save) between ``policy`` and ``**legacy``. ~17 s alone at
``-n 6 --dist loadfile`` (importing both packages)."""
import inspect

import repro.core as jcore
import repro.core.chunk_exec as jchunk_exec
import repro.core.policy as jpolicy
import repro.core.storage as jstorage
import test_api_surface as ref

import repro_torch.core as core
from repro_torch.core.chunk_exec import DEFAULT_IO_THREADS
from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                     CodecPolicy, DurabilityPolicy,
                                     LEGACY_KWARGS, PipelinePolicy,
                                     RestorePolicy)
from repro_torch.core.storage import DEFAULT_REMOTE_PART_BYTES

POLICIES = ("ChunkingPolicy", "PipelinePolicy", "DurabilityPolicy",
            "CodecPolicy", "RestorePolicy", "CheckpointPolicy")


def test_core_exports_are_pinned():
    assert sorted(core.__all__) == sorted(ref.EXPORTED)
    assert sorted(core.__all__) == sorted(jcore.__all__)
    for name in ref.EXPORTED:
        assert hasattr(core, name), name


def test_checkpoint_manager_signature_is_policy_first():
    """The reference's ``(self, store, policy=None, **legacy)`` with the
    port's keyword-only ``device`` and ``group`` before ``**legacy``."""
    params = list(inspect.signature(
        core.CheckpointManager.__init__).parameters.values())
    names = [p.name for p in params]
    assert names == ["self", "store", "policy", "device", "group", "legacy"]
    assert params[2].default is None
    for p in params[3:5]:
        assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
    assert params[5].kind is inspect.Parameter.VAR_KEYWORD
    jnames = list(inspect.signature(
        jcore.CheckpointManager.__init__).parameters)
    assert [n for n in names if n not in ("device", "group")] == jnames


def test_legacy_kwargs_are_frozen():
    assert LEGACY_KWARGS == ref.LEGACY_KWARGS == jpolicy.LEGACY_KWARGS
    assert LEGACY_KWARGS == (
        "n_writers", "codec", "params_codec", "replicas", "retain",
        "keepalive_s", "save_timeout_s", "max_retries",
        "async_drain_to_slow", "mode", "chunk_size", "chunking",
        "scan_backend", "io_threads")


def test_policy_fields_and_defaults_are_pinned():
    assert DEFAULT_IO_THREADS == jchunk_exec.DEFAULT_IO_THREADS
    assert DEFAULT_REMOTE_PART_BYTES == jstorage.DEFAULT_REMOTE_PART_BYTES
    assert ref._fields(ChunkingPolicy) == {
        "scheme": "fixed", "chunk_size": 1 << 20, "min_size": None,
        "max_size": None, "scan_backend": "auto"}
    assert ref._fields(PipelinePolicy) == {
        "io_threads": DEFAULT_IO_THREADS, "persist_queue_depth": 1,
        "host_bytes_budget": None, "read_cache_bytes": 1 << 30,
        "async_drain": None}
    assert ref._fields(DurabilityPolicy) == {
        "replicas": 1, "retain": 3, "keepalive_s": 10.0,
        "save_timeout_s": 600.0, "max_retries": 1,
        "io_retries": 2, "io_backoff_ms": 5.0, "io_deadline_s": 30.0}
    assert ref._fields(CodecPolicy) == {"codec": None, "params_codec": None,
                                        "device_precondition": None,
                                        "device_entropy": None}
    assert ref._fields(RestorePolicy) == {
        "streaming": False, "frontier_classes": 2,
        "remote_part_bytes": DEFAULT_REMOTE_PART_BYTES}
    top = ref._fields(CheckpointPolicy)
    assert list(top) == ["mode", "n_writers", "chunking", "pipeline",
                         "durability", "codec", "restore"]
    assert top["mode"] == "full" and top["n_writers"] == 4
    # field for field, default for default, the reference's classes
    import repro_torch.core.policy as tpolicy
    for name in POLICIES:
        mine, theirs = (ref._fields(getattr(m, name))
                        for m in (tpolicy, jpolicy))
        assert list(mine) == list(theirs), name
        for field, default in theirs.items():
            if hasattr(default, "__dataclass_fields__"):
                assert vars(mine[field]) == vars(default), (name, field)
            else:
                assert mine[field] == default, (name, field)


def test_manager_config_surface_reads_from_policy(tmp_path):
    """The pre-policy attribute surface (mode/chunking/replicas/…) stays
    readable but is a VIEW of the policy."""
    from repro_torch.core.storage import Tier, TieredStore
    mgr = core.CheckpointManager(
        TieredStore(Tier("f", tmp_path)),
        policy=CheckpointPolicy(mode="incremental",
                                durability=DurabilityPolicy(
                                    keepalive_s=60.0, replicas=2)),
        device="cpu")
    assert (mgr.mode, mgr.chunking, mgr.replicas) == \
        ("incremental", "fixed", 2)
    assert mgr.n_writers == 4 and mgr.max_retries == 1
    assert mgr.save_timeout_s == 600.0
    mgr.close()
