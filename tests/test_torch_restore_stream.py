"""The port's streaming restore held to ``tests/test_restore_stream.py``:
the first-use classes and order, the schedule's frontier, the stream
bit-exact against the blocking restore at ``io_threads`` 1 and 4, a cold
restore off a ``RemoteTier``, the remote part-bytes policy, and the read
cache's single entry over its limit. Each case makes the reference
test's own assertions on the port's result; the schedule and frontier are
also held to the reference's plan over the same checkpoint, and restored
leaves to the saved ones bit for bit."""
import numpy as np
import pytest

import test_torch_checkpoint_engine as eng
from repro.core import elastic as jelastic
from repro_torch.core.elastic import (FIRST_USE_DEFAULT, FIRST_USE_TAIL,
                                      first_use_order, leaf_first_use_class)
from repro_torch.core.restore_path import ReadCache
from repro_torch.core.storage import (RemoteTier, Tier, TieredStore,
                                      mirror_to_tier)

STREAM_NAMES = (["params/embed", "params/lm_head", "opt/count", "step"]
                + [f"params/stage_0/b{k}/w" for k in range(4)])


def _np_state(layers=4, seed=7):
    """The reference suite's ``_state()`` shapes (its block leaves are keyed
    ``stage_0/b{k}/w`` inside ``params``), from a seed."""
    rng = np.random.default_rng(seed)
    params = {"embed": rng.standard_normal((32, 8), dtype=np.float32),
              "lm_head": rng.standard_normal((8, 32), dtype=np.float32)}
    for k in range(layers):
        params[f"stage_0/b{k}/w"] = rng.standard_normal((16, 8),
                                                        dtype=np.float32)
    return {"params": params,
            "opt": {"count": np.zeros((), np.int32)},
            "step": np.asarray(3, np.int32)}


# ---------------------------------------------------------------------------
# first-use ordering
# ---------------------------------------------------------------------------

def test_leaf_first_use_classes():
    """The reference's classes, and the port's class of each name equals
    the reference's."""
    assert leaf_first_use_class("params/embed") == 0
    assert leaf_first_use_class("step") == 0
    assert leaf_first_use_class("opt/count") == 0
    b0 = leaf_first_use_class("params/stage_0/b0/w")
    b1 = leaf_first_use_class("params/stage_0/b1/w")
    assert 0 < b0 < b1 < FIRST_USE_DEFAULT
    assert leaf_first_use_class("opt/f/something/v") == FIRST_USE_DEFAULT
    assert leaf_first_use_class("params/lm_head") == FIRST_USE_TAIL
    assert leaf_first_use_class("params/final_norm/scale") == FIRST_USE_TAIL
    assert b1 < leaf_first_use_class("params/final_norm/scale")
    assert (FIRST_USE_DEFAULT, FIRST_USE_TAIL) == \
        (jelastic.FIRST_USE_DEFAULT, jelastic.FIRST_USE_TAIL)
    for name in STREAM_NAMES + ["opt/f/something/v", "rng",
                                "params/final_norm/scale",
                                "opt/m/stage_0/b3/attn/wq"]:
        assert leaf_first_use_class(name) == \
            jelastic.leaf_first_use_class(name), name


def test_first_use_order_sorts_like_a_forward_pass():
    names = ["params/lm_head", "params/stage_0/b1/w", "params/embed",
             "params/stage_0/b0/w", "opt/f/misc", "step"]
    assert [names[i] for i in first_use_order(names)] == [
        "params/embed", "step", "params/stage_0/b0/w",
        "params/stage_0/b1/w", "opt/f/misc", "params/lm_head"]
    rev = first_use_order(names, priority=lambda n: -names.index(n))
    assert [names[i] for i in rev] == list(reversed(names))
    assert first_use_order(names) == jelastic.first_use_order(names)


def test_first_use_schedule_frontier(tmp_path):
    """The port's plan over its checkpoint: class 0 (embed and the
    scalars) and then block 0 make the frontier, and the schedule equals
    the reference's plan over the reference's checkpoint of the same
    state. (The port's ``_plan_restore`` returns no treedef: it rebuilds
    trees from the abstract state.)"""
    st = _np_state()
    mgr, jm = eng.save_both(tmp_path, st, 3, mode="incremental")
    eng.assert_same_store(mgr.store.root, jm.store.root)
    _, _, _, plan = mgr._plan_restore(eng.abstract(eng.torch_state(st)),
                                      None, None)
    schedule, frontier = plan.first_use_schedule(None, 2)
    names = [plan.jobs[i][0] for i in schedule]
    want_frontier = {"params/embed", "opt/count", "step",
                     "params/stage_0/b0/w"}
    assert set(plan.jobs[i][0] for i in frontier) == want_frontier
    assert set(names[:len(frontier)]) == want_frontier
    assert names[-1] == "params/lm_head"
    jplan = jm._plan_restore(eng.jabstract(st), None, None)[3]
    jschedule, jfrontier = jplan.first_use_schedule(None, 2)
    assert names == [jplan.jobs[i][0] for i in jschedule]
    assert list(frontier) == list(jfrontier)
    mgr.close()
    jm.close()


# ---------------------------------------------------------------------------
# the stream: frontier, completion gate, bit-exactness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("io_threads", [1, 4])
def test_streaming_bit_exact_vs_blocking(tmp_path, io_threads):
    st = _np_state()
    mgr = eng.mgr_at(tmp_path, mode="incremental", io_threads=io_threads,
                     streaming_restore=True)
    mgr.save(eng.torch_state(st), 3, extra={"tag": "x"})
    abstract = eng.abstract(eng.torch_state(st))
    blocking, _ = mgr.restore(abstract)

    stream, extra = mgr.restore_streaming(abstract)
    assert extra == {"tag": "x"}
    assert set(stream.names) == set(STREAM_NAMES)
    assert stream.wait_frontier() is stream
    for name in stream.frontier_names:
        assert stream.landed(name)
        assert stream.leaf(name) is stream.leaf(name)     # memoized touch
    got = stream.state()
    assert stream.state() is got
    assert stream.landed_count() == len(stream.names)
    eng.assert_same_tensors(blocking, got)
    eng.assert_bits(got, st)
    mgr.close()


def test_streaming_restore_cold_remote(tmp_path):
    """The only copy lives on the object-store tier; a cold store streams
    the restore off ranged GETs of 256 bytes, bit-exact."""
    st = _np_state()
    writer = eng.mgr_at(tmp_path / "writer", mode="incremental",
                        io_threads=4)
    writer.save(eng.torch_state(st), 3)
    writer.close()
    mirror_to_tier(Tier("w", tmp_path / "writer"),
                   RemoteTier("obj", tmp_path / "remote"))

    cold = eng.CheckpointManager(
        TieredStore(Tier("fast", tmp_path / "cold"),
                    remote=RemoteTier("obj", tmp_path / "remote",
                                      part_bytes=256,
                                      request_latency_s=0.0)),
        eng.tpolicy(mode="incremental", io_threads=4,
                    streaming_restore=True), device="cpu")
    assert cold.latest_step() == 3
    stream, _ = cold.restore_streaming(eng.abstract(eng.torch_state(st)))
    eng.assert_bits(stream.wait_frontier().state(), st)
    cold.close()


def test_remote_part_bytes_policy_reaches_the_tier(tmp_path):
    remote = RemoteTier("obj", tmp_path / "remote")
    mgr = eng.CheckpointManager(
        TieredStore(Tier("f", tmp_path / "fast"), remote=remote),
        eng.tpolicy(remote_part_bytes=1234), device="cpu")
    assert remote.part_bytes == 1234
    mgr.close()


# ---------------------------------------------------------------------------
# ReadCache: the single-oversized-entry pin
# ---------------------------------------------------------------------------

def test_read_cache_single_over_limit_entry_stays_resident():
    cache = ReadCache(limit=100)
    big = np.zeros(150, np.uint8)
    cache.put("big", big)
    assert cache.get("big") is big
    assert cache.nbytes == 150
    small = np.zeros(60, np.uint8)
    cache.put("small", small)
    assert cache.get("small") is small
    assert len(cache.entries) == 1 and cache.nbytes == 60
    assert cache.get("big") is None
