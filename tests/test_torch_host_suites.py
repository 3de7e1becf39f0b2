"""The suites of the host modules that the port copies —
``tests/test_cas.py``, ``test_cdc.py``, ``test_storage.py``,
``test_chunk_exec.py``, ``test_policy.py``, ``test_preempt.py``,
``test_coordinator_drain.py`` and ``test_elastic_plan.py`` — run on the
port: each suite's own source, with its ``repro`` imports pointed
at ``repro_torch`` and its shared policy factory at the port's, is loaded
as a module of its own, and its test functions are collected here as
``test_<suite>__<name>``, with their parametrisations and assertions.
Where a scenario builds its state with JAX, the helper that builds it
(and the suite's ``jnp.asarray``) is replaced by one that builds the same
shapes and dtypes as CPU tensors; the test body is the reference's. The
port's entry points default to the card; these suites run on the CPU, so
that default is the CPU here.

The copies that ROADMAP calls identical (``errors``, ``namespace``,
``atomic``, ``coordinator``, ``elastic``, ``faults``) are held to the
reference's source apart from the import lines; the coordinator's and the
elastic planner's suites run on them all the same. A few byte checks
against the JAX package and the planner's picks and bytes against the
reference's on random shard layouts close the file
(``quiesce_device_state`` on the card is in ``test_torch_suites_cuda.py``,
which imports no JAX)."""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_checkpoint_engine as eng
from repro_torch.core import cdc_scan as tscan
from repro_torch.core import checkpoint as tcheckpoint

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SUITES = ("cas", "cdc", "storage", "chunk_exec", "policy", "preempt",
          "coordinator_drain", "elastic_plan")
IDENTICAL = ("errors", "namespace", "atomic", "coordinator", "elastic",
             "faults")


def _cpu_default(resolve):
    def resolve_device(device=None):
        return resolve("cpu" if device is None else device)
    return resolve_device


@pytest.fixture(autouse=True)
def _entry_points_on_the_cpu(monkeypatch):
    for mod in (tscan, tcheckpoint):
        monkeypatch.setattr(mod, "resolve_device",
                            _cpu_default(mod.resolve_device))


def _torch_cas_state(dtype=None):
    """``test_cas._state``'s leaves (f32 params, one frozen leaf, an f32
    moment, an int32 step) as CPU tensors from a seed."""
    rng = np.random.default_rng(0)
    st = {"params": {"w": rng.standard_normal((32, 16), dtype=np.float32),
                     "frozen": rng.standard_normal((64, 16),
                                                   dtype=np.float32)},
          "opt": {"m": np.arange(32 * 16, dtype=np.float32)
                  .reshape(32, 16)},
          "step": np.asarray(0, np.int32)}
    return eng.torch_state(st)


class _TorchArrays:
    """Stands in for ``jax.numpy`` where a suite's test body builds a leaf
    with ``jnp.asarray``: the same values as a CPU tensor."""

    float32, int32, uint8 = np.float32, np.int32, np.uint8

    @staticmethod
    def asarray(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype=dtype))


# helpers of a suite that build JAX state, and their CPU-tensor versions
OVERRIDES = {
    "cas": {"_state": _torch_cas_state, "_abstract": eng.abstract,
            "jnp": _TorchArrays},
}


def _port_suite(suite: str) -> types.ModuleType:
    src = (TESTS / f"test_{suite}.py").read_text()
    src = re.sub(r"^(\s*)from repro\.", r"\1from repro_torch.", src,
                 flags=re.M)
    src = re.sub(r"^(\s*)import repro\.", r"\1import repro_torch.", src,
                 flags=re.M)
    src = src.replace(
        "from conftest import make_ckpt_policy",
        "from test_torch_checkpoint_engine import tpolicy as "
        "make_ckpt_policy")
    mod = types.ModuleType(f"test_torch_host_suites.{suite}")
    mod.__file__ = str(TESTS / f"test_{suite}.py")
    exec(compile(src, f"<port of tests/test_{suite}.py>", "exec"),
         mod.__dict__)
    mod.__dict__.update(OVERRIDES.get(suite, {}))
    return mod


for _suite in SUITES:
    _mod = _port_suite(_suite)
    for _name, _fn in list(vars(_mod).items()):
        if _name.startswith("test_") and callable(_fn):
            globals()[f"test_{_suite}__{_name[5:]}"] = _fn
del _suite, _mod, _name, _fn


def _body(path: Path) -> list:
    """A module's lines without its import statements (``import x``,
    ``from x import (a, b)``, continuation lines included)."""
    out, in_import = [], False
    for line in path.read_text().splitlines():
        if in_import:
            in_import = not line.rstrip().endswith(")")
            continue
        if re.match(r"(from \S+ )?import ", line):
            in_import = line.rstrip().endswith("(") or (
                "(" in line and not line.rstrip().endswith(")"))
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("name", IDENTICAL)
def test_identical_copies_match_the_reference(name):
    port = _body(SRC / "repro_torch" / "core" / f"{name}.py")
    ref = _body(SRC / "repro" / "core" / f"{name}.py")
    assert port == ref, f"core/{name}.py drifted from the reference"


# ---------------------------------------------------------------------------
# bytes against the JAX package on the suites' own inputs
# ---------------------------------------------------------------------------

def test_cas_state_saves_the_reference_bytes(tmp_path):
    """``test_cas``'s state under its incremental policy: the same
    manifest and CAS objects from both packages, and a bit-exact
    restore."""
    st = {k: v for k, v in eng.tree_map(lambda t: t.numpy(),
                                        _torch_cas_state()).items()}
    mgr, jm = eng.save_both(tmp_path, st, 1, codec="raw", n_writers=2,
                            mode="incremental", chunk_size=256)
    eng.assert_same_store(mgr.store.root, jm.store.root)
    restored, _ = mgr.restore(eng.abstract(eng.torch_state(st)))
    eng.assert_bits(restored, st)


@pytest.mark.parametrize("avg", [256, 1024, 16384])
def test_cdc_chunks_and_digests_match_the_reference(avg, rng):
    from repro.core import cas as jcas
    from repro.core.cdc import GearChunker as JGearChunker
    from repro_torch.core import cas as tcas
    from repro_torch.core.cdc import GearChunker
    payload = rng.bytes(300_001)
    cuts = GearChunker(avg, device="cpu").cut_points(payload)
    assert cuts == JGearChunker(avg).cut_points(payload)
    pos = 0
    for c in cuts:
        assert tcas.chunk_digest(payload[pos:c]) == \
            jcas.chunk_digest(payload[pos:c])
        pos = c


def _random_layout(rng):
    """A random global shape (0–3 dims), its shards: a grid cut of each
    dimension, now and then a second grid over the first (ranges of two
    topologies in one history), some shards repeated as replicas, now and
    then a zero-size shard, and a random target box inside the shape."""
    ndim = int(rng.integers(0, 4))
    shape = tuple(int(rng.integers(1, 9)) for _ in range(ndim))

    def grid():
        cuts = [sorted({0, n, *rng.integers(0, n + 1, rng.integers(0, 3))})
                for n in shape]
        boxes = [((), ())]
        for c in cuts:
            boxes = [(a + (lo,), b + (hi,)) for a, b in boxes
                     for lo, hi in zip(c[:-1], c[1:])]
        return boxes

    boxes = grid() + (grid() if rng.random() < 0.5 else [])
    boxes += [boxes[i] for i in rng.integers(0, len(boxes),
                                             rng.integers(0, 3))]
    if ndim and rng.random() < 0.3:
        boxes.append((tuple(0 for _ in shape), tuple(0 for _ in shape)))
    order = rng.permutation(len(boxes))
    lo = tuple(int(rng.integers(0, n)) for n in shape)
    hi = tuple(int(rng.integers(a + 1, n + 1)) for a, n in zip(lo, shape))
    return shape, [boxes[i] for i in order], (lo, hi)


def test_elastic_plan_picks_and_bytes_match_the_reference():
    """``plan_reads``/``assemble`` of both packages on 400 seeded random
    shard layouts: the same picks in the same order (ranges and handles)
    and the same assembled bytes."""
    from repro.core import elastic as jel
    from repro_torch.core import elastic as tel
    rng = np.random.default_rng(20260)
    for case in range(400):
        shape, boxes, (lo, hi) = _random_layout(rng)
        data = rng.integers(-2**31, 2**31, shape, dtype=np.int64) \
            .astype(np.int32)
        got = {}
        for name, mod in (("port", tel), ("ref", jel)):
            target = mod.ShardRange(lo, hi)
            avail = [(mod.ShardRange(a, b), i)
                     for i, (a, b) in enumerate(boxes)]
            picks = mod.plan_reads(target, avail)
            pieces = [(r, data[tuple(slice(a, b) for a, b in
                                     zip(r.start, r.stop))])
                      for r, _ in picks]
            got[name] = ([(r.start, r.stop, h) for r, h in picks],
                         mod.assemble(target, pieces, np.int32))
        assert got["port"][0] == got["ref"][0], case
        assert got["port"][1].tobytes() == got["ref"][1].tobytes(), case
        want = data[tuple(slice(a, b) for a, b in zip(lo, hi))]
        np.testing.assert_array_equal(got["port"][1], want)
