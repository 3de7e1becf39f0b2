"""The suites of the host modules that the port copies and then edits —
``tests/test_cas.py``, ``test_cdc.py``, ``test_storage.py``,
``test_chunk_exec.py``, ``test_policy.py`` and ``test_preempt.py`` — run
on the port: each suite's own source, with its ``repro`` imports pointed
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
reference's source apart from the import lines, so their suites need no
second copy. A few byte checks against the JAX package close the file."""
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
SUITES = ("cas", "cdc", "storage", "chunk_exec", "policy", "preempt")
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
