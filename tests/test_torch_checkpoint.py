"""The slice as a whole: one incremental CDC checkpoint round of a
(reduced) gemma3-1b training state, written by the port and by the JAX
package under the same policy, must produce identical manifest leaf
records and CAS objects, and each package must restore the other's
checkpoint bit-exactly. The port forces its device path
(``scan_backend="pallas"`` on ``device="cpu"``), so the kernels' plain
versions run inside the manager."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jg
from repro.core import policy as jpolicy
from repro.core.checkpoint import CheckpointManager as JManager
from repro.core.split_state import abstract_train_state, init_train_state
from repro.core.split_state import leaf_paths as jleaf_paths
from repro.core.storage import Tier as JTier
from repro.core.storage import TieredStore as JStore
from repro.models.model import Model
from repro.optim.adamw import AdamW
from repro_torch.configs import gemma3_1b as tg
from repro_torch.convert import from_jax_state, to_numpy_state
from repro_torch.core import policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.state import train_state

NARROW = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
              head_dim=32, d_ff=256, vocab_size=2048)
CHUNK = 16 << 10


def _policy(mod, backend):
    return mod.CheckpointPolicy(
        mode="incremental",
        chunking=mod.ChunkingPolicy(scheme="cdc", chunk_size=CHUNK,
                                    scan_backend=backend),
        pipeline=mod.PipelinePolicy(io_threads=8),
        durability=mod.DurabilityPolicy(keepalive_s=60.0),
        codec=mod.CodecPolicy(codec="raw", params_codec="byteplane-rle"))


def _bits(t):
    """Bit pattern of a tensor, for bit-exact comparison."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def _np_bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind in "fV" or \
        str(a.dtype) == "bfloat16" else a


def _assert_same_state(a, b):
    pa, pb = leaf_paths(a), leaf_paths(b)
    assert [n for n, _ in pa] == [n for n, _ in pb]
    for (name, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


@pytest.fixture(scope="module")
def jax_state():
    """Reduced gemma3-1b state from the JAX package, with seeded noise in
    the AdamW moments (zeros would make every moment chunk identical)."""
    cfg = dataclasses.replace(jg.CONFIG, **NARROW)
    st = init_train_state(Model(cfg), AdamW(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    out = {}
    for name, leaf in jleaf_paths(st):
        a = np.asarray(leaf)
        if name.startswith("opt/") and a.dtype == np.float32:
            a = (rng.standard_normal(a.shape) * 1e-3).astype(np.float32)
        out[name] = a
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(st), [out[n] for n, _ in jleaf_paths(st)])
    return tree


def _saved_pair(tmp_path, jax_state):
    jstore = JStore(JTier("fast", tmp_path / "jax"))
    jmgr = JManager(jstore, policy=_policy(jpolicy, "auto"))
    jrep = jmgr.save(jax.tree.map(jnp.asarray, jax_state), 1)
    tstore = TieredStore(Tier("fast", tmp_path / "port"))
    tmgr = CheckpointManager(tstore, _policy(tpolicy, "pallas"),
                             device="cpu")
    state = from_jax_state(jax_state, device="cpu")
    trep = tmgr.save(state, 1)
    return jmgr, jrep, tmgr, trep, state


def test_state_specs_match_jax_full_gemma3_1b():
    """Full-size leaf names, shapes and dtypes, without allocating."""
    from repro_torch.state import param_specs
    abs_ = abstract_train_state(Model(jg.CONFIG), AdamW())
    ref = [(n, tuple(x.shape), str(x.dtype)) for n, x in jleaf_paths(abs_)]
    specs = param_specs(tg.CONFIG)

    def tree(dt):
        def walk(node):
            return {k: walk(v) if isinstance(v, dict) else (v[0], dt)
                    for k, v in node.items()}
        return walk(specs)

    port = {"params": tree("bfloat16"),
            "opt": {"m": tree("float32"), "v": tree("float32"),
                    "count": ((), "int32")},
            "step": ((), "int32"), "rng": ((2,), "uint32")}

    def flat(node, prefix=""):
        for k in sorted(node):
            v = node[k]
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from flat(v, name)
            else:
                yield (name, tuple(v[0]), v[1])

    got = list(flat(port))
    assert got == ref
    assert len(got) == 321
    assert got[0][0] == "opt/count" and got[-1][0] == "step"


def test_reduced_state_matches_jax_init_layout():
    cfg_j = dataclasses.replace(jg.CONFIG, **NARROW)
    cfg_t = dataclasses.replace(tg.CONFIG, **NARROW)
    ref = abstract_train_state(Model(cfg_j), AdamW())
    st = train_state(cfg_t, "cpu", seed=3)
    assert [(n, tuple(x.shape), str(x.dtype)) for n, x in jleaf_paths(ref)] \
        == [(n, tuple(x.shape), str(x.dtype).split(".")[1])
            for n, x in leaf_paths(st)]
    again = train_state(cfg_t, "cpu", seed=3)
    _assert_same_state(st, again)
    m = st["opt"]["m"]["embed"]
    assert m.abs().max() > 0 and st["params"]["embed"].std() > 0.01


def test_manifest_leaves_and_cas_objects_identical(tmp_path, jax_state):
    jmgr, jrep, tmgr, trep, _ = _saved_pair(tmp_path, jax_state)
    jm, tm = jmgr.load_manifest(1), tmgr.load_manifest(1)
    assert tm["leaves"] == jm["leaves"]
    assert tm["format"] == jm["format"] == 7
    assert tmgr.chunks.digests_on_disk() == jmgr.chunks.digests_on_disk()
    assert trep["new_object_bytes"] == jrep["new_object_bytes"]
    emb = tm["leaves"]["params/embed"]["shards"][0]
    assert emb["codec"] == "byteplane-rle" and len(emb["chunks"]) > 1
    assert "chunk_raw_lens" in emb
    mrec = tm["leaves"]["opt/m/embed"]["shards"][0]
    assert mrec["codec"] == "raw" and len(mrec["chunk_lens"]) > 1


def test_cross_package_restore_both_ways(tmp_path, jax_state):
    jmgr, _, tmgr, _, state = _saved_pair(tmp_path, jax_state)
    # the port restores the JAX package's checkpoint
    port_on_jax = CheckpointManager(TieredStore(Tier("fast", tmp_path
                                                     / "jax")),
                                    _policy(tpolicy, "pallas"),
                                    device="cpu")
    got, _ = port_on_jax.restore(state)
    _assert_same_state(got, state)
    # the JAX package restores the port's checkpoint
    jax_on_port = JManager(JStore(JTier("fast", tmp_path / "port")),
                           policy=_policy(jpolicy, "auto"))
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jax_state)
    back, _ = jax_on_port.restore(abstract)
    for (name, a), (_, b) in zip(jleaf_paths(back), jleaf_paths(jax_state)):
        np.testing.assert_array_equal(_np_bits(a), _np_bits(b), name)
    # and the port's numpy view of its own state is the same bits
    for (name, a), (_, b) in zip(leaf_paths(to_numpy_state(state)),
                                 jleaf_paths(jax_state)):
        np.testing.assert_array_equal(a.view(_np_bits(b).dtype)
                                      if a.dtype.itemsize > 1 else a,
                                      _np_bits(b), name)


def test_streaming_restore_and_async_save(tmp_path, jax_state):
    _, _, tmgr, trep, state = _saved_pair(tmp_path, jax_state)
    state["params"]["embed"][:7].add_(1)
    state["step"] += 1
    expected = from_jax_state(to_numpy_state(state), device="cpu")
    rep = tmgr.save(state, 2, blocking=False)
    assert rep["async"]
    # the snapshot is a copy: updating the live state while the round
    # persists must not leak into step 2
    state["params"]["embed"].add_(3)
    tmgr.wait()
    assert tmgr.latest_step() == 2
    assert 0 < tmgr.last_report["new_object_bytes"] \
        < trep["new_object_bytes"] / 4
    full, _ = tmgr.restore(state)
    _assert_same_state(full, expected)
    stream, _ = tmgr.restore_streaming(state, step=2)
    _assert_same_state(stream.wait_frontier().state(), full)
    old, _ = tmgr.restore(state, step=1)
    assert not torch.equal(_bits(old["params"]["embed"]),
                           _bits(full["params"]["embed"]))


def test_cuda_manager_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointManager(TieredStore(Tier("fast", tmp_path / "x")),
                          _policy(tpolicy, "auto"))
    with pytest.raises(RuntimeError):
        train_state(dataclasses.replace(tg.CONFIG, **NARROW))
