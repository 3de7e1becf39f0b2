"""Sharded checkpoints across the packages: the reduced gemma3-1b training
state, moved across with ``convert.from_jax_state``, saved on a (2,2)
mesh by four port ranks (gloo processes, one v7 manifest through the
two-phase commit over the ranks) and by the JAX package with four host
devices (a subprocess). The manifests' ``leaves`` tables (every shard
record: range, file, codec, chunks) and ``format``, the CAS objects on
disk and ``new_object_bytes`` are equal; each package restores the
other's (2,2) checkpoint bit-exactly onto other meshes — JAX's onto the
port's (4,1), (1,4), (1,1) and one device (no mesh), the port's onto JAX's
(1,1) and (2,2);
and a write fault on rank 1 aborts the round on every rank: no manifest,
and the previous step still restores."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore

SRC = str(Path(__file__).resolve().parents[1] / "src")
NARROW = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
              head_dim=32, d_ff=256, vocab_size=2048)
CHUNK = 16 << 10

POLICY = """
def policy(mod, backend):
    return mod.CheckpointPolicy(
        mode="incremental",
        chunking=mod.ChunkingPolicy(scheme="cdc", chunk_size={chunk},
                                    scan_backend=backend),
        pipeline=mod.PipelinePolicy(io_threads=4),
        durability=mod.DurabilityPolicy(keepalive_s=60.0),
        codec=mod.CodecPolicy(codec="raw", params_codec="byteplane-rle"))
""".format(chunk=CHUNK)

JAX_SAVE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import gemma3_1b as jg
from repro.core import policy as jpolicy
from repro.core.checkpoint import CheckpointManager
from repro.core.split_state import init_train_state, leaf_paths, state_shardings
from repro.core.storage import Tier, TieredStore
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model
from repro.optim.adamw import AdamW
{policy}
root = {root!r}
cfg = dataclasses.replace(jg.CONFIG, **{narrow!r})
st = init_train_state(Model(cfg), AdamW(), jax.random.PRNGKey(0))
rng = np.random.default_rng(11)
flat, dtypes = {{}}, {{}}
for name, leaf in leaf_paths(st):
    a = np.asarray(leaf)
    if name.startswith("opt/") and a.dtype == np.float32:
        a = (rng.standard_normal(a.shape) * 1e-3).astype(np.float32)
    dtypes[name] = str(a.dtype)
    flat[name] = a
np.savez(os.path.join(root, "state.npz"),
         **{{n: a.view("u%d" % a.dtype.itemsize) if a.dtype.kind in "fV"
             or str(a.dtype) == "bfloat16" else a for n, a in flat.items()}})
json.dump(dtypes, open(os.path.join(root, "dtypes.json"), "w"))
tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(st),
                                    [flat[n] for n, _ in leaf_paths(st)])
mesh = make_host_mesh((2, 2), ("data", "model"))
state = jax.device_put(tree, state_shardings(tree, mesh, AdamW()))
mgr = CheckpointManager(TieredStore(Tier("fast", os.path.join(root, "jax"))),
                        policy=policy(jpolicy, "auto"))
rep = mgr.save(state, 1)
print("RESULT::" + json.dumps({{"new_object_bytes": rep["new_object_bytes"]}}))
"""

JAX_RESTORE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import numpy as np
import jax
from repro.core import policy as jpolicy
from repro.core.checkpoint import CheckpointManager
from repro.core.split_state import leaf_paths, state_shardings
from repro.core.storage import Tier, TieredStore
from repro.launch.mesh import make_host_mesh
from repro.optim.adamw import AdamW
{policy}
root = {root!r}
ref = np.load(os.path.join(root, "state.npz"))
mgr = CheckpointManager(TieredStore(Tier("fast", os.path.join(root, "port"))),
                        policy=policy(jpolicy, "auto"))
man = mgr.load_manifest(1)
abstract = {{}}
for name, rec in man["leaves"].items():
    node = abstract
    keys = name.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {{}})
    node[keys[-1]] = jax.ShapeDtypeStruct(tuple(rec["shape"]),
                                          jax.numpy.dtype(rec["dtype"]))
out = {{}}
for shape in [(1, 1), (2, 2)]:
    mesh = make_host_mesh(shape, ("data", "model"))
    got, _ = mgr.restore(abstract, state_shardings(abstract, mesh, AdamW()))
    ok = True
    for name, leaf in leaf_paths(got):
        a = np.asarray(leaf)
        a = a.view("u%d" % a.dtype.itemsize) if a.dtype.kind in "fV" \\
            or str(a.dtype) == "bfloat16" else a
        ok &= bool(np.array_equal(a, ref[name]))
        ok &= len(leaf.sharding.device_set) == shape[0] * shape[1]
    out[str(shape)] = ok
print("RESULT::" + json.dumps(out))
"""

PORT_RANK = """
import os, sys, json
sys.path.insert(0, {src!r})
import numpy as np
import torch, torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)
from repro_torch.convert import from_jax_state
from repro_torch.core import codec, policy as tpolicy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.errors import AbortedError
from repro_torch.core.faults import FaultPlane, wrap_store
from repro_torch.core.split_state import leaf_paths, state_shardings
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamW
{policy}
root = {root!r}
ref = np.load(os.path.join(root, "state.npz"))
dtypes = json.load(open(os.path.join(root, "dtypes.json")))
tree = {{}}
for name, a in ref.items():
    node = tree
    keys = name.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {{}})
    node[keys[-1]] = a.view(codec.BF16) if dtypes[name] == "bfloat16" \\
        else a.view(dtypes[name])
abstract = from_jax_state(tree, "cpu")
group = dist.new_group(backend="gloo")

def bits(t):
    v = {{torch.bfloat16: torch.int16, torch.float32: torch.int32,
          torch.uint32: torch.int32}}.get(t.dtype)
    return t.view(v) if v is not None else t

def same(state, full):
    return all(bool(torch.equal(bits(d.full_tensor()), bits(f)))
               for (_, d), (_, f) in zip(leaf_paths(state), leaf_paths(full)))

def mgr(sub, plane=None):
    store = TieredStore(Tier("fast", os.path.join(root, sub)))
    if plane is not None:
        wrap_store(store, plane)
    return CheckpointManager(store, policy(tpolicy, "pallas"),
                             device="cpu", group=group)

out = {{}}
if world == 4:
    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    sh = state_shardings(abstract, mesh, AdamW())
    state = from_jax_state(tree, "cpu", shardings=sh)
    rep = mgr("port").save(state, 1)
    out["new_object_bytes"] = rep["new_object_bytes"]
    out["rank_bytes"] = rep["rank_bytes"]
for shape in [(4, 1), (1, 4)] if world == 4 else [(1, 1)]:
    m = make_host_mesh(shape, ("data", "model"), device="cpu")
    jm = mgr("jax")
    got, _ = jm.restore(abstract, state_shardings(abstract, m, AdamW()))
    out[str(shape)] = same(got, abstract)
    out["bytes_read" + str(shape)] = jm.bytes_read
if world == 1:
    print("RESULT::" + json.dumps(out), flush=True)
    sys.exit(0)
# a write fault on rank 1 aborts the round on every rank
plane = FaultPlane()
f = mgr("fault", plane if rank == 1 else None)
f.save(state, 1)
for _, d in leaf_paths(state["opt"]["m"]):
    d.to_local().add_(1.0)          # new chunks on every rank
if rank == 1:
    plane.add("write", "eio", count=-1)
try:
    f.save(state, 2)
    out["aborted"] = False
except AbortedError as e:
    out["aborted"] = True
    out["reason"] = str(e)
out["latest"] = f.latest_step()
out["manifest2"] = os.path.exists(os.path.join(root, "fault", "step_00000002"))
if rank == 1:
    plane.specs.clear()
got, _ = f.restore(abstract, sh, step=1)
out["after_abort"] = same(got, abstract)
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _result(stdout):
    line = next(l for l in stdout.splitlines() if l.startswith("RESULT::"))
    return json.loads(line[len("RESULT::"):])


def _python(code, timeout):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _result(proc.stdout)


def run_ranks(code, world, store, timeout):
    """`code` in `world` processes (RANK/WORLD_SIZE in the environment,
    a gloo group over the FileStore `store`); each rank's RESULT dict."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
             "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"})
        for r in range(world)]
    done = []
    try:
        for p in procs:
            done.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # the rank that failed first, not the peers its exit disconnected
    errs = sorted((("Connection closed" in err, r, err)
                   for r, (p, (_, err)) in enumerate(zip(procs, done))
                   if p.returncode))
    assert not errs, f"rank {errs[0][1]}: {errs[0][2][-4000:]}"
    return [_result(out) for out, _ in done]


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    fmt = dict(src=SRC, root=str(root), policy=POLICY, narrow=NARROW)
    jax_save = _python(JAX_SAVE.format(**fmt), 300)
    ranks = run_ranks(PORT_RANK.format(store=str(root / "store"), **fmt),
                      4, str(root / "store"), 300)
    one, = run_ranks(PORT_RANK.format(store=str(root / "store1"), **fmt),
                     1, str(root / "store1"), 300)
    jax_restore = _python(JAX_RESTORE.format(**fmt), 300)
    return root, jax_save, ranks + [one], jax_restore


def _manager(root, sub):
    return CheckpointManager(TieredStore(Tier("fast", root / sub)),
                             tpolicy.CheckpointPolicy(
                                 mode="incremental",
                                 durability=tpolicy.DurabilityPolicy(
                                     keepalive_s=60.0)), device="cpu")


def test_manifest_leaves_and_cas_objects_equal_jax(rounds):
    root, jax_save, ranks, _ = rounds
    jm, tm = _manager(root, "jax"), _manager(root, "port")
    jman, tman = jm.load_manifest(1), tm.load_manifest(1)
    assert tman["format"] == jman["format"] == 7
    assert tman["leaves"] == jman["leaves"]
    assert tm.chunks.digests_on_disk() == jm.chunks.digests_on_disk()
    ranks = ranks[:4]
    assert all(r["new_object_bytes"] == jax_save["new_object_bytes"]
               for r in ranks)
    # every rank wrote its share; the sharded leaves have one record per
    # distinct range
    assert all(r["rank_bytes"] > 0 for r in ranks)
    emb = tman["leaves"]["params/embed"]["shards"]
    assert [(s["start"], s["stop"]) for s in emb] == \
        [([0, 0], [1024, 128]), ([1024, 0], [2048, 128])]
    assert tman["extra"] == {} and tman["leaves"]["step"]["shards"][0][
        "start"] == []


@pytest.mark.parametrize("shape", ["(4, 1)", "(1, 4)"])
def test_port_restores_jax_2x2_onto_other_meshes(rounds, shape):
    _, _, ranks, _ = rounds
    ranks = ranks[:4]
    assert all(r[shape] for r in ranks)
    # a rank reads the saved shards that overlap its range, not the model
    total = sum(r["bytes_read" + shape] for r in ranks)
    assert all(0 < r["bytes_read" + shape] < total for r in ranks)


def test_port_restores_jax_2x2_onto_1x1_mesh(rounds):
    root, _, ranks, _ = rounds
    one = ranks[4]
    assert one["(1, 1)"]
    # one rank reads every saved shard (a shard whose record repeats
    # another's is a read-cache hit); a rank of (4, 1) reads less
    leaves = _manager(root, "jax").load_manifest(1)["leaves"]
    total = sum(s["payload_bytes"] for rec in leaves.values()
                for s in rec["shards"])
    assert total - 1024 < one["bytes_read(1, 1)"] <= total
    assert all(r["bytes_read(4, 1)"] < one["bytes_read(1, 1)"]
               for r in ranks[:4])


def test_port_restores_jax_2x2_onto_one_device(rounds):
    root, _, _, _ = rounds
    ref = np.load(root / "state.npz")
    m = _manager(root, "jax")
    man = m.load_manifest(1)
    abstract = {}
    for name, rec in man["leaves"].items():
        node = abstract
        keys = name.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(tuple(rec["shape"]),
                                     dtype=getattr(torch, rec["dtype"]),
                                     device="meta")
    got, _ = m.restore(abstract)
    for name, t in leaf_paths(got):
        v = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
             torch.uint32: torch.int32}.get(t.dtype)
        a = (t.view(v) if v is not None else t).numpy()
        assert np.array_equal(a.view(ref[name].dtype), ref[name]), name


@pytest.mark.parametrize("shape", ["(1, 1)", "(2, 2)"])
def test_jax_restores_port_2x2(rounds, shape):
    _, _, _, jax_restore = rounds
    assert jax_restore[shape]


def test_write_fault_on_rank_1_aborts_every_rank(rounds):
    _, _, ranks, _ = rounds
    ranks = ranks[:4]
    for r in ranks:
        assert r["aborted"] and r["latest"] == 1 and not r["manifest2"]
        assert r["after_abort"]
    assert "rank 1" in ranks[0]["reason"]
