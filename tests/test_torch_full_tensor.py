"""``sharding.collectives.full_tensor`` against ``DTensor.full_tensor`` on
four gloo ranks of the CPU, on a (2,2) mesh: one tensor dim sharded by
both mesh dims (gathered innermost first), two tensor dims each sharded by
one, Shard and Replicate mixed, nothing sharded, in f32 and bf16. Both
give the seeded full tensor, bit for bit, on every rank. Uneven shards
raise ``ValueError`` on every rank before any collective (none hangs)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD = 4
# (placements over the (2,2) mesh, full shape, dtype)
CASES = {
    "S0xS0": ([("shard", 0), ("shard", 0)], (8, 6), "float32"),
    "S0xS1": ([("shard", 0), ("shard", 1)], (4, 6), "float32"),
    "S1xS0": ([("shard", 1), ("shard", 0)], (4, 6, 3), "bfloat16"),
    "RxS1": ([("replicate",), ("shard", 1)], (3, 8), "float32"),
    "S2xR": ([("shard", 2), ("replicate",)], (3, 5, 4), "bfloat16"),
    "RxR": ([("replicate",), ("replicate",)], (5, 3), "float32"),
}
UNEVEN = {"uneven-RxS1": ([("replicate",), ("shard", 1)], (6, 5),
                          "float32"),
          "uneven-S0xS0": ([("shard", 0), ("shard", 0)], (6, 2),
                           "float32")}

RANK = """
import os, sys, json
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import collectives

rank = int(os.environ["RANK"])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore({store!r}, {world}),
                        rank=rank, world_size={world})
mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")

def placements(spec):
    return [Shard(p[1]) if p[0] == "shard" else Replicate() for p in spec]

out = {{}}
for i, (name, (spec, shape, dtype)) in enumerate(sorted({cases!r}.items())):
    full = torch.from_numpy(np.random.default_rng(i).standard_normal(
        shape).astype(np.float32)).to(getattr(torch, dtype))
    dt = distribute_tensor(full, mesh, placements(spec))
    try:
        got = collectives.full_tensor(dt)
    except ValueError as e:
        out[name] = {{"error": str(e)}}
        continue
    ref = dt.full_tensor()
    out[name] = {{"local": list(dt.to_local().shape),
                  "shape": list(got.shape), "dtype": str(got.dtype),
                  "equal_ref": bool(torch.equal(got, ref)),
                  "equal_full": bool(torch.equal(got, full))}}
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's result per case (each rank's output to a file: a rank
    blocked on a full pipe would stall its peers)."""
    root = tmp_path_factory.mktemp("full_tensor")
    code = RANK.format(src=SRC, store=str(root / "store"), world=WORLD,
                       cases={**CASES, **UNEVEN})
    procs = []
    for r in range(WORLD):
        out = open(root / f"rank{r}.out", "w+")
        err = open(root / f"rank{r}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], stdout=out, stderr=err,
            env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                 "OMP_NUM_THREADS": "1"}), out, err))
    texts = []
    try:
        for p, out, err in procs:
            p.wait(timeout=120)
            out.seek(0)
            err.seek(0)
            texts.append((p.returncode, out.read(), err.read()))
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            out.close()
            err.close()
    for r, (rc, _, e) in enumerate(texts):
        assert rc == 0, f"rank {r}: {e[-4000:]}"
    return [json.loads(next(l for l in o.splitlines()
                            if l.startswith("RESULT::"))[len("RESULT::"):])
            for _, o, _ in texts]


@pytest.mark.parametrize("name", sorted(CASES))
def test_full_tensor_matches_dtensor_full_tensor(results, name):
    spec, shape, dtype = CASES[name]
    split = [1] * len(shape)
    for p in spec:
        if p[0] == "shard":
            split[p[1]] *= 2
    for r in results:
        got = r[name]
        assert got["local"] == [n // k for n, k in zip(shape, split)]
        assert got["shape"] == list(shape)
        assert got["dtype"] == f"torch.{dtype}"
        assert got["equal_ref"] and got["equal_full"], got


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_full_tensor_refuses_uneven_shards(results, name):
    for r in results:
        assert "uneven shards" in r[name].get("error", ""), r[name]
