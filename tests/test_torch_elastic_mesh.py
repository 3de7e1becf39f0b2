"""Elastic (M×N) restore across meshes: the port's counterpart of
``tests/test_elastic_mesh.py``, for reduced gemma3-1b and kimi-k2.

Eight gloo processes train two steps on a (2,4) mesh, then re-form (4,2)
and (8,1) in the same world, and one process forms (1,1); each restores the
(2,4) checkpoint (``restored_from == 2``, the same ``params_digest``) and
trains one more step ((8,1) through the streaming restore). The sharded
step computes the one-device step's
function: its losses and gradient norms over the two steps, and the state
they leave, equal a one-device Trainer's from the same seed within
``tests/test_torch_train.py``'s tolerances — kimi-k2's MoE layers
included, whose token groups span the rows of several ranks."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["gemma3-1b", "kimi-k2-1t-a32b"]

COMMON = """
import os, sys, json, logging
sys.path.insert(0, {src!r})
logging.disable(logging.INFO)
import numpy as np
import torch
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.split_state import leaf_paths
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.loop import Trainer, TrainerConfig

root = {root!r}

def tc(arch, sub="mesh", ckpt_every=2, batch=4, streaming=False):
    return TrainerConfig(workdir=os.path.join(root, arch, sub), batch=batch,
                         seq_len=32, ckpt_every=ckpt_every, log_every=1,
                         seed=11, streaming_restore=streaming)

def dp_cfg():
    # gemma3-1b's preset: the batch shards over ("data", "model")
    import dataclasses
    from repro_torch.configs.presets import preset_overrides
    return dataclasses.replace(reduced(CONFIGS["gemma3-1b"]),
                               **preset_overrides("gemma3-1b"))

def hist(report):
    return [{{k: h[k] for k in ("loss", "nll", "grad_norm", "lr")}}
            for h in report["history"]]
"""

RANKS = COMMON + """
import torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)
out = {{}}
for arch in {archs!r}:
    cfg = reduced(CONFIGS[arch])
    mA = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    tA = Trainer(cfg, tc(arch), mesh=mA, device="cpu").init_or_restore()
    rep = tA.fit(2)
    res = {{"saved": tA.params_digest(), "history": hist(rep),
            "latest": tA.manager.latest_step(), "restores": {{}}}}
    tA.manager.close()
    for shape in [(4, 2), (8, 1)]:
        m = make_host_mesh(shape, ("data", "model"), device="cpu")
        # (8, 1) restores through the streaming path
        tB = Trainer(cfg, tc(arch, streaming=shape == (8, 1)), mesh=m,
                     device="cpu").init_or_restore()
        r = {{"from": tB.restored_from, "digest": tB.params_digest()}}
        after = tB.fit(3, stop_after=1)
        r["step"] = after["step"]
        r["loss"] = after["history"][-1]["loss"]
        tB.manager.close()
        res["restores"][str(shape)] = r
    out[arch] = res
# dp_over_model: eight rows, one a rank, over both axes of (2, 4)
t = Trainer(dp_cfg(), tc("dp", ckpt_every=0, batch=8), mesh=mA,
            device="cpu").init_or_restore()
out["dp_over_model"] = hist(t.fit(2))
t.manager.close()
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""

SINGLE = COMMON + """
from repro_torch.convert import to_numpy_state

def f32(a):
    # bf16 arrives as its uint16 bit pattern (codec.BF16)
    if a.dtype.metadata and a.dtype.metadata.get("logical") == "bfloat16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a)

out = {{}}
mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
from repro_torch.launch.mesh import make_production_mesh
for multi_pod in (False, True):
    try:
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    except ValueError as e:
        out["production_" + str(multi_pod)] = str(e)
for arch in {archs!r}:
    cfg = reduced(CONFIGS[arch])
    t = Trainer(cfg, tc(arch), mesh=mesh, device="cpu").init_or_restore()
    r = {{"from": t.restored_from, "digest": t.params_digest()}}
    np.savez(os.path.join(root, arch + "-sharded.npz"),
             **{{n.replace("/", "|"): f32(a) for n, a in
                 leaf_paths(to_numpy_state(t.state))}})
    after = t.fit(3, stop_after=1)
    r["step"], r["loss"] = after["step"], after["history"][-1]["loss"]
    t.manager.close()
    # the one-device step from the same seed, two steps
    one = Trainer(cfg, tc(arch, "one", ckpt_every=0), device="cpu")
    rep = one.init_or_restore().fit(2)
    one.manager.close()
    np.savez(os.path.join(root, arch + "-one.npz"),
             **{{n.replace("/", "|"): f32(a) for n, a in
                 leaf_paths(to_numpy_state(one.state))}})
    out[arch] = {{"restore": r, "history": hist(rep)}}
one = Trainer(dp_cfg(), tc("dp", "one", ckpt_every=0, batch=8),
              device="cpu").init_or_restore()
out["dp_over_model"] = hist(one.fit(2))
one.manager.close()
print("RESULT::" + json.dumps(out), flush=True)
"""


def _result(stdout):
    line = next(l for l in stdout.splitlines() if l.startswith("RESULT::"))
    return json.loads(line[len("RESULT::"):])


def run_ranks(code, world, timeout):
    """`code` in `world` processes (RANK/WORLD_SIZE in the environment);
    each rank's RESULT dict."""
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
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    fmt = dict(src=SRC, root=str(root), archs=ARCHS)
    ranks = run_ranks(RANKS.format(store=str(root / "store"), **fmt), 8,
                      300)
    single, = run_ranks(SINGLE.format(**fmt), 1, 300)
    return root, ranks, single


@pytest.mark.parametrize("shape", ["(4, 2)", "(8, 1)", "(1, 1)"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_mesh_restore(runs, arch, shape):
    _, ranks, single = runs
    saved = ranks[0][arch]["saved"]
    assert all(r[arch]["saved"] == saved for r in ranks)
    assert all(r[arch]["latest"] == 2 for r in ranks)
    got = [single[arch]["restore"]] if shape == "(1, 1)" else \
        [r[arch]["restores"][shape] for r in ranks]
    for g in got:
        assert g["from"] == 2 and g["digest"] == saved
        # the restored state trains
        assert g["step"] == 3 and np.isfinite(g["loss"])


def test_production_mesh_needs_a_group_of_its_size(runs):
    _, _, single = runs
    assert "(16, 16) needs 256 ranks; the process group has 1" in \
        single["production_False"]
    assert "(2, 16, 16) needs 512 ranks" in single["production_True"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_loss_matches_one_device(runs, arch):
    _, ranks, single = runs
    sharded, one = ranks[0][arch]["history"], single[arch]["history"]
    assert len(sharded) == len(one) == 2
    for s, o in zip(sharded, one):
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(s[k], o[k], rtol=2e-5, err_msg=k)
    assert all(r[arch]["history"] == sharded for r in ranks)


def test_dp_over_model_step_matches_one_device(runs):
    """gemma3-1b's preset puts the batch over both mesh axes: eight rows
    on eight ranks, the gradients summed over ("data", "model")."""
    _, ranks, single = runs
    for s, o in zip(ranks[0]["dp_over_model"], single["dp_over_model"]):
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(s[k], o[k], rtol=2e-5, err_msg=k)
    assert all(r["dp_over_model"] == ranks[0]["dp_over_model"]
               for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_matches_one_device(runs, arch):
    """Two sharded steps leave the one-device state: parameters within a
    tenth of each step's learning rate, the moments within 1e-4 of their
    largest value (``test_torch_train.py``'s bounds, over two steps)."""
    root, _, single = runs
    lr = max(h["lr"] for h in single[arch]["history"])
    a = np.load(root / f"{arch}-sharded.npz")
    b = np.load(root / f"{arch}-one.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        x, y = a[name], b[name]
        if name.startswith("params|"):
            atol = 0.2 * lr
        elif x.dtype.kind == "f":
            atol = 1e-4 * np.abs(y).max() + 1e-20
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
            continue
        np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=name)
