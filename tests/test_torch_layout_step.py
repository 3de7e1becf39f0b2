"""The layout step (``train.steps._layout_step``) against the one-device
step, on gloo ranks: reduced gemma3-1b, gemma2-9b (softcap, local window),
llama4-scout, kimi-k2 (a dense first layer), mamba2-780m,
recurrentgemma-9b and hubert-xlarge, on (2,2) with no flag,
``seq_shard_resid`` and ``dp_over_model``, on (1,4), where the kv heads do
not divide, and on (1,8) with ``seq_shard_attn``, where the heads do not
divide; and on (2,2) under the remat policies other than ``nothing``
(``full``, ``dots``, ``offload_resid``).

Four and eight processes each take one step of every case from the same
seed and batch: the loss, the metrics and the gradient norm, each rank's
gradient shards and the parameters after the step equal the one-device
step's within ``tests/test_torch_train.py``'s tolerances. A spy on
``sharding.collectives.gather_param`` records every parameter gather of
the step: none returns more than one layer's leaf, and
``DTensor.full_tensor`` is never called. Under every policy but ``full``
the backward gathers each layer's leaves again (a rank holds one layer's
gathered weights at a time); under ``full`` it keeps them, so the step
gathers each layer once: fewer gathers than under ``nothing``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
ALL = ["gemma3-1b", "gemma2-9b", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
       "mamba2-780m", "recurrentgemma-9b", "hubert-xlarge"]
SP = {"seq_shard_resid": True}
CASES4 = [(a, (2, 2), {}) for a in ALL] + \
    [(a, (2, 2), SP) for a in ["gemma2-9b", "llama4-scout-17b-a16e",
                               "kimi-k2-1t-a32b", "recurrentgemma-9b",
                               "hubert-xlarge"]] + \
    [(a, (2, 2), {"dp_over_model": True}) for a in ["gemma3-1b",
                                                    "mamba2-780m",
                                                    "hubert-xlarge"]] + \
    [(a, (1, 4), {}) for a in ["gemma3-1b", "gemma2-9b",
                               "llama4-scout-17b-a16e", "mamba2-780m",
                               "recurrentgemma-9b"]] + \
    [("gemma3-1b", (2, 2), {"remat_policy": p})
     for p in ("full", "dots", "offload_resid")]
CASES8 = [(a, (1, 8), {"seq_shard_attn": True})
          for a in ["gemma3-1b", "gemma2-9b", "llama4-scout-17b-a16e",
                    "kimi-k2-1t-a32b", "hubert-xlarge"]] + \
    [("gemma2-9b", (1, 8), {"seq_shard_attn": True, **SP})]

# (world, cases, f32 elements a reduce-scatter stages at once): the four
# ranks' FSDP gradients go through the blocked staging, the eight ranks'
# (no FSDP axis) through one block, as at the default
POOLS = [(4, CASES4, 1 << 12), (8, CASES8, 1 << 26)]

RANK = """
import os, sys, json, logging, dataclasses
sys.path.insert(0, {src!r})
logging.disable(logging.INFO)
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.split_state import (abstract_train_state,
                                          init_train_state, leaf_paths,
                                          state_shardings, tree_unflatten)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.model import set_constrainer
from repro_torch.optim import make_optimizer
from repro_torch.sharding import collectives
from repro_torch.sharding.partition import batch_spec, distribute_tree
from repro_torch.train.steps import make_train_step

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
# the gradient reduce-scatters stage blocks of at most this many elements
collectives._STAGE_ELEMS = {stage}
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)

def local(t):
    return t.to_local() if isinstance(t, DTensor) else t

def slice_of(full, sh):
    rng = sh.local_range(tuple(full.shape))
    return full[tuple(slice(a, b) for a, b in zip(rng.start, rng.stop))]

records = []
inner = collectives.gather_param

def spy(t, gathers=(), replicated=()):
    out = inner(t, gathers, replicated)
    records.append(out.numel())
    return out

def no_full_tensor(self, *a, **kw):
    raise AssertionError("full_tensor called in the step")

out = []
for arch, shape, flags in {cases!r}:
    cfg = dataclasses.replace(reduced(CONFIGS[arch]), **flags)
    model, opt = Model(cfg), make_optimizer(cfg)
    pipe = SyntheticPipeline(cfg, batch=4, seq_len=32, device="cpu")
    host, _ = pipe.next_host(pipe.init_state(5))
    batch = {{k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}}
    # the one-device step
    set_constrainer(None)
    one = init_train_state(model, opt, seed=3, device="cpu")
    live = [p.detach().requires_grad_() for _, p in leaf_paths(one["params"])]
    loss1, _ = model.loss(tree_unflatten(one["params"], live), batch)
    g1 = dict(zip([n for n, _ in leaf_paths(one["params"])],
                  torch.autograd.grad(loss1, live, allow_unused=True,
                                      materialize_grads=True)))
    _, m1 = make_train_step(model, opt)(one, batch)
    # the layout step on the mesh
    mesh = make_host_mesh(shape, ("data", "model"), device="cpu")
    sh = state_shardings(abstract_train_state(model, opt), mesh, opt)
    state = distribute_tree(init_train_state(model, opt, seed=3,
                                             device="cpu"), sh)
    bsh = batch_spec(batch, mesh, cfg)
    lb = {{k: slice_of(v, bsh[k]) for k, v in batch.items()}}
    axes = bsh[next(iter(batch))].dim_axes(2)[0]
    step = make_train_step(model, opt, shardings=sh, batch_axes=axes)
    records.clear()
    collectives.gather_param = spy
    full_tensor, DTensor.full_tensor = DTensor.full_tensor, no_full_tensor
    try:
        _, _, gm = step.grads(state, lb)
        _, m = step(state, lb)
    finally:
        collectives.gather_param = inner
        DTensor.full_tensor = full_tensor
    psh = dict(leaf_paths(sh["params"]))
    layer_max = max(t.numel() // (t.shape[0] if n.startswith("stage_")
                                  else 1)
                    for n, t in leaf_paths(model.abstract_params()))
    grad_err, param_err = {{}}, {{}}
    for n, g in leaf_paths(gm):
        ref = slice_of(g1[n], psh[n])
        grad_err[n] = [float((g - ref).abs().max()),
                       float(g1[n].abs().max())]
    for (n, p), (_, p1) in zip(leaf_paths(state["params"]),
                               leaf_paths(one["params"])):
        param_err[n] = float((local(p) - slice_of(p1, psh[n])).abs().max())
    keys = sorted(k for k in m1 if k != "lr")
    out.append({{"case": [arch, list(shape), flags],
                 "metrics": {{k: [float(m[k]), float(m1[k])] for k in keys}},
                 "lr": float(m1["lr"]), "grad_err": grad_err,
                 "param_err": param_err, "gathers": len(records),
                 "gather_max": max(records, default=0),
                 "layer_max": layer_max,
                 "local_params": sum(local(p).numel() for _, p in
                                     leaf_paths(state["params"])),
                 "total_params": sum(t.numel() for _, t in
                                     leaf_paths(model.abstract_params()))}})
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(code, world, root):
    """`code` in `world` processes; each writes its stdout and stderr to
    files under `root` (a rank blocked on a full pipe would stall its
    peers at their next collective)."""
    procs = []
    for r in range(world):
        out = open(root / f"rank{r}.out", "w+")
        err = open(root / f"rank{r}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], stdout=out, stderr=err,
            env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                 "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}),
            out, err))
    return procs


def _collect(procs, timeout):
    """Every rank's RESULT; the first failing rank's stderr otherwise."""
    texts = []
    try:
        for p, out, err in procs:
            p.wait(timeout=timeout)
            out.seek(0)
            err.seek(0)
            texts.append((p.returncode, out.read(), err.read()))
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            out.close()
            err.close()
    errs = sorted((("Connection closed" in e, r, e)
                   for r, (rc, _, e) in enumerate(texts) if rc))
    assert not errs, f"rank {errs[0][1]}: {errs[0][2][-4000:]}"
    return [json.loads(next(l for l in o.splitlines()
                            if l.startswith("RESULT::"))[len("RESULT::"):])
            for _, o, _ in texts]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both pools at once: every rank's result per case, by case key."""
    root = tmp_path_factory.mktemp("layout")
    pools = []
    for w, cases, stage in POOLS:
        (root / str(w)).mkdir()
        pools.append(_spawn(RANK.format(src=SRC, store=str(root / f"store{w}"),
                                        cases=cases, stage=stage), w,
                            root / str(w)))
    out = {}
    for procs in pools:
        for rank_out in _collect(procs, 600):
            for r in rank_out:
                out.setdefault(_key(*r["case"]), []).append(r)
    return out


def _key(arch, shape, flags):
    names = [f"{k}={v}" if isinstance(v, str) else k
             for k, v in sorted(flags.items())]
    return f"{arch}-{tuple(shape)}-{'+'.join(names) or 'none'}"


FULL = [c for c in CASES4 if c[2].get("remat_policy") == "full"]


@pytest.mark.parametrize("case", [_key(*c) for c in CASES4 + CASES8])
def test_layout_step_matches_one_device(results, case):
    ranks = results[case]
    assert len(ranks) in (4, 8)
    for r in ranks:
        for k, (got, ref) in r["metrics"].items():
            assert abs(got - ref) <= 2e-5 * abs(ref) + 1e-7, (k, got, ref)
        # per leaf within 1e-4 of its largest gradient; a leaf whose
        # gradient is zero but for rounding (a k bias: the softmax ignores
        # a shift shared by every key) within 1e-7 of the step's largest
        top = max(scale for _, scale in r["grad_err"].values())
        for n, (err, scale) in r["grad_err"].items():
            assert err <= 1e-4 * scale + 1e-7 * top, (n, err, scale)
        for n, err in r["param_err"].items():
            # parameters within a tenth of one step, as test_torch_train
            assert err <= 0.1 * r["lr"], (n, err, r["lr"])
        # the metrics every rank reports are the same
        assert r["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("case", [_key(*c) for c in CASES4 + CASES8
                                  if c not in FULL])
def test_layout_step_gathers_one_layer_at_a_time(results, case):
    for r in results[case]:
        assert r["gathers"] > 0
        assert r["gather_max"] <= r["layer_max"], r
        assert r["local_params"] < r["total_params"]


@pytest.mark.parametrize("case", FULL)
def test_full_keeps_every_layers_gathered_weights(results, case):
    """Under ``full`` no layer is recomputed: each gather is still one
    layer's leaf, but the step gathers fewer times than under ``nothing``
    (whose backward gathers every layer again), and ``dots`` gathers as
    often as ``nothing``."""
    arch, shape, _ = case
    full = results[_key(*case)]
    nothing = results[_key(arch, shape, {})]
    dots = results[_key(arch, shape, {"remat_policy": "dots"})]
    for f, n, d in zip(full, nothing, dots):
        assert 0 < f["gathers"] < n["gathers"] == d["gathers"]
        assert f["gather_max"] <= f["layer_max"]
