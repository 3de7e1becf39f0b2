"""Expert-parallel MoE (``repro_torch.models.moe_shard_map``) on eight
gloo ranks, mesh (2,4), reduced kimi-k2 and llama4-scout.

* The port of ``tests/test_moe_shard_map.py``: with ``capacity_factor =
  n_experts`` (nothing drops) the layout step's loss and gradients under
  ``moe_impl="shard_map"`` with an exec mesh, alone and with
  ``seq_shard_resid``, equal the ``gspmd`` route's (loss 1e-5, gradients
  5e-5).
* ``moe_apply_shard_map`` against the JAX package's on the same numpy
  params and tokens (the JAX side in one subprocess with eight host
  devices): once with ``capacity_factor = n_experts`` and once with the
  config's capacity over larger token slices, where tokens drop. y and the
  load-balance and z losses within 1e-5, ``drop_fraction`` equal."""
from pathlib import Path

import numpy as np
import pytest
from test_torch_layout_step import _collect, _spawn

from repro_torch.configs import CONFIGS, reduced

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"]
# (name, tokens (B, S), capacity factor: None is the config's)
APPLY = [("no_drop", (8, 16), "E"), ("drops", (8, 128), None)]

JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import sys, json, dataclasses
sys.path.insert(0, {src!r})
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import CONFIGS, reduced
from repro.launch.mesh import make_host_mesh
from repro.models.moe_shard_map import moe_apply_shard_map
from repro.sharding.partition import mesh_axes

mesh = make_host_mesh((2, 4), ("data", "model"))
ax = mesh_axes(mesh)
out = {{}}
for arch in {archs!r}:
    for name, _, cf in {apply!r}:
        d = np.load(os.path.join({root!r}, f"{{arch}}-{{name}}.npz"))
        base = reduced(CONFIGS[arch])
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=float(base.moe.n_experts)
            if cf == "E" else base.moe.capacity_factor))
        p = {{k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}}
        y, aux = jax.jit(lambda p, x: moe_apply_shard_map(
            p, x, cfg, mesh, ax))(p, jnp.asarray(d["x"]))
        np.save(os.path.join({root!r}, f"{{arch}}-{{name}}-jax-y.npy"),
                np.asarray(y))
        out[f"{{arch}}-{{name}}"] = {{k: float(v) for k, v in aux.items()}}
print("RESULT::" + json.dumps(out), flush=True)
"""

RANKS = """
import os, sys, json, logging, dataclasses
sys.path.insert(0, {src!r})
logging.disable(logging.INFO)
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.split_state import (abstract_train_state,
                                          init_train_state, leaf_paths,
                                          state_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.model import set_exec_mesh
from repro_torch.models.moe_shard_map import moe_apply_shard_map
from repro_torch.optim import make_optimizer
from repro_torch.sharding.partition import (batch_spec, distribute_tree,
                                            mesh_axes)
from repro_torch.train.steps import make_train_step

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)
mesh = make_host_mesh((2, 4), ("data", "model"), device="cpu")
ax = mesh_axes(mesh)
di, mi = mesh.get_coordinate()
root = {root!r}
out = {{"rank": rank, "steps": {{}}, "apply": {{}}}}
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, 128, (8, 16)).astype(np.int32))
for arch in {archs!r}:
    base = reduced(CONFIGS[arch])
    grads, losses = {{}}, {{}}
    for name, kw in [("gspmd", dict(moe_impl="gspmd")),
                     ("smap", dict(moe_impl="shard_map")),
                     ("smap_sp", dict(moe_impl="shard_map",
                                      seq_shard_resid=True))]:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=float(base.moe.n_experts)), **kw)
        set_exec_mesh(mesh)
        model, opt = Model(cfg), make_optimizer(cfg)
        sh = state_shardings(abstract_train_state(model, opt), mesh, opt)
        state = distribute_tree(init_train_state(model, opt, seed=0,
                                                 device="cpu"), sh)
        bsh = batch_spec({{"tokens": toks}}, mesh, cfg)["tokens"]
        rng = bsh.local_range(tuple(toks.shape))
        batch = {{"tokens": toks[rng.start[0]:rng.stop[0]]}}
        step = make_train_step(model, opt, shardings=sh,
                               batch_axes=bsh.dim_axes(2)[0])
        loss, metrics, g = step.grads(state, batch)
        set_exec_mesh(None)
        losses[name] = float(loss)
        grads[name] = dict(leaf_paths(g))
    out["steps"][arch] = {{
        name: {{"loss_diff": abs(losses[name] - losses["gspmd"]),
                "grad_diff": max(float((grads[name][n] - g0).abs().max())
                                 for n, g0 in grads["gspmd"].items())}}
        for name in ("smap", "smap_sp")}}
    for name, (B, S), cf in {apply!r}:
        d = np.load(os.path.join(root, f"{{arch}}-{{name}}.npz"))
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=float(base.moe.n_experts)
            if cf == "E" else base.moe.capacity_factor))
        El = base.moe.n_experts // ax.tp
        p = {{k: torch.from_numpy(d[k]) for k in ("router", "wg", "wu",
                                                  "wd")}}
        for k in ("wg", "wu", "wd"):
            p[k] = p[k][mi * El:(mi + 1) * El]
        x = torch.from_numpy(d["x"])[di * B // 2:(di + 1) * B // 2]
        y, aux = moe_apply_shard_map(p, x, cfg, mesh, ax)
        if mi == 0:
            np.save(os.path.join(root, f"{{arch}}-{{name}}-port-y{{di}}.npy"),
                    y.numpy())
        out["apply"][f"{{arch}}-{{name}}"] = {{k: float(v)
                                               for k, v in aux.items()}}
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _inputs(root):
    """Numpy params and tokens of every (arch, case): tokens share a mean
    component, so that routing leans to a few experts and the config's
    capacity drops tokens."""
    for i, arch in enumerate(ARCHS):
        cfg = reduced(CONFIGS[arch])
        m, D = cfg.moe, cfg.d_model
        F_ = m.d_expert
        for j, (name, (B, S), _) in enumerate(APPLY):
            rng = np.random.default_rng(10 * i + j)

            def w(*shape, s):
                return (rng.standard_normal(shape) * s).astype(np.float32)
            np.savez(root / f"{arch}-{name}.npz",
                     router=w(D, m.n_experts, s=0.5),
                     wg=w(m.n_experts, D, F_, s=D ** -0.5),
                     wu=w(m.n_experts, D, F_, s=D ** -0.5),
                     wd=w(m.n_experts, F_, D, s=F_ ** -0.5),
                     x=w(B, S, D, s=1.0) + 1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_smap")
    _inputs(root)
    fmt = dict(src=SRC, root=str(root), archs=ARCHS, apply=APPLY)
    (root / "jax").mkdir()
    (root / "ranks").mkdir()
    jax_proc = _spawn(JAX.format(**fmt), 1, root / "jax")
    ranks = _spawn(RANKS.format(store=str(root / "store"), **fmt), 8,
                   root / "ranks")
    ranks = _collect(ranks, 600)
    jax_out, = _collect(jax_proc, 600)
    return root, ranks, jax_out


@pytest.mark.parametrize("variant", ["smap", "smap_sp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_map_step_matches_gspmd(runs, arch, variant):
    _, ranks, _ = runs
    for r in ranks:
        d = r["steps"][arch][variant]
        assert d["loss_diff"] < 1e-5, (r["rank"], d)
        assert d["grad_diff"] < 5e-5, (r["rank"], d)


@pytest.mark.parametrize("case", [n for n, _, _ in APPLY])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_shard_map_matches_jax(runs, arch, case):
    root, ranks, jax_out = runs
    key = f"{arch}-{case}"
    ref = jax_out[key]
    y_ref = np.load(root / f"{key}-jax-y.npy")
    y = np.concatenate([np.load(root / f"{key}-port-y{d}.npy")
                        for d in range(2)])
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5)
    for r in ranks:
        got = r["apply"][key]
        assert got["drop_fraction"] == ref["drop_fraction"], (got, ref)
        for k in ("load_balance_loss", "router_z_loss"):
            assert abs(got[k] - ref[k]) <= 1e-5 * max(1.0, abs(ref[k])), \
                (k, got[k], ref[k])
    # the config's capacity drops tokens in the second case, none first
    assert (ref["drop_fraction"] > 0) == (case == "drops"), ref
