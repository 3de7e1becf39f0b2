"""The sharding slice's layout, no processes: the port's partition rules
(``repro_torch.sharding.partition``) against the JAX package's
(``repro.sharding.partition``) for every leaf of the ten full configs
(abstract shapes only) on the meshes (2,4), (4,2), (8,1), (16,16) and
(2,16,16): parameter specs through a ``MeshAxes`` built by hand, the
``DTensor`` placements they give, ``batch_axes_for`` with and without
``dp_over_model``, ``cache_specs``, and ``state_shardings`` under AdamW and
Adafactor. The JAX functions that build a ``NamedSharding`` run on a mesh
that is only a shape (``jax.sharding.NamedSharding`` replaced by a record
of (mesh, spec) for the test). Last, the port's index ranges and their
order on a (2,4) mesh against the JAX package's ``addressable_shards`` in a
subprocess with eight host devices."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.sharding
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

import repro.core.split_state as jsplit
import repro.sharding.partition as jpart
from repro.configs import CONFIGS as JCONFIGS
from repro.models.model import Model as JModel
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import ARCH_IDS, CONFIGS
from repro_torch.core.split_state import abstract_train_state, leaf_paths
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import Model
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import partition as tpart

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((8, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _hand_axes(shape, names):
    """MeshAxes by hand: batch over ("pod", "data") where a pod axis
    exists, FSDP over "data", TP/EP over "model"."""
    sizes = dict(zip(names, shape))
    batch = ("pod", "data") if "pod" in names else ("data",)
    return dict(batch=batch, fsdp="data", model="model",
                batch_size=int(np.prod([sizes[a] for a in batch])),
                fsdp_size=sizes["data"], tp=sizes["model"])


class _ShapeMesh:
    """A JAX mesh that is only its axis names and device-array shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


class _NS:
    """``NamedSharding`` as a record of (mesh, spec): a pytree leaf."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def shape_only_jax(monkeypatch):
    for mod in (jax.sharding, jpart, jsplit):
        monkeypatch.setattr(mod, "NamedSharding", _NS)


_JAX_ABSTRACT: dict = {}


def _jax_state(arch, opt):
    key = (arch, opt)
    if key not in _JAX_ABSTRACT:
        optimizer = JAdafactor() if opt == "adafactor" else JAdamW()
        _JAX_ABSTRACT[key] = jsplit.abstract_train_state(
            JModel(JCONFIGS[arch]), optimizer)
    return _JAX_ABSTRACT[key]


def _jnames(tree):
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _spec(s):
    return tuple(s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_placements_match_jax(arch):
    jparams = _jax_state(arch, "adamw")["params"]
    tparams = Model(CONFIGS[arch]).abstract_params()
    tleaves = leaf_paths(tparams)
    jleaves = _jnames(jparams)
    assert [n for n, _ in tleaves] == [n for n, _ in jleaves]
    for shape, names in MESHES:
        hand = _hand_axes(shape, names)
        jax_ax, port_ax = jpart.MeshAxes(**hand), tpart.MeshAxes(**hand)
        assert tpart.mesh_axes(AbstractMesh(shape, names)) == port_ax
        mesh = AbstractMesh(shape, names)
        for (name, t), (_, j) in zip(tleaves, jleaves):
            assert tuple(t.shape) == tuple(j.shape), name
            path = tuple(jax.tree_util.DictKey(k) for k in name.split("/"))
            want = _spec(jpart.spec_for_param(path, j.shape, jax_ax))
            got = tpart.spec_for_param(name, tuple(t.shape), port_ax)
            assert got == want, (name, shape)
            pl = tpart.NamedSharding(mesh, got).placements
            for i, axis in enumerate(names):
                dims = [d for d, e in enumerate(got)
                        if axis in tpart.entry_axes(e)]
                assert pl[i] == (Shard(dims[0]) if dims else Replicate()), \
                    (name, axis)
        # the MoE expert and attention weights do shard on a real mesh
        if shape == (16, 16):
            assert any(e is not None for n, t in tleaves
                       for e in tpart.spec_for_param(n, tuple(t.shape),
                                                     port_ax))


@pytest.mark.parametrize("dp_over_model", [False, True])
def test_batch_axes_and_batch_spec_match_jax(dp_over_model,
                                             shape_only_jax):
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(CONFIGS[arch], dp_over_model=dp_over_model)
        jcfg = dataclasses.replace(JCONFIGS[arch],
                                   dp_over_model=dp_over_model)
        for shape, names in MESHES:
            hand = _hand_axes(shape, names)
            for b in (1, 2, 4, 8, 16, 32, 64, 256, 512, 1024):
                assert tpart.batch_axes_for(cfg, tpart.MeshAxes(**hand), b) \
                    == jpart.batch_axes_for(jcfg, jpart.MeshAxes(**hand), b)
                batch = {"tokens": np.empty((b, 16), np.int32)}
                want = jpart.batch_spec(batch, _ShapeMesh(shape, names),
                                        jcfg)["tokens"].spec
                got = tpart.batch_spec(batch, AbstractMesh(shape, names),
                                       cfg)["tokens"].spec
                assert got == _spec(want), (arch, shape, b)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if CONFIGS[a].family != "encoder"])
def test_cache_specs_match_jax(arch, shape_only_jax):
    jm, tm = JModel(JCONFIGS[arch]), Model(CONFIGS[arch])
    for batch, cache_len in ((1, 8192), (32, 1024)):
        jcache = jax.eval_shape(lambda: jm.init_cache(batch, cache_len))
        tcache = tm.init_cache(batch, cache_len, device="meta")
        assert [n for n, _ in _jnames(jcache)] == \
            [n for n, _ in leaf_paths(tcache)]
        for shape, names in MESHES:
            want = [(n, _spec(s.spec)) for n, s in _jleaves_ns(
                jpart.cache_specs(jcache, _ShapeMesh(shape, names),
                                  JCONFIGS[arch]))]
            got = [(n, s.spec) for n, s in leaf_paths(tpart.cache_specs(
                tcache, AbstractMesh(shape, names), CONFIGS[arch]))]
            assert got == want, (arch, batch, shape)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_match_jax(arch, opt, shape_only_jax):
    jstate = _jax_state(arch, opt)
    joptim = JAdafactor() if opt == "adafactor" else JAdamW()
    toptim = Adafactor() if opt == "adafactor" else AdamW()
    tstate = abstract_train_state(Model(CONFIGS[arch]), toptim)
    for shape, names in MESHES:
        jsh = jsplit.state_shardings(jstate, _ShapeMesh(shape, names),
                                     joptim)
        tsh = jsplit_port_state_shardings(tstate, shape, names, toptim)
        want = [(n, _spec(s.spec)) for n, s in _jleaves_ns(jsh)]
        got = [(n, s.spec) for n, s in leaf_paths(tsh)]
        assert got == want, (arch, opt, shape)


def jsplit_port_state_shardings(state, shape, names, optimizer):
    from repro_torch.core.split_state import state_shardings
    return state_shardings(state, AbstractMesh(shape, names), optimizer)


def _jleaves_ns(tree, prefix=""):
    """(name, NamedSharding record) in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, _NS):
            out.append((name, v))
        else:
            out.extend(_jleaves_ns(v, name))
    return out


RANGES = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import CONFIGS, reduced
from repro.core.save_path import iter_snapshot_shards
from repro.core.split_state import (abstract_train_state, init_train_state,
                                    leaf_paths, state_shardings)
from repro.launch.mesh import make_host_mesh
from repro.models.model import Model
from repro.optim import make_optimizer
from repro.sharding.partition import param_specs

mesh = make_host_mesh((2, 4), ("data", "model"))
assert [d.id for d in mesh.devices.flat] == list(range(8))
out = {{"full": {{}}, "reduced": {{}}}}
for arch in sorted(CONFIGS):
    cfg = CONFIGS[arch]
    model = Model(cfg)
    st = abstract_train_state(model, make_optimizer(cfg))
    sh = param_specs(st["params"], mesh)
    rows = []
    for (name, leaf), (_, s) in zip(leaf_paths(st["params"]),
                                    leaf_paths(sh)):
        idx = s.addressable_devices_indices_map(leaf.shape)
        assert [d.id for d in idx] == list(range(8))
        rows.append([name, [[[sl.start or 0,
                              leaf.shape[i] if sl.stop is None else sl.stop]
                             for i, sl in enumerate(index)]
                            for index in idx.values()]])
    out["full"][arch] = rows
for arch in ("gemma3-1b", "kimi-k2-1t-a32b"):
    cfg = reduced(CONFIGS[arch])
    model = Model(cfg)
    opt = make_optimizer(cfg)
    st = init_train_state(model, opt, jax.random.PRNGKey(0))
    st = jax.device_put(st, state_shardings(st, mesh, opt))
    shards = []
    for name, leaf in leaf_paths(st["params"]):
        shards.append([name, [[[sl.start or 0,
                                leaf.shape[i] if sl.stop is None
                                else sl.stop]
                               for i, sl in enumerate(s.index)]
                              for s in leaf.addressable_shards]])
    items = [[n, list(r.start), list(r.stop)]
             for n, r, _ in iter_snapshot_shards(st)]
    out["reduced"][arch] = {{"shards": shards, "items": items}}
print("RESULT::" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ranges():
    proc = subprocess.run(
        [sys.executable, "-c", RANGES.format(src=SRC)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines()
                if l.startswith("RESULT::"))
    return json.loads(line[len("RESULT::"):])


def _ranges(rngs):
    return [[[a, b] for a, b in zip(r.start, r.stop)] for r in rngs]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_ranges_match_jax_devices_on_2x4(arch, jax_ranges):
    """Every device's index range of every parameter, in device (= rank)
    order, for the full configs."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    specs = tpart.param_specs(Model(CONFIGS[arch]).abstract_params(), mesh)
    params = dict(leaf_paths(Model(CONFIGS[arch]).abstract_params()))
    got = [[name, _ranges(sh.device_ranges(tuple(params[name].shape)))]
           for name, sh in leaf_paths(specs)]
    assert got == jax_ranges["full"][arch]


@pytest.mark.parametrize("arch", ["gemma3-1b", "kimi-k2-1t-a32b"])
def test_shard_order_matches_jax_addressable_shards(arch, jax_ranges):
    """On arrays placed on the (2,4) mesh: ``addressable_shards`` order,
    and the save path's item list (unique ranges, lowest device first)."""
    from repro_torch.configs import reduced
    from repro_torch.optim import make_optimizer
    from repro_torch.core.split_state import state_shardings
    cfg = reduced(CONFIGS[arch])
    mesh = AbstractMesh((2, 4), ("data", "model"))
    model = Model(cfg)
    st = abstract_train_state(model, make_optimizer(cfg))
    sh = state_shardings(st, mesh, make_optimizer(cfg))
    shapes = dict(leaf_paths(st))
    got = [[n, _ranges(s.device_ranges(tuple(shapes["params/" + n].shape)))]
           for n, s in leaf_paths(sh["params"])]
    assert got == jax_ranges["reduced"][arch]["shards"]
    items = [[n, list(r.start), list(r.stop)]
             for n, s in leaf_paths(sh)
             for r, _ in s.unique_ranges(tuple(shapes[n].shape))]
    assert items == jax_ranges["reduced"][arch]["items"]
