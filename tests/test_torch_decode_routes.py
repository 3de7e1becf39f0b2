"""The port's device codec routes against its host routes, on the CPU (the
kernel wrappers take their plain versions here, so the route's plumbing is
what is held): the snapshot's int8 route (K5 quantizes a leaf before the
device→host copy) writes the manifests and CAS objects of the host
oracle, byte for byte, and pins what ``estimate_snapshot_bytes`` says; the
restore's device decode (K4 over a byteplane leaf's transformed stream, K6
over an int8 leaf's q and scales) restores the host decode's leaves bit
for bit, in full and incremental mode, blocking and streaming, for leaves
saved as several shards, into leaves of another dtype than the record's,
and from a JAX checkpoint written on a four-device mesh; and the read
cache never hands a staged entry to a decoded read or back."""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import pytest
import torch

from repro_torch.configs import gemma3_1b
from repro_torch.core import codec as codec_mod
from repro_torch.core import save_path
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.policy import (CheckpointPolicy, ChunkingPolicy,
                                     CodecPolicy, DurabilityPolicy,
                                     PipelinePolicy)
from repro_torch.core.split_state import leaf_paths
from repro_torch.core.storage import Tier, TieredStore
from repro_torch.kernels.ckpt_codec import byteplane as bp
from repro_torch.kernels.ckpt_codec import int8_codec as ic
from repro_torch.state import train_state

NARROW = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
              head_dim=32, d_ff=256, vocab_size=2048)

# (mode, chunking, codec, params_codec): int8 on the bf16 params, and on
# the f32 moments too; the byteplane codecs under CDC and in full mode
ROUTES = {
    "incr-int8": ("incremental", "cdc", "raw", "int8"),
    "incr-int8-all": ("incremental", "fixed", "int8", "int8"),
    "full-int8": ("full", "fixed", "raw", "int8"),
    "incr-byteplane-rle": ("incremental", "cdc", "raw", "byteplane-rle"),
    "incr-byteplane": ("incremental", "cdc", "raw", "byteplane"),
    "full-byteplane-rle": ("full", "fixed", "raw", "byteplane-rle"),
}


def _manager(path, route, **codec):
    """A CPU manager for a ROUTES key or a (mode, chunking, codec,
    params_codec) tuple."""
    mode, scheme, c, pc = ROUTES.get(route, route)
    return CheckpointManager(TieredStore(Tier("fast", path)), CheckpointPolicy(
        mode=mode,
        chunking=ChunkingPolicy(scheme=scheme, chunk_size=16 << 10,
                                scan_backend="pallas"),
        pipeline=PipelinePolicy(io_threads=4),
        durability=DurabilityPolicy(keepalive_s=60.0),
        codec=CodecPolicy(codec=c, params_codec=pc, **codec)), device="cpu")


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def _assert_same(a, b):
    pa, pb = leaf_paths(a), leaf_paths(b)
    assert [n for n, _ in pa] == [n for n, _ in pb]
    for (name, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


@pytest.fixture(scope="module")
def state():
    """Reduced gemma3-1b state: bf16 params, f32 moments of a trained
    run's magnitude."""
    return train_state(dataclasses.replace(gemma3_1b.CONFIG, **NARROW),
                       "cpu", seed=2)


class _Spy:
    """Counts calls of a module function (the plain versions the wrappers
    take on the CPU) while passing them through."""

    def __init__(self, monkeypatch, mod, name):
        self.n = 0
        inner = getattr(mod, name)

        def f(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(mod, name, f)


def _int8_leaves(route, st):
    """Every int8-coded leaf: K5 takes bf16/f32 as they are and the int32
    and uint32 leaves through a cast to f32 on the device."""
    c, pc = ROUTES[route][2:]
    return [n for n, t in leaf_paths(st)
            if (pc if n.startswith("params/") else c) == "int8"]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_device_routes_match_host_routes(tmp_path, state, route,
                                         monkeypatch):
    q = _Spy(monkeypatch, ic, "quantize_plain")
    dev = _manager(tmp_path / "dev", route)
    host = _manager(tmp_path / "host", route, device_precondition=False)
    assert dev._restore.device_decode and not host._restore.device_decode
    dev.save(state, 1)
    n_int8 = len(_int8_leaves(route, state))
    assert q.n == n_int8
    host.save(state, 1)
    assert q.n == n_int8                   # the host route quantizes in numpy
    assert dev.load_manifest(1)["leaves"] == host.load_manifest(1)["leaves"]
    if ROUTES[route][0] == "incremental":
        assert dev.chunks.digests_on_disk() == host.chunks.digests_on_disk()
    inv = _Spy(monkeypatch, bp, "inverse_plain")
    deq = _Spy(monkeypatch, ic, "dequantize_plain")
    ref, _ = host.restore(state)
    assert inv.n == deq.n == 0
    got, _ = dev.restore(state)
    n_params = len(leaf_paths(state["params"]))
    if "int8" in route:
        assert deq.n == n_int8 and inv.n == 0
    else:
        assert inv.n == n_params and deq.n == 0
    _assert_same(got, ref)
    if "int8" not in route:
        _assert_same(got, state)           # the byteplane codecs are lossless
    stream, _ = dev.restore_streaming(state, step=1)
    _assert_same(stream.wait_frontier().state(), ref)
    dev.close()
    host.close()


def test_read_cache_keeps_staged_and_decoded_apart(tmp_path, state):
    mgr = _manager(tmp_path / "m", "incr-byteplane-rle")
    mgr.save(state, 1)
    staged, _ = mgr.restore(state)
    mgr._restore.device_decode = False     # same session, same cache
    decoded, _ = mgr.restore(state)
    mgr._restore.device_decode = True
    again, _ = mgr.restore(state)
    _assert_same(staged, state)
    _assert_same(decoded, state)
    _assert_same(again, state)
    mgr.close()


@pytest.mark.parametrize("route", ["incr-int8", "incr-int8-all",
                                   "incr-byteplane-rle"])
def test_snapshot_estimate_is_what_the_snapshot_pins(state, route):
    """One rule for both: q and the scales of a leaf quantized on the
    device (half a bf16 leaf, a quarter of an f32 leaf, plus 4 bytes per
    block), the raw bytes of every other leaf."""
    int8 = set(_int8_leaves(route, state))
    quantize = (lambda name: name in int8) if int8 else None
    items = save_path.snapshot_items(state, _Serial(), quantize=quantize)
    pinned = sum(a.nbytes for _, _, a in items)
    assert save_path.estimate_snapshot_bytes(state, quantize) == pinned
    for name, _, a in items:
        assert isinstance(a, codec_mod.Quantized) == (name in int8), name
    raw = sum(t.nbytes for _, t in leaf_paths(state))
    if int8:
        assert pinned < raw
    else:
        assert pinned == raw


class _Serial:
    """The serial engine's inline map."""

    @staticmethod
    def map_ordered(fn, items):
        return [fn(x) for x in items]


def test_quantized_snapshot_encodes_as_the_host_array(state):
    """``codec.encode`` of a device-quantized leaf is the payload and meta
    of encoding the host array, on bf16 and f32 leaves of ragged sizes."""
    for t in (state["params"]["embed"], state["opt"]["m"]["embed"],
              state["params"]["final_norm"]["scale"],
              torch.randn(1000, dtype=torch.float32)):
        quant = save_path.to_host_quantized(t)
        assert quant.nbytes == codec_mod.quantized_nbytes(t.numel())
        assert codec_mod.encode(quant, "int8") == \
            codec_mod.encode(save_path.to_host(t), "int8")


def _split_shards(state):
    """``save_path.iter_snapshot_shards`` for a topology that saves every
    leaf of two or more rows as two shards, split at an uneven row."""
    for name, leaf in leaf_paths(state):
        shape = tuple(leaf.shape)
        if len(shape) < 1 or shape[0] < 2:
            yield name, save_path.ShardRange((0,) * len(shape), shape), leaf
            continue
        cut = shape[0] // 3 + 1
        for a, b in ((0, cut), (cut, shape[0])):
            yield (name, save_path.ShardRange((a,) + (0,) * (len(shape) - 1),
                                              (b,) + shape[1:]), leaf[a:b])


@pytest.mark.parametrize("route", ["incr-int8-all", "full-int8",
                                   "incr-byteplane-rle", "full-byteplane-rle"])
def test_device_decode_places_each_saved_shard(tmp_path, state, route,
                                               monkeypatch):
    """A leaf saved as several shards decodes shard by shard on the device
    into its slices: one K4/K6 call per staged shard, the host route's
    bytes."""
    monkeypatch.setattr(save_path, "iter_snapshot_shards", _split_shards)
    dev = _manager(tmp_path / "dev", route)
    host = _manager(tmp_path / "host", route, device_precondition=False)
    dev.save(state, 1)
    host.save(state, 1)
    leaves = dev.load_manifest(1)["leaves"]
    assert leaves == host.load_manifest(1)["leaves"]
    assert len(leaves["params/embed"]["shards"]) == 2
    staged = sum(len(r["shards"]) for r in leaves.values()
                 if r["shards"][0]["codec"] in codec_mod.STAGED)
    ref, _ = host.restore(state)
    inv = _Spy(monkeypatch, bp, "inverse_plain")
    deq = _Spy(monkeypatch, ic, "dequantize_plain")
    got, _ = dev.restore(state)
    assert inv.n + deq.n == staged
    _assert_same(got, ref)
    if "int8" not in route:
        _assert_same(got, state)
    dev.close()
    host.close()


def test_device_decode_casts_to_the_leaf_dtype(tmp_path, state):
    """Records restored into leaves of another dtype (f32 moments into f64
    and f16 leaves, past the registry check) are cast on the device as the
    host assemble casts."""
    def drift(node, name=""):
        if isinstance(node, dict):
            return {k: drift(v, f"{name}{k}.") for k, v in node.items()}
        if name.startswith("opt.m."):
            return node.double()
        return node.half() if name.startswith("opt.v.") else node

    drifted = drift(state)
    for codec in ("int8", "byteplane-rle"):
        route = ("incremental", "cdc", codec, codec)
        dev = _manager(tmp_path / f"dev-{codec}", route)
        host = _manager(tmp_path / f"host-{codec}", route,
                        device_precondition=False)
        dev.save(state, 1)
        host.save(state, 1)
        assert dev._restore.device_decode and not host._restore.device_decode
        got, _ = dev.restore(drifted, validate=False)
        ref, _ = host.restore(drifted, validate=False)
        _assert_same(got, ref)
        assert got["opt"]["v"]["embed"].dtype == torch.float16
        dev.close()
        host.close()


JAX_MESH_SAVE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.core import policy as pol
    from repro.core.checkpoint import CheckpointManager
    from repro.core.split_state import leaf_paths
    from repro.core.storage import Tier, TieredStore

    root = {root!r}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("a", "b"))
    rng = np.random.default_rng(7)

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    state = {{"params": {{
                  "w": put(jnp.asarray(rng.standard_normal((64, 96)),
                                       jnp.bfloat16), "a", "b"),
                  "b": put(rng.standard_normal((8, 100))
                           .astype(np.float32), "a", None)}},
              "opt": {{"m": put((rng.standard_normal((64, 96)) * 1e-3)
                               .astype(np.float32), "b", "a")}},
              "step": jnp.int32(3)}}
    ref = {{}}
    for codec in ("byteplane-rle", "int8"):
        mgr = CheckpointManager(
            TieredStore(Tier("fast", os.path.join(root, codec))),
            policy=pol.CheckpointPolicy(
                mode="incremental",
                chunking=pol.ChunkingPolicy(scheme="cdc", chunk_size=4096),
                pipeline=pol.PipelinePolicy(io_threads=4),
                durability=pol.DurabilityPolicy(keepalive_s=60.0),
                codec=pol.CodecPolicy(codec=codec, params_codec=codec)))
        mgr.save(state, 1)
        got, _ = mgr.restore(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state))
        for name, leaf in leaf_paths(got):
            a = np.asarray(leaf)
            ref[codec + "|" + name.replace("/", "|")] = \\
                a.view("u%d" % a.dtype.itemsize)
    np.savez(os.path.join(root, "ref.npz"), **ref)
""")


@pytest.mark.parametrize("codec", ["byteplane-rle", "int8"])
def test_device_decode_restores_a_jax_mesh_checkpoint(tmp_path, codec,
                                                      monkeypatch):
    """A JAX checkpoint saved from a 2 × 2 mesh (a leaf of four shards, one
    of two, a ragged int8 shard) restores through the device decode, one
    K4/K6 call per shard, to the JAX package's own restore bit for bit;
    the host route gives the same bits."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_MESH_SAVE.format(src=src,
                                                    root=str(tmp_path))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    template = {"params": {"w": torch.zeros(64, 96, dtype=torch.bfloat16),
                           "b": torch.zeros(8, 100)},
                "opt": {"m": torch.zeros(64, 96)},
                "step": torch.zeros((), dtype=torch.int32)}
    route = ("incremental", "cdc", codec, codec)
    dev = _manager(tmp_path / codec, route)
    host = _manager(tmp_path / codec, route, device_precondition=False)
    leaves = dev.load_manifest(1)["leaves"]
    assert [len(leaves[n]["shards"]) for n in
            ("params/w", "params/b", "opt/m", "step")] == [4, 2, 4, 1]
    inv = _Spy(monkeypatch, bp, "inverse_plain")
    deq = _Spy(monkeypatch, ic, "dequantize_plain")
    got, _ = dev.restore(template)
    assert (deq.n if codec == "int8" else inv.n) == 11   # every shard
    assert inv.n + deq.n == 11
    back, _ = host.restore(template)
    _assert_same(got, back)
    for name, t in leaf_paths(got):
        bits = _bits(t).numpy()
        want = ref[codec + "|" + name.replace("/", "|")]
        np.testing.assert_array_equal(bits.view(want.dtype), want, name)
    dev.close()
    host.close()
