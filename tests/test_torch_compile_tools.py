"""The compile-side tools of the port against the JAX package's:
``configs.shapes`` (the cell matrix), ``launch.hlo_analysis`` over a
dispatch trace (FLOPs, wire bytes, the census), the registered K7/K8
operators and their FLOP formulas, ``launch.dryrun`` over a fake process
group, the card's hardware model and fake meshes (``launch.mesh``), the
kernel build's digests and ``core.aot_cache`` over ``torch.export``.

Everything that joins a fake process group runs in a subprocess, so that
no group leaks into another test; so does ``repro.launch.dryrun``, which
sets ``XLA_FLAGS`` when it is imported. FLOPs and bytes are integers
here: they are held to equality."""
import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (CONFIGS, SHAPES, applicable, cells,
                                 get_config, reduced)
from repro_torch.kernels import build, register_ops
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import Model

SRC = str(Path(__file__).resolve().parents[1] / "src")
ATOL = 1e-4            # tests/test_torch_serve.py: f32 logits


def _run(code: str, timeout: int = 600) -> dict:
    """`code` in a fresh interpreter; its last stdout line is JSON."""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _run_together(*codes, timeout: int = 600) -> list:
    """``_run`` of each of `codes`, in processes running at once."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", c], text=True, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in codes]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


# ---------------------------------------------------------------------------
# configs.shapes (tests/test_configs.py::test_cell_matrix,
# test_applicability_reasons)
# ---------------------------------------------------------------------------

def test_shapes_equal_reference():
    from repro.configs import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_cell_matrix_equals_reference():
    from repro.configs import CONFIGS as JCONFIGS
    from repro.configs import cells as jcells
    got = cells(CONFIGS)
    assert got == jcells(JCONFIGS)
    assert len(got) == 32


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_applicability_reasons_equal_reference(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import applicable as japplicable
    from repro.configs import get_config as jget_config
    for name, shape in SHAPES.items():
        assert applicable(get_config(arch), shape) == \
            japplicable(jget_config(arch), JSHAPES[name])


# ---------------------------------------------------------------------------
# the trace analysis
# ---------------------------------------------------------------------------

def _matmuls(x, w):
    for _ in range(7):
        x = x @ w
    return x


@pytest.mark.parametrize("fake", [False, True])
def test_analyze_counts_every_matmul_of_a_loop(fake):
    """tests/test_sharding_optim.py:82: the reference's analyze gives
    7·2·32³ for its lax.scan of seven matmuls; a Python loop's trace
    dispatches all seven."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        x, w = torch.ones(32, 32), torch.ones(32, 32)
        _, tr = H.record(_matmuls, x, w)
    a = H.analyze(tr)
    assert a["flops"] == 7 * 2 * 32 ** 3
    assert a["flops_by_op"] == {"aten.mm": 7 * 2 * 32 ** 3}
    # each mm reads two 4 KiB operands and writes one
    assert a["hbm_bytes"] == 7 * 3 * 32 * 32 * 4
    assert H.op_census(tr)["dot"] == 7
    # x, w, and two products live at once
    assert tr.argument_bytes == 2 * 4096 and tr.peak_bytes == 4 * 4096
    assert tr.output_bytes == 4096 and tr.alias_bytes == 0


def test_views_count_no_bytes():
    x = torch.ones(8, 16)
    _, tr = H.record(lambda t: t.view(16, 8).t().transpose(0, 1)[2:4], x)
    assert H.analyze(tr)["hbm_bytes"] == 0
    assert H.op_census(tr)["transpose"] == 2


def test_marks_split_the_peak():
    tr = H.Trace()

    def fn(x):
        y = x * 2
        z = y + 1                      # x, y, z live: 3 tensors
        del y, z
        tr.mark("first")
        return x * 3                   # x and the product: 2 tensors

    _, tr = H.record(fn, torch.ones(256), trace=tr)
    tr.mark("second")
    assert tr.parts == {"first": 3 * 1024, "second": 2 * 1024}


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma3-1b in both packages, the JAX weights carried
    across."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro_torch.convert import params_from_jax
    jm = JModel(jreduced(jget_config("gemma3-1b")))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(reduced(get_config("gemma3-1b")))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(3).integers(0, 128, (2, 20),
                                               dtype=np.int32)
    return jm, jparams, tm, tparams, tokens


def test_dot_flops_outside_attention_equal_reference(gemma):
    """The port's matmul FLOPs of a prefill equal the reference's
    ``analyze`` of its compiled prefill less its attention functions'
    (``attention_full``/``attention_local``, compiled alone at each
    layer's shapes): the port's attention is one K8 operator."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze as janalyze
    from repro.models import layers as jl
    jm, jparams, tm, tparams, tokens = gemma
    cfg = tm.cfg
    fn = jax.jit(lambda p, t: jm.prefill(p, t, cache_len=24))
    total = janalyze(fn.lower(jparams, jnp.asarray(tokens)).compile()
                     .as_text())["flops"]
    B, S = tokens.shape
    q = jnp.zeros((B, S, cfg.n_heads, cfg.head_dim), jnp.float32)
    kv = jnp.zeros((B, S, cfg.n_kv_heads, cfg.head_dim), jnp.float32)
    common = dict(softcap=cfg.attn_softcap, scale=cfg.attn_scale or None,
                  chunk=cfg.attn_chunk)
    per = {
        "attn_local": janalyze(jax.jit(lambda a, b, c: jl.attention_local(
            a, b, c, window=cfg.window, causal=cfg.causal, **common)).lower(
            q, kv, kv).compile().as_text())["flops"],
        "attn_global": janalyze(jax.jit(lambda a, b, c: jl.attention_full(
            a, b, c, causal=cfg.causal, chunk_q=0, **common)).lower(
            q, kv, kv).compile().as_text())["flops"]}
    attn = sum(per[k] for k in cfg.layer_kinds)
    with torch.no_grad():
        _, tr = H.record(lambda p, t: tm.prefill(p, t, cache_len=24),
                         tparams, torch.from_numpy(tokens))
    by_op = H.analyze(tr)["flops_by_op"]
    dots = sum(v for k, v in by_op.items() if k in
               ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"))
    assert dots == total - attn
    # K8's formula: 4·D·B·H per unmasked pair, summed over the layers
    pairs = sum(fa.unmasked_pairs(S, S, cfg.causal,
                                  cfg.window if k == "attn_local" else 0)
                for k in cfg.layer_kinds)
    assert by_op["repro_torch.flash_attention"] == \
        4 * cfg.head_dim * B * cfg.n_heads * pairs
    # K7's: 4·N·D per norm (block norms, q/k norms, the final norm)
    assert by_op["repro_torch.rmsnorm"] % (4 * cfg.head_dim) == 0
    census = H.op_census(tr)
    assert census["flash_attention"] == len(cfg.layer_kinds)
    assert census["rmsnorm"] == 4 * len(cfg.layer_kinds) + 1 + \
        2 * len(cfg.layer_kinds) * (1 if cfg.qk_norm else 0)


def test_registered_ops_are_the_plain_versions_on_the_cpu():
    rms, attn = register_ops()
    g = torch.Generator().manual_seed(0)
    x, s = torch.randn(3, 5, 64, generator=g), torch.randn(64, generator=g)
    assert torch.equal(rms(x, s, 1e-6), rn.rmsnorm_plain(x, s))
    q = torch.randn(2, 24, 4, 32, generator=g)
    k = torch.randn(2, 40, 2, 32, generator=g)
    v = torch.randn(2, 40, 2, 32, generator=g)
    for args in ((True, 0, 0.0, None, 16), (False, 8, 30.0, 0.5, 0)):
        kw = dict(zip(("causal", "window", "softcap", "scale", "q_offset"),
                      args))
        assert torch.equal(attn(q, k, v, *args),
                           fa.flash_attention_plain(q, k, v, **kw))


def test_registered_ops_trace_and_count_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    register_ops()
    with FakeTensorMode():
        x = torch.empty(6, 1152, dtype=torch.bfloat16)
        q = torch.empty(2, 64, 8, 80, dtype=torch.bfloat16)
        k = torch.empty(2, 256, 2, 80, dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            y = rn.rmsnorm(x, torch.empty(1152))
            o = fa.attention(q, k, k, causal=True, window=100, q_offset=192)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert o.shape == q.shape and o.is_contiguous()
    assert fc.get_total_flops() == 4 * 6 * 1152 + \
        4 * 80 * 2 * 8 * fa.unmasked_pairs(64, 256, True, 100, 192)


def test_untraced_is_false_wherever_the_norm_is_traced():
    """K7's entry skips the dispatcher only on a plain CUDA tensor that no
    mode sees: fake `cuda` tensors, a dispatch trace and an export all
    reach the registered operator."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    register_ops()
    assert not rn.untraced(torch.zeros(2, 8))
    with FakeTensorMode():
        x = torch.empty(6, 1152, dtype=torch.bfloat16, device="cuda")
        assert x.is_cuda and not rn.untraced(x)
        with FlopCounterMode(display=False) as fc:
            y = rn.rmsnorm(x, torch.empty(1152, device="cuda"))
        assert y.shape == x.shape and y.is_cuda
    assert fc.get_total_flops() == 4 * 6 * 1152
    seen = []

    def norm(a):
        seen.append(rn.untraced(a))
        return rn.rmsnorm(a, torch.ones(8))
    H.record(norm, torch.zeros(2, 8))
    torch.export.export(_Fn(norm), (torch.zeros(2, 8),))
    assert seen == [False, False]


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *a):
        return self.fn(*a)


@pytest.mark.parametrize("sq,sk,causal,window,off",
                         [(64, 64, True, 0, 0), (17, 300, True, 33, 200),
                          (40, 40, False, 7, 0), (9, 50, False, 0, 3)])
def test_k8_flop_formula_counts_the_mask(sq, sk, causal, window, off):
    mask = fa._mask(sq, sk, causal, window, "cpu", off)
    assert fa.flops((3, sq, 4, 48), (3, sk, 2, 48), None, causal, window,
                    0.0, None, off) == 4 * 48 * 3 * 4 * int(mask.sum())


# ---------------------------------------------------------------------------
# fake meshes, collectives' wire bytes, the dry run (subprocesses)
# ---------------------------------------------------------------------------

WIRE = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import make_production_mesh, make_fake_mesh
from repro_torch.launch import hlo_analysis as H
from repro_torch.sharding import collectives as C
big = make_production_mesh(multi_pod=True, fake_rank=300)
out = {"multi": [list(big.shape), list(big.get_coordinate()),
                 big.get_group("model").size()]}
mesh = make_fake_mesh((2, 2), ("data", "model"), rank=3)
out["coord"] = list(mesh.get_coordinate())
gd, gm = mesh.get_group("data"), mesh.get_group("model")

def fn(x):
    a = C.all_gather(x, gm, 0)                    # 2 × 4 KiB result
    b = C.reduce_scatter(a, gd, 0)                # f32 sum, 4 KiB result
    c = C.all_reduce(b, gm)                       # 4 KiB
    d = C.all_to_all(c, gd)                       # 4 KiB
    return d

with FakeTensorMode():
    _, tr = H.record(fn, torch.empty(32, 32))
out["analysis"] = H.analyze(tr, total_devices=4)
out["census"] = H.op_census(tr)
print(json.dumps(out))
"""


def test_fake_meshes_and_collective_wire_bytes():
    out = _run(WIRE)
    assert out["multi"] == [[2, 16, 16], [1, 2, 12], 16]
    assert out["coord"] == [1, 1]
    colls = out["analysis"]["collectives"]
    kb = 32 * 32 * 4
    assert colls == {
        "all-gather": {"count": 1, "result_bytes": 2 * kb,
                       "wire_bytes": 2 * kb / 2, "max_group": 2},
        "reduce-scatter": {"count": 1, "result_bytes": kb,
                           "wire_bytes": kb / 2, "max_group": 2},
        "all-reduce": {"count": 1, "result_bytes": kb,
                       "wire_bytes": 2 * kb / 2, "max_group": 2},
        "all-to-all": {"count": 1, "result_bytes": kb,
                       "wire_bytes": kb / 2, "max_group": 2}}
    assert out["analysis"]["wire_bytes"] == 3 * kb
    assert {k: out["census"][k] for k in ("all-gather", "reduce-scatter",
                                          "all-reduce", "all-to-all")} == \
        {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 1,
         "all-to-all": 1}


REFUSE = """
import json
from repro_torch.launch.mesh import init_distributed, make_production_mesh
init_distributed("cpu")
try:
    make_production_mesh(device="cpu")
    print(json.dumps({"refused": False}))
except ValueError as e:
    print(json.dumps({"refused": "needs 256 ranks" in str(e)}))
"""


def test_production_mesh_refuses_a_real_group_of_the_wrong_size():
    assert _run(REFUSE) == {"refused": True}


def test_hardware_model_is_the_cards():
    from repro_torch.launch.mesh import HW
    assert HW["peak_flops_bf16"] == 989.4e12
    assert HW["hbm_bw"] == 3.35e12 and HW["ici_bw"] == 450e9


DRYRUN = """
import json, os
import torch
from repro_torch.launch.dryrun import run_cell
os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
torch.use_deterministic_algorithms(True, warn_only=True)
cells = [("gemma3-1b", s, "single") for s in
         ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
cells += [("mamba2-780m", "decode_32k", "multi"),
          ("hubert-xlarge", "decode_32k", "single")]
recs = [run_cell(a, s, m) for a, s, m in cells]
for r in recs:
    r.pop("traceback", None)
after = {"workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
         "deterministic": torch.are_deterministic_algorithms_enabled(),
         "warn_only": torch.is_deterministic_algorithms_warn_only_enabled()}
print(json.dumps({"recs": recs, "after": after}))
"""


@pytest.fixture(scope="module")
def dryrun_run():
    return _run(DRYRUN)


@pytest.fixture(scope="module")
def dryrun(dryrun_run):
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in dryrun_run["recs"]}


def test_run_cell_leaves_the_process_as_it_was(dryrun_run):
    """The traces set no environment and leave the caller's deterministic
    setting alone (the train cell runs the step's ``deterministic``
    block)."""
    assert dryrun_run["after"] == {"workspace": None, "deterministic": True,
                                   "warn_only": True}


CELLS = [("gemma3-1b", "train_4k", "single"),
         ("gemma3-1b", "prefill_32k", "single"),
         ("gemma3-1b", "decode_32k", "single"),
         ("gemma3-1b", "long_500k", "single"),
         ("mamba2-780m", "decode_32k", "multi")]


@pytest.mark.parametrize("cell", CELLS)
def test_dryrun_cells_trace(dryrun, cell):
    r = dryrun[cell]
    assert r["status"] == "ok", r.get("error")
    assert r["n_chips"] == (512 if cell[2] == "multi" else 256)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["memory"]["peak_bytes_est"] >= r["memory"]["argument_bytes"]
    assert r["collectives"]["wire_bytes_per_device"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    if cell[1] != "decode_32k" or cell[0] != "mamba2-780m":
        assert r["op_census"]["rmsnorm"] > 0
    if cell[1] in ("train_4k", "prefill_32k"):
        assert r["op_census"]["flash_attention"] == 26 * \
            (2 if cell[1] == "train_4k" else 1)
    if cell[1] == "train_4k":
        assert set(r["memory"]["peak_by_part"]) == \
            {"forward_backward", "grad_norm", "update", "rest"}
        assert max(r["memory"]["peak_by_part"].values()) == \
            r["memory"]["peak_bytes_est"]


def test_dryrun_skips_with_the_reference_reason(dryrun):
    r = dryrun[("hubert-xlarge", "decode_32k", "single")]
    assert r["status"] == "skipped"
    assert r["reason"] == "encoder-only arch: no decode step"


# a small train cell on a (1, 1) mesh: gemma3-1b at full width, 12 layers
# (two remat units of six blocks), 16 × 512 tokens, so that the step's
# forward and backward (not the optimizer's update) set the peak
REMAT_CELL = dict(seq_len=512, global_batch=16, n_layers=12)
REMAT_POLICIES = ("nothing", "dots", "full")

TREMAT = """
import json
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import run_cell
shape = ShapeSpec("train_remat", {seq_len}, {global_batch}, "train")
recs = {{p: run_cell("gemma3-1b", "train_remat", "single", shape=shape,
                     mesh_shape=(1, 1),
                     overrides={{"remat_policy": p, "n_layers": {n_layers}}})
        for p in {policies!r}}}
print(json.dumps({{p: r["memory"]["peak_bytes_est"] if r["status"] == "ok"
                  else r["error"] for p, r in recs.items()}}))
"""

# the reference's run_cell at the same cell: its shape table and production
# mesh replaced in the subprocess by that shape and a (1, 1) mesh of one
# host device
JREMAT = """
import json
import jax
import numpy as np
import repro.launch.dryrun as d
from repro.configs.shapes import ShapeSpec
d.SHAPES = {{**d.SHAPES, "train_remat": ShapeSpec("train_remat", {seq_len},
                                                 {global_batch}, "train")}}
d.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
    np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
recs = {{p: d.run_cell("gemma3-1b", "train_remat", "single",
                       overrides={{"remat_policy": p,
                                  "n_layers": {n_layers}}})
        for p in {policies!r}}}
print(json.dumps({{p: r["memory"]["peak_bytes_est"] if r["status"] == "ok"
                  else r["error"] for p, r in recs.items()}}))
"""


def test_dryrun_peak_follows_remat_policy_in_the_reference_order():
    """``run_cell(..., overrides={"remat_policy": p})`` traces a different
    step for each policy: the predicted peak grows from ``nothing`` (the
    unit inputs) to ``dots`` (their dot outputs too) to ``full`` (every
    activation), as the reference's compiled peak does at the same cell."""
    got, ref = _run_together(
        TREMAT.format(policies=REMAT_POLICIES, **REMAT_CELL),
        JREMAT.format(policies=REMAT_POLICIES, **REMAT_CELL))
    assert all(isinstance(v, int) for v in got.values()), got
    assert all(isinstance(v, int) for v in ref.values()), ref
    assert got["nothing"] < got["dots"] < got["full"], got
    assert ref["nothing"] < ref["dots"] < ref["full"], ref


JSHARDS = """
import json, math
import jax
from repro.configs import get_config
from repro.core.split_state import abstract_train_state, state_shardings
from repro.launch.mesh import make_production_mesh
from repro.models import Model
from repro.optim import make_optimizer
from repro.sharding.partition import param_specs

def local_bytes(shardings, abstract):
    return sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for sh, x in zip(jax.tree.leaves(shardings),
                                jax.tree.leaves(abstract)))

cfg = get_config("gemma3-1b")
mesh = make_production_mesh()
m, opt = Model(cfg), make_optimizer(cfg)
st = abstract_train_state(m, opt)
p = jax.eval_shape(m.init, jax.random.PRNGKey(0))
print(json.dumps({"train_4k": local_bytes(state_shardings(st, mesh, opt), st),
                  "prefill_32k": local_bytes(param_specs(p, mesh), p)}))
"""


@pytest.fixture(scope="module")
def reference_shards():
    """Bytes of rank 0's blocks of gemma3-1b's state and params under the
    JAX package's ``state_shardings``/``param_specs`` on its (16, 16)
    production mesh (256 host devices, in a subprocess)."""
    env = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = env + \
        " --xla_force_host_platform_device_count=256"
    try:
        return _run(JSHARDS)
    finally:
        os.environ["XLA_FLAGS"] = env


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_dryrun_argument_bytes_equal_reference_shards(dryrun,
                                                      reference_shards,
                                                      shape):
    """The traced rank's state (train) or params (prefill) bytes equal the
    bytes of rank 0's blocks under the JAX package's shardings, and the
    argument bytes add its tokens (int32 rows of the batch over
    ``"data"``)."""
    from repro.configs import SHAPES as JSHAPES
    mem = dryrun[("gemma3-1b", shape, "single")]["memory"]
    assert mem["state_bytes"] == reference_shards[shape]
    s = JSHAPES[shape]
    assert mem["argument_bytes"] == reference_shards[shape] + \
        s.global_batch // 16 * s.seq_len * 4


JFLOPS = """
import json
from repro.configs import CONFIGS, SHAPES, cells
from repro.launch import dryrun
print(json.dumps({f"{a}|{s}": dryrun.model_flops(CONFIGS[a], SHAPES[s])
                  for a, s in cells(CONFIGS)}))
"""


def test_model_flops_equal_reference_for_every_cell():
    from repro_torch.launch.dryrun import model_flops
    ref = _run(JFLOPS)
    got = {f"{a}|{s}": model_flops(CONFIGS[a], SHAPES[s])
           for a, s in cells(CONFIGS)}
    assert len(got) == 32 and got == ref


# ---------------------------------------------------------------------------
# kernel digests and the AOT cache (tests/test_system.py:66)
# ---------------------------------------------------------------------------

def test_library_digest_covers_source_and_flags(monkeypatch):
    d = build.digest("rmsnorm")
    assert build._target("rmsnorm")[1].name == f"rmsnorm-{d}.so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.digest("rmsnorm") != d
    assert build._target("rmsnorm")[1].name != f"rmsnorm-{d}.so"


def _affine(x):
    return x * 2 + 1


def test_aot_cache_roundtrip(tmp_path):
    from repro_torch.core.aot_cache import AotCache
    cache = AotCache(tmp_path / "aot")
    args = (torch.ones((512, 512)),)
    p1, src1 = cache.load_or_compile(_affine, args, tag="t")
    assert src1 == "compile" and cache.stats["stores"] == 1
    # the entry holds the program, not the 1 MiB example input
    (entry,) = (tmp_path / "aot").glob("*.pt2")
    assert entry.stat().st_size < 512 * 512 * 4 // 4
    p2, src2 = cache.load_or_compile(_affine, args, tag="t")
    assert src2 == "cache" and cache.stats["hits"] == 1
    np.testing.assert_array_equal(p2(*args).numpy(), p1(*args).numpy())
    np.testing.assert_array_equal(p2(*args).numpy(), _affine(*args).numpy())


@pytest.mark.parametrize("change", ["tag", "shape", "mesh", "kernel"])
def test_aot_cache_key_changes_miss(tmp_path, monkeypatch, change):
    from repro_torch.core.aot_cache import AotCache
    from repro_torch.launch.mesh import AbstractMesh
    cache = AotCache(tmp_path / "aot")
    args, kw = (torch.ones((8, 8)),), dict(tag="t", mesh=None)
    assert cache.load_or_compile(_affine, args, **kw)[1] == "compile"
    if change == "tag":
        kw["tag"] = "u"
    elif change == "shape":
        args = (torch.ones((8, 4)),)
    elif change == "mesh":
        kw["mesh"] = AbstractMesh((2, 2), ("data", "model"))
    else:
        digest = build.digest
        monkeypatch.setattr(build, "digest", lambda s: digest(s) + "x"
                            if s == "flash_attention" else digest(s))
    assert cache.load_or_compile(_affine, args, **kw)[1] == "compile"
    assert cache.stats["misses"] == 2 and cache.stats["hits"] == 0


def test_aot_cache_corrupt_entry_warns_and_recompiles(tmp_path, caplog):
    from repro_torch.core.aot_cache import AotCache
    cache = AotCache(tmp_path / "aot")
    args = (torch.ones((4, 4)),)
    cache.load_or_compile(_affine, args, tag="t")
    (entry,) = (tmp_path / "aot").glob("*.pt2")
    entry.write_bytes(b"not a program")
    with caplog.at_level(logging.WARNING, logger="repro.ckpt"):
        prog, src = cache.load_or_compile(_affine, args, tag="t")
    assert src == "compile" and cache.stats["errors"] == 1
    assert any("CKPT_W_AOT" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(prog(*args).numpy(),
                                  _affine(*args).numpy())
    assert cache.load_or_compile(_affine, args, tag="t")[1] == "cache"


def test_aot_cache_exports_a_prefill_through_the_registered_ops(tmp_path,
                                                               gemma):
    """A reduced gemma3-1b prefill exports with K7 and K8 as operators;
    the program loaded from the cache gives the eager prefill's logits and
    cache, and the JAX package's logits within ``ATOL``."""
    import jax.numpy as jnp

    from repro_torch.core.aot_cache import AotCache
    from repro_torch.core.split_state import leaf_paths
    jm, jparams, tm, tparams, tokens = gemma
    cache = AotCache(tmp_path / "aot")
    tok = torch.from_numpy(tokens)

    def prefill(p, t):
        return tm.prefill(p, t, cache_len=24)

    cache.load_or_compile(prefill, (tparams, tok), tag="prefill")
    prog, src = cache.load_or_compile(prefill, (tparams, tok), tag="prefill")
    assert src == "cache"
    targets = [str(n.target) for n in prog.graph.nodes]
    assert targets.count("repro_torch.rmsnorm.default") > 0
    assert targets.count("repro_torch.flash_attention.default") == \
        len(tm.cfg.layer_kinds)
    logits, kv = prog(tparams, tok)
    want, want_kv = prefill(tparams, tok)
    assert torch.equal(logits, want)
    for (n, a), (_, b) in zip(leaf_paths(kv), leaf_paths(want_kv)):
        assert torch.equal(a, b), n
    jlog, _ = jm.prefill(jparams, jnp.asarray(tokens), cache_len=24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=ATOL)
