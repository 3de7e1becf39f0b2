"""The SSM and RG-LRU mixers split over the TP axis (``models.parallel``):
each TP rank computes only its own heads (mamba2's SSD) or channels
(recurrentgemma's RG-LRU), shown by spies rather than assumed.

Four gloo ranks on the CPU, one pool for the module, run every case: the
layout step's loss and gradients against the one-device step's, and
serving on the layout (``parallel.prefill`` and three
``parallel.decode_step``s, the tokens forced) against the one-device
``Model.prefill``/``decode_step``: logits and every cache block a rank
holds. Tolerances are ``tests/test_torch_train.py``'s (metrics 2e-5
relative, gradients 1e-4 of each leaf's largest) and
``tests/test_torch_serve_layout.py``'s ``ATOL``.

The spies: ``ssm._chunk`` and ``rglru._scan`` record the head and width
dims they compute on (nh/tp and W/tp where the mixer splits, nh and W
where it falls back); ``sharding.collectives.gather_param``, with the
leaf each gather is for, records which leaves are gathered over
``"model"`` (no RG-LRU leaf; of a split SSM only the packed ``in_proj``
and conv and the gated norm's ``out_norm``); ``parallel.rmsnorm`` records
the gated norm's calls on the mesh (once a layer a forward, on whole
d_inner rows, as on one device).

Cases: reduced mamba2-780m (8 heads) and recurrentgemma-9b (width 64) on
(1,4) and (2,2); mamba2 with 2 B/C groups (a rank's heads inside one
group) and with 4 (a rank holds whole groups); and the fallbacks, which
stay replicated: d_model 48 (6 heads, which do not divide 4) and d_model
96 with 6 groups (12 heads: a rank's three would straddle a group)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
M, R = "mamba2-780m", "recurrentgemma-9b"
# (case id, arch, mesh, config overrides, SSM overrides, split over TP)
CASES = [
    ("mamba2-1x4", M, (1, 4), {}, {}, True),
    ("mamba2-2x2", M, (2, 2), {}, {}, True),
    ("recurrentgemma-1x4", R, (1, 4), {}, {}, True),
    ("recurrentgemma-2x2", R, (2, 2), {}, {}, True),
    ("mamba2-groups2-1x4", M, (1, 4), {}, {"n_groups": 2}, True),
    ("mamba2-groups4-2x2", M, (2, 2), {}, {"n_groups": 4}, True),
    ("mamba2-nh6-1x4", M, (1, 4), {"d_model": 48}, {}, False),
    ("mamba2-straddle-1x4", M, (1, 4), {"d_model": 96}, {"n_groups": 6},
     False),
]
B, S, CACHE_LEN, STEPS = 4, 20, 24, 3
ATOL = 1e-4            # tests/test_torch_serve_layout.py: f32 logits

RANK = """
import os, sys, json, logging, dataclasses
sys.path.insert(0, {src!r})
logging.disable(logging.INFO)
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.split_state import (abstract_train_state,
                                          init_train_state, leaf_paths,
                                          state_shardings, tree_unflatten)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, parallel, rglru, ssm
from repro_torch.models.model import set_constrainer
from repro_torch.optim import make_optimizer
from repro_torch.sharding import collectives
from repro_torch.sharding.partition import (NamedSharding, batch_spec,
                                            distribute_tree, param_specs)
from repro_torch.train.steps import make_train_step

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)

def block(full, sh):
    rng = sh.local_range(tuple(full.shape))
    return full[tuple(slice(a, b) for a, b in zip(rng.start, rng.stop))]

def err(a, b):
    return float((a - b).abs().max())

# the spies
seen = {{"heads": [], "width": [], "gathers": [], "norm": []}}
current = [None]
chunk, scan, gather, param = (ssm._chunk, rglru._scan,
                              collectives.gather_param, parallel._param)
norm = parallel.rmsnorm

def spy_chunk(h, xk, *a, **kw):
    seen["heads"].append(xk.shape[2])
    return chunk(h, xk, *a, **kw)

def spy_scan(a, b):
    seen["width"].append(a.shape[2])
    return scan(a, b)

def spy_param(lay, name, t, **kw):
    current[0] = name
    return param(lay, name, t, **kw)

def spy_gather(t, gathers=(), replicated=()):
    got = gather(t, gathers, replicated)
    seen["gathers"].append([current[0], [
        dist.get_process_group_ranks(g) for g, _ in gathers],
        list(got.shape)])
    return got

def spy_norm(x, scale, **kw):
    seen["norm"].append(x.shape[-1])
    return norm(x, scale, **kw)

def spying(on):
    ssm._chunk, rglru._scan = (spy_chunk, spy_scan) if on else (chunk, scan)
    collectives.gather_param = spy_gather if on else gather
    parallel._param = spy_param if on else param
    parallel.rmsnorm = spy_norm if on else norm
    for v in seen.values():
        v.clear()

def spied():
    return {{k: list(v) for k, v in seen.items()}}

out = []
for case, arch, shape, over, ssm_over, _ in {cases!r}:
    base = reduced(CONFIGS[arch])
    if ssm_over:
        over = {{**over, "ssm": dataclasses.replace(base.ssm, **ssm_over)}}
    cfg = dataclasses.replace(base, **over)
    model, opt = Model(cfg), make_optimizer(cfg)
    mesh = make_host_mesh(shape, ("data", "model"), device="cpu")
    model_ranks = dist.get_process_group_ranks(mesh.get_group("model"))
    rec = {{"case": case, "model_ranks": model_ranks, "layer_shapes": {{
        n: list(t.shape[1:]) for n, t in leaf_paths(model.abstract_params())
        if "/ssm/" in n or "/rglru/" in n}}}}
    # the layout step's loss and gradients against one device's
    pipe = SyntheticPipeline(cfg, batch=4, seq_len=32, device="cpu")
    host, _ = pipe.next_host(pipe.init_state(5))
    batch = {{k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}}
    set_constrainer(None)
    one = init_train_state(model, opt, seed=3, device="cpu")
    live = [p.detach().requires_grad_() for _, p in leaf_paths(one["params"])]
    loss1, m1 = model.loss(tree_unflatten(one["params"], live), batch)
    g1 = dict(zip([n for n, _ in leaf_paths(one["params"])],
                  torch.autograd.grad(loss1, live, allow_unused=True,
                                      materialize_grads=True)))
    sh = state_shardings(abstract_train_state(model, opt), mesh, opt)
    state = distribute_tree(init_train_state(model, opt, seed=3,
                                             device="cpu"), sh)
    bsh = batch_spec(batch, mesh, cfg)
    lb = {{k: block(v, bsh[k]) for k, v in batch.items()}}
    axes = bsh[next(iter(batch))].dim_axes(2)[0]
    step = make_train_step(model, opt, shardings=sh, batch_axes=axes)
    spying(True)
    try:
        _, m, gm = step.grads(state, lb)
    finally:
        rec["train"] = spied()
        spying(False)
    psh = dict(leaf_paths(sh["params"]))
    rec["loss"] = [float(m["loss"]), float(loss1)]
    rec["grad_err"] = {{n: [err(g, block(g1[n], psh[n])),
                           float(g1[n].abs().max())]
                       for n, g in leaf_paths(gm)}}
    # serving on the layout against one device's
    full = model.init(seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, ({b}, {s})).astype(np.int32))
    with torch.no_grad():
        logits1, cache1 = model.prefill(full, tokens, cache_len={cache_len})
        ref = [logits1]
        nxt = [logits1.argmax(-1).int()]
        for _ in range({steps}):
            lg, cache1 = model.decode_step(full, cache1, nxt[-1])
            ref.append(lg)
            nxt.append(lg.argmax(-1).int())
        specs = dict(leaf_paths(param_specs(model.abstract_params(), mesh)))
        params = {{}}
        for n, t in leaf_paths(full):
            node = params
            for k in n.split("/")[:-1]:
                node = node.setdefault(k, {{}})
            node[n.split("/")[-1]] = block(t, specs[n])
        lay = parallel.serve_layout(cfg, mesh, {b}, {cache_len})
        lo, hi = parallel.batch_rows(lay, {b})
        spying(True)
        try:
            logits, cache = parallel.prefill(model, params, tokens[lo:hi],
                                             lay, cache_len={cache_len})
            errs = [err(logits, ref[0][lo:hi])]
            for i in range({steps}):
                logits, cache = parallel.decode_step(model, params, cache,
                                                     nxt[i][lo:hi], lay)
                errs.append(err(logits, ref[i + 1][lo:hi]))
        finally:
            rec["serve"] = spied()
            spying(False)
    rec["logit_err"] = errs
    rec["cache_err"] = {{
        n: err(t, block(dict(leaf_paths(cache1))[n],
                        NamedSharding(mesh, lay.cache_spec[n]))
               if n != "pos" else dict(leaf_paths(cache1))[n])
        for n, t in leaf_paths(cache)}}
    out.append(rec)
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's record per case id, from one pool of four ranks."""
    root = tmp_path_factory.mktemp("tp_mixers")
    code = RANK.format(src=SRC, store=str(root / "store"), cases=CASES,
                       b=B, s=S, cache_len=CACHE_LEN, steps=STEPS)
    world = 4
    procs = []
    for r in range(world):
        out = open(root / f"rank{r}.out", "w+")
        err = open(root / f"rank{r}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], stdout=out, stderr=err,
            env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                 "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}),
            out, err))
    texts = []
    try:
        for p, out, err in procs:
            p.wait(timeout=300)
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
    by_case = {}
    for _, o, _ in texts:
        line = next(x for x in o.splitlines() if x.startswith("RESULT::"))
        for rec in json.loads(line[len("RESULT::"):]):
            by_case.setdefault(rec["case"], []).append(rec)
    return by_case


def _cfg(arch, over, ssm_over):
    import dataclasses

    from repro_torch.configs import CONFIGS, reduced
    base = reduced(CONFIGS[arch])
    if ssm_over:
        over = {**over, "ssm": dataclasses.replace(base.ssm, **ssm_over)}
    return dataclasses.replace(base, **over)


def _sizes(arch, over, ssm_over):
    """(nh or W, d_inner, the number of mixer layers)."""
    from repro_torch.configs.base import RGLRU, SSM
    from repro_torch.models import ssm
    cfg = _cfg(arch, over, ssm_over)
    if arch == R:
        return (cfg.rglru.lru_width, None,
                sum(k == RGLRU for k in cfg.layer_kinds))
    d_inner, nh, _ = ssm.dims(cfg)
    return nh, d_inner, sum(k == SSM for k in cfg.layer_kinds)


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_computes_its_own_heads_and_channels(results, case):
    """The SSD chunk runs on nh/tp heads and the RG-LRU scan on W/tp
    channels where the mixer splits, in training and serving; on nh and
    W where it falls back."""
    cid, arch, shape, over, ssm_over, split = case
    full, _, _ = _sizes(arch, over, ssm_over)
    want = full // shape[1] if split else full
    key = "width" if arch == R else "heads"
    for r in results[cid]:
        for part in ("train", "serve"):
            dims = r[part][key]
            assert dims and set(dims) == {want}, (part, r["case"], dims)


HEADS = {"A_log", "D", "dt_bias", "out_proj"}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_axis_gathers(results, case):
    """No RG-LRU leaf is gathered over ``"model"``: each comes out as the
    rank's 1/tp of the layer's leaf. A split SSM's head leaves (``A_log``,
    ``D``, ``dt_bias``, ``out_proj``) stay the rank's 1/tp, not gathered
    over ``"model"``; its packed ``in_proj``/conv and ``out_norm`` come out
    whole. A fallback SSM's every leaf comes out whole."""
    cid, arch, shape, over, ssm_over, split = case
    tp = shape[1]
    for r in results[cid]:
        seen = 0
        for part in ("train", "serve"):
            for n, groups, got in r[part]["gathers"]:
                if n not in r["layer_shapes"]:
                    continue
                seen += 1
                leaf, full = n.rsplit("/", 1)[-1], r["layer_shapes"][n]
                whole = got == full
                if arch == R:
                    assert r["model_ranks"] not in groups, n
                    assert math.prod(got) * tp == math.prod(full), (n, got)
                elif split and leaf in HEADS:
                    assert r["model_ranks"] not in groups, n
                    assert math.prod(got) * tp == math.prod(full), (n, got)
                else:
                    assert whole, (n, got, full)
        assert seen, r["case"]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == M],
                         ids=[c[0] for c in CASES if c[1] == M])
def test_gated_norm_on_whole_rows_once_a_layer(results, case):
    """A split SSM's gated norm goes through ``layers.rmsnorm`` (K7 on a
    CUDA tensor) once a layer a forward, on whole d_inner rows: the
    prefill and each decode step; a fallback's runs inside the SSM."""
    cid, arch, shape, over, ssm_over, split = case
    _, d_inner, layers = _sizes(arch, over, ssm_over)
    for r in results[cid]:
        norms = r["serve"]["norm"]
        if split:
            assert norms == [d_inner] * (layers * (1 + STEPS)), norms
        else:
            assert norms == [], norms


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_layout_step_matches_one_device(results, case):
    ranks = results[case[0]]
    assert len(ranks) == 4
    for r in ranks:
        got, ref = r["loss"]
        assert abs(got - ref) <= 2e-5 * abs(ref) + 1e-7, (got, ref)
        top = max(scale for _, scale in r["grad_err"].values())
        for n, (e, scale) in r["grad_err"].items():
            assert e <= 1e-4 * scale + 1e-7 * top, (n, e, scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_serving_matches_one_device(results, case):
    """Prefill and decode logits, and after the last step every cache
    block a rank holds, within ``ATOL`` of one device's."""
    for r in results[case[0]]:
        assert len(r["logit_err"]) == STEPS + 1
        assert max(r["logit_err"]) <= ATOL, r["logit_err"]
        assert r["cache_err"]["pos"] == 0
        assert max(r["cache_err"].values()) <= ATOL, r["cache_err"]
