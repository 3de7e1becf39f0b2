"""Serving on the sharded layout (``models.parallel.prefill``,
``decode_step``; ``train.steps.make_serve_fns(model, mesh=...)``) against
the JAX package's serving functions, on gloo ranks on the CPU; and ``encode`` on the layout
for reduced hubert-xlarge.

Reduced gemma3-1b (one kv head: the cache's positions split over
``"model"``, local layers' ring buffers wrapping), llama4-scout (MoE; two
kv heads: on (2,2) the cache's heads split over ``"model"``, on (1,4) its
positions) and mamba2-780m (SSM: the recurrent state's heads split over
``"model"``), each on (2,2) and (1,4), f32. The JAX ``Model``'s weights
come across with ``convert.from_jax_state``; every rank keeps its shards
of them (``param_specs``) and of a batch of 4 prompts of 20 tokens, then
prefills a cache of 24 positions and takes three decode steps, the tokens
forced to the reference's. Each rank's prefill logits and every decode
step's logits equal the reference's rows within
``tests/test_torch_serve.py``'s ``ATOL``; the next tokens of the mesh's
``make_serve_fns`` equal the reference ``make_serve_fns``' tokens; and after
the last step every cache block a rank holds equals its slice of the
reference's cache (``cache_specs``) within the same bound."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["gemma3-1b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-9b"]
ENCODER = "hubert-xlarge"
MESHES = [(2, 2), (1, 4)]
B, S, CACHE_LEN, STEPS = 4, 20, 24, 3
ATOL = 1e-4            # tests/test_torch_serve.py: f32 logits

RANK = """
import os, sys, json, pickle, logging
sys.path.insert(0, {src!r})
logging.disable(logging.INFO)
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import CONFIGS, reduced
from repro_torch.convert import from_jax_state
from repro_torch.core.split_state import leaf_paths, map_leaves
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, parallel
from repro_torch.sharding.partition import NamedSharding, param_specs
from repro_torch.train.steps import make_serve_fns

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)
ref = pickle.load(open({ref!r}, "rb"))

def block(full, sh):
    rng = sh.local_range(tuple(full.shape))
    return full[tuple(slice(a, b) for a, b in zip(rng.start, rng.stop))]

def err(a, b):
    return float((a - torch.as_tensor(b)).abs().max())

out = []
for arch in {archs!r} + [{encoder!r}]:
    r = ref[arch]
    model = Model(reduced(CONFIGS[arch]))
    full = from_jax_state(r["params"], "cpu")
    for shape in {meshes!r}:
        mesh = make_host_mesh(shape, ("data", "model"), device="cpu")
        specs = param_specs(model.abstract_params(), mesh)
        params = {{}}
        for n, t in leaf_paths(full):
            node = params
            for k in n.split("/")[:-1]:
                node = node.setdefault(k, {{}})
            node[n.split("/")[-1]] = block(t, dict(leaf_paths(specs))[n])
        lay = parallel.serve_layout(model.cfg, mesh, {b}, {cache_len})
        lo, hi = parallel.batch_rows(lay, {b})
        if arch == {encoder!r}:
            _, _, encode_fn = make_serve_fns(model, mesh=mesh, batch={b},
                                             cache_len={cache_len})
            logits = encode_fn(params, torch.as_tensor(r["features"][lo:hi]))
            out.append({{"arch": arch, "mesh": list(shape), "rows": [lo, hi],
                         "logit_err": [err(logits, r["logits"][lo:hi])]}})
            continue
        tokens = torch.as_tensor(r["tokens"][lo:hi])
        logits, cache = parallel.prefill(model, params, tokens, lay,
                                         cache_len={cache_len})
        errs = [err(logits, r["logits"][0][lo:hi])]
        prefill_fn, decode_fn, _ = make_serve_fns(
            model, mesh=mesh, batch={b}, cache_len={cache_len})
        tok0, _ = prefill_fn(params, tokens)
        same = [tok0.tolist() == r["next"][0][lo:hi].tolist()]
        for i in range({steps}):
            forced = torch.as_tensor(r["next"][i][lo:hi])
            scratch = map_leaves(lambda t: t.clone(), cache)
            toks, _ = decode_fn(params, scratch, forced)
            same.append(toks.tolist() == r["next"][i + 1][lo:hi].tolist())
            logits, cache = parallel.decode_step(model, params, cache,
                                                 forced, lay)
            errs.append(err(logits, r["logits"][i + 1][lo:hi]))
        cache_err = {{}}
        for n, t in leaf_paths(cache):
            want = r["cache"][n]
            if n != "pos":
                want = block(torch.as_tensor(want),
                             NamedSharding(mesh, lay.cache_spec[n]))
            cache_err[n] = err(t, want)
        out.append({{"arch": arch, "mesh": list(shape), "rows": [lo, hi],
                     "logit_err": errs, "tokens_equal": same,
                     "cache_err": cache_err}})
print("RESULT::" + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _encoder_reference():
    """The JAX package's weights, frame features and ``encode`` logits for
    reduced hubert-xlarge."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.models import Model
    m = Model(reduced(get_config(ENCODER)))
    params = m.init(jax.random.PRNGKey(0))
    feats = np.random.default_rng(9).standard_normal(
        (B, S, m.cfg.d_model)).astype(np.float32)
    return {"params": jax.tree.map(np.asarray, params), "features": feats,
            "logits": np.asarray(m.encode(params, jnp.asarray(feats)))}


def _reference(arch):
    """The JAX package's weights, logits, next tokens (its
    ``make_serve_fns``) and final cache for one reduced config."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.models import Model
    from repro.train.steps import make_serve_fns
    m = Model(reduced(get_config(arch)))
    params = m.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(0, 128, (B, S),
                                               dtype=np.int32)
    prefill_fn, decode_fn, _ = make_serve_fns(m)
    logits, cache = m.prefill(params, jnp.asarray(tokens),
                              cache_len=CACHE_LEN)
    tok, _ = prefill_fn(params, jnp.asarray(tokens), cache_len=CACHE_LEN)
    out = {"logits": [np.asarray(logits)], "next": [np.asarray(tok)]}
    for _ in range(STEPS):
        nxt, _ = decode_fn(params, cache, tok)
        logits, cache = m.decode_step(params, cache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        assert np.array_equal(np.asarray(nxt), np.asarray(tok))
        out["logits"].append(np.asarray(logits))
        out["next"].append(np.asarray(tok))
    from repro.core.split_state import leaf_paths
    out.update(params=jax.tree.map(np.asarray, params), tokens=tokens,
               cache={n: np.asarray(t) for n, t in leaf_paths(cache)})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_layout")
    ref = root / "ref.pkl"
    with open(ref, "wb") as f:
        pickle.dump({**{a: _reference(a) for a in ARCHS},
                     ENCODER: _encoder_reference()}, f)
    code = RANK.format(src=SRC, store=str(root / "store"), ref=str(ref),
                       archs=ARCHS, encoder=ENCODER, meshes=MESHES, b=B,
                       cache_len=CACHE_LEN, steps=STEPS)
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
            p.wait(timeout=600)
            out.seek(0)
            err.seek(0)
            texts.append((p.returncode, out.read(), err.read()))
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            out.close()
            err.close()
    bad = [(r, e) for r, (rc, _, e) in enumerate(texts) if rc]
    assert not bad, f"rank {bad[0][0]}: {bad[0][1][-4000:]}"
    by_case = {}
    for _, o, _ in texts:
        line = next(x for x in o.splitlines() if x.startswith("RESULT::"))
        for rec in json.loads(line[len("RESULT::"):]):
            by_case.setdefault((rec["arch"], tuple(rec["mesh"])),
                               []).append(rec)
    return by_case


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logits_match_reference(results, arch, mesh):
    ranks = results[(arch, mesh)]
    assert len(ranks) == 4
    for r in ranks:
        assert len(r["logit_err"]) == STEPS + 1
        assert max(r["logit_err"]) <= ATOL, r


@pytest.mark.parametrize("mesh", MESHES)
def test_encode_matches_reference(results, mesh):
    """``encode`` on the layout (the frames' rows over ``"data"``, the
    residual's sequence and the vocabulary over ``"model"`` where they
    divide) gives the reference's (B, S, V) logits of the rank's rows."""
    ranks = results[(ENCODER, mesh)]
    assert len(ranks) == 4
    for r in ranks:
        assert r["logit_err"][0] <= ATOL, r


@pytest.mark.parametrize("arch,mesh", CASES)
def test_next_tokens_match_reference(results, arch, mesh):
    for r in results[(arch, mesh)]:
        assert all(r["tokens_equal"]), r


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_blocks_match_reference(results, arch, mesh):
    rows = set()
    for r in results[(arch, mesh)]:
        rows.add(tuple(r["rows"]))
        assert r["cache_err"]["pos"] == 0
        assert max(r["cache_err"].values()) <= ATOL, r
    # the batch rows split over "data" (2,2), whole on every rank (1,4)
    assert rows == ({(0, 2), (2, 4)} if mesh == (2, 2) else {(0, 4)})
