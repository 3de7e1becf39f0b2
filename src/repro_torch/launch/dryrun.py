"""Multi-pod dry run (``src/repro/launch/dryrun.py`` on PyTorch): trace one
rank of every (arch × shape × mesh) cell.

The proof that the distribution config is coherent without the hardware:
rank 0 of the 16×16 single-pod mesh and of the 2×16×16 multi-pod mesh
runs each runnable cell's step under ``FakeTensorMode``, over a ``fake``
process group of 256 or 512 ranks (``launch.mesh.make_fake_mesh``: real
group sizes, collectives that move nothing). Its tensors are fake tensors
on the card (``cuda``), or on the CPU where this machine has no card —
the traced operators are the same, since the two registered kernels
(``repro_torch::rmsnorm``, ``repro_torch::flash_attention``) trace
through their fake implementations either way. Train cells trace the
layout step (``train.steps._layout_step``) on the rank's shards of the
state, prefill and decode cells the serving functions on the sharded
layout (``train.steps.make_serve_fns(model, mesh=...)``: the functions
of ``models.parallel``), params by ``param_specs`` and caches by
``cache_specs``.

From the trace (``launch.hlo_analysis``) each record gets the rank's FLOPs,
device-memory bytes, collectives and wire bytes, an op census, the model
FLOPs and a roofline on the card's ``HW``, and ``memory``: the argument
bytes (the rank's state or params and its inputs; the state alone in
``state_bytes``), the output bytes, and the peak of live bytes while the
step runs (exact tensor sizes, no allocator rounding); a train cell also
gives the peak per part of the step (``peak_by_part``: forward and
backward, the gradient norm, the optimizer's update), the parts
``chip_smoke.py`` measures on the card. ``trace_s`` takes the place of the
reference's ``lower_s``/``compile_s``; ``--keep-hlo`` keeps the trace as
text (an operator a line).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Records go to ``artifacts/dryrun_torch/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

from ..configs import CONFIGS, SHAPES, ShapeSpec, applicable, get_config
from ..configs.base import param_counts
from .hlo_analysis import Trace, _tensors, analyze, op_census, record
from .mesh import HW, make_fake_mesh, make_production_mesh

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def trace_device():
    """The fake tensors' device: the card where there is one."""
    import torch
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class Shard:
    """A leaf of a sharded state as the layout step reads it: this rank's
    block (``to_local``) and the leaf's global ``shape`` (a ``DTensor``'s
    two attributes that the step uses)."""

    def __init__(self, local, shape):
        self.local, self.shape = local, tuple(shape)

    def to_local(self):
        return self.local


def _local(mesh, shardings, abstract, device, wrap=False):
    """Fake tensors of this rank's blocks of `abstract`'s leaves (meta
    tensors) under `shardings` (the same tree of ``NamedSharding``)."""
    import torch
    coord = tuple(mesh.get_coordinate())

    def walk(sh, t):
        if isinstance(t, dict):
            return {k: walk(sh[k], v) for k, v in t.items()}
        rng = sh.range_at(tuple(t.shape), coord)
        local = torch.zeros(tuple(rng.shape), dtype=t.dtype, device=device)
        return Shard(local, t.shape) if wrap else local

    return walk(shardings, abstract)


def input_specs(cfg, shape: ShapeSpec, mesh, device):
    """This rank's blocks of every model input of the cell, as fake
    tensors, split on the batch dim by ``batch_spec`` (train) or by the
    serving layout's rows (prefill, decode) → (inputs, batch axes)."""
    import torch

    from ..sharding.partition import _axis, batch_spec, entry_axes, mesh_axes
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.family == "encoder":
            tree = {"features": ((B, S, cfg.d_model), torch.bfloat16),
                    "labels": ((B, S), torch.int32),
                    "mask": ((B, S), torch.bool)}
        else:
            tree = {"tokens": ((B, S), torch.int32)}
        specs = batch_spec({k: torch.empty(s, dtype=d, device="meta")
                            for k, (s, d) in tree.items()}, mesh, cfg)
        axes = specs[next(iter(tree))].dim_axes(2)[0]
    else:
        if cfg.family == "encoder":
            tree = {"features": ((B, S, cfg.d_model), torch.bfloat16)}
        elif shape.kind == "decode":
            tree = {"tokens": ((B,), torch.int32)}
        else:
            tree = {"tokens": ((B, S), torch.int32)}
        axes = entry_axes(_axis(mesh_axes(mesh), "batch", B))
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return {k: torch.zeros((s[0] // n,) + tuple(s[1:]), dtype=d,
                           device=device)
            for k, (s, d) in tree.items()}, axes


def prepare_cell(arch, shape_name, mesh, overrides=None, *, shape=None,
                 grad_accum=1, accum_dtype=None, device=None):
    """(fn, example args, cfg) for one cell on `mesh`: fake tensors on
    `device` (``trace_device()``), made in the caller's
    ``FakeTensorMode``. `shape` (a ``ShapeSpec``) replaces
    ``SHAPES[shape_name]``; `overrides` may also set ``n_layers``. The
    mesh is installed for the explicit expert-parallel MoE, as the
    reference's dry run does."""
    from ..core.split_state import abstract_train_state, state_shardings
    from ..models import Model
    from ..models.model import set_constrainer, set_exec_mesh
    from ..optim import make_optimizer
    from ..sharding.partition import cache_specs, mesh_axes, param_specs
    from ..train.steps import make_serve_fns, make_train_step
    device = device or trace_device()
    cfg = get_config(arch)
    if overrides:
        overrides = dict(overrides)
        ssm_chunk = overrides.pop("ssm_chunk", None)
        if ssm_chunk and cfg.ssm is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk_size=ssm_chunk))
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    ax = mesh_axes(mesh)
    if cfg.n_heads and ax.tp > 1 and cfg.n_heads % ax.tp != 0:
        # heads don't divide TP: fall back to sequence-parallel attention
        cfg = dataclasses.replace(cfg, seq_shard_attn=True)
    set_constrainer(None)
    set_exec_mesh(mesh)
    model = Model(cfg)
    inputs, axes = input_specs(cfg, shape, mesh, device)

    if shape.kind == "train":
        optimizer = make_optimizer(cfg)
        abstract = abstract_train_state(model, optimizer)
        sh = state_shardings(abstract, mesh, optimizer)
        state = _local(mesh, sh, abstract, device, wrap=True)
        step = make_train_step(model, optimizer, grad_accum=grad_accum,
                               accum_dtype=accum_dtype, shardings=sh,
                               batch_axes=axes)
        step.optimizer = optimizer
        return step, (state, inputs), cfg

    params = _local(mesh, param_specs(model.abstract_params(), mesh),
                    model.abstract_params(), device)
    B, S = shape.global_batch, shape.seq_len
    prefill_fn, decode_fn, encode_fn = make_serve_fns(
        model, mesh=mesh, batch=B, cache_len=S)
    if shape.kind == "prefill":
        if cfg.family == "encoder":
            return encode_fn, (params, inputs["features"]), cfg
        return prefill_fn, (params, inputs["tokens"]), cfg

    # decode: one token with a cache of seq_len, at its last position
    abstract = model.init_cache(B, S, device="meta")
    cache = _local(mesh, cache_specs(abstract, mesh, cfg), abstract, device)

    def decode(p, c, tokens):
        return decode_fn(p, c, tokens, pos=S - 1)
    return decode, (params, cache, inputs["tokens"]), cfg


def model_flops(cfg, shape) -> float:
    """Assigned formula: 6·N·D (train) / 2·N·D (inference), N = active matmul
    params incl. the LM head, D = tokens processed this step."""
    pc = param_counts(cfg)
    n = pc["n_active_matmul"] + cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _parts(fn, trace):
    """Mark the train step's parts in `trace` as ``chip_smoke.py`` marks
    them on the card: up to the gradient norm, the norm, the optimizer's
    update, the rest. Returns the function that undoes the marks."""
    from ..train import steps as steps_mod
    norm, opt = steps_mod.global_norm, fn.optimizer
    update = opt.update

    def marked_norm(*a, **kw):
        trace.mark("forward_backward")
        n = norm(*a, **kw)
        trace.mark("grad_norm")
        return n

    def marked_update(*a, **kw):
        res = update(*a, **kw)
        trace.mark("update")
        return res

    steps_mod.global_norm, opt.update = marked_norm, marked_update

    def undo():
        steps_mod.global_norm = norm
        del opt.update
    return undo


@contextlib.contextmanager
def _traced_workspace():
    """``CUBLAS_WORKSPACE_CONFIG`` for the traced block, restored after:
    the train step's ``deterministic`` guard asks for it on a ``cuda``
    device, and fake tensors never reach cuBLAS, so the caller's
    process is left as it was."""
    from ..train.steps import CUBLAS_WORKSPACE
    prev = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev or CUBLAS_WORKSPACE
    try:
        yield
    finally:
        if prev is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def run_cell(arch, shape_name, mesh_kind, *, keep_hlo=False, overrides=None,
             grad_accum=1, accum_dtype=None, shape=None, mesh_shape=None,
             out_dir=None, rank=0):
    """Trace rank `rank` of one cell → its record. `shape` (a
    ``ShapeSpec``) and `mesh_shape` (on ``("data", "model")``, or
    ``("pod", "data", "model")`` for three dims) replace the named cell's."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import set_constrainer, set_exec_mesh
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "status": "skipped", "reason": reason}
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    if grad_accum != 1:
        rec["grad_accum"] = grad_accum
        rec["accum_dtype"] = str(accum_dtype)
    if not ok:
        return rec
    rec["rank"] = rank
    t0 = time.time()
    try:
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        fake_rank=rank)
        else:
            mesh = make_fake_mesh(mesh_shape, ("pod", "data", "model")[
                -len(mesh_shape):], rank=rank)
        rec["mesh_shape"] = list(mesh.shape)
        n_chips = mesh.size()
        trace = Trace(keep_text=keep_hlo)
        with FakeTensorMode(), _traced_workspace():
            fn, args, cfg2 = prepare_cell(arch, shape.name, mesh, overrides,
                                          shape=shape, grad_accum=grad_accum,
                                          accum_dtype=accum_dtype)
            undo = _parts(fn, trace) if shape.kind == "train" else None
            try:
                out, trace = record(fn, *args, trace=trace)
            finally:
                if undo:
                    undo()
            if undo:
                trace.mark("rest")
        t1 = time.time()
        an = analyze(trace, total_devices=n_chips)
        census = op_census(trace)
        flops_dev, bytes_dev = an["flops"], an["hbm_bytes"]
        coll = {"per_kind": an["collectives"],
                "wire_bytes_per_device": an["wire_bytes"]}
        mf = model_flops(cfg2, shape)
        state_bytes = sum(t.untyped_storage().nbytes()
                          for t in _tensors(args[0]))
        rec.update({
            "status": "ok",
            "trace_s": round(t1 - t0, 2),
            "n_chips": n_chips,
            "device": str(trace_device()),
            "flops_per_device": flops_dev,
            "flops_by_op": an["flops_by_op"],
            "bytes_per_device": bytes_dev,
            "memory": {
                "argument_bytes": trace.argument_bytes,
                "state_bytes": state_bytes,
                "output_bytes": trace.output_bytes,
                "alias_bytes": trace.alias_bytes,
                "peak_bytes_est": trace.peak_bytes,
                **({"peak_by_part": dict(trace.parts)} if trace.parts
                   else {}),
            },
            "collectives": coll,
            "op_census": census,
            "n_ops": len(trace.ops),
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_flops_fraction": (mf / n_chips) / flops_dev
            if flops_dev else 0.0,
            "roofline": roofline_terms(flops_dev, bytes_dev,
                                       coll["wire_bytes_per_device"]),
        })
        if keep_hlo:
            hdir = Path(out_dir or ART_DIR) / "trace"
            hdir.mkdir(parents=True, exist_ok=True)
            (hdir / f"{arch}__{shape.name}__{mesh_kind}.txt").write_text(
                trace.text())
        del out, args, fn
    except Exception as e:  # noqa: BLE001 — a failed cell is a record
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    finally:
        set_constrainer(None)
        set_exec_mesh(None)
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()
    return rec


def roofline_terms(flops_dev, bytes_dev, wire_bytes_dev):
    t_c = flops_dev / HW["peak_flops_bf16"]
    t_m = bytes_dev / HW["hbm_bw"]
    t_n = wire_bytes_dev / HW["ici_bw"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_n, "collective"))
    step = max(t_c, t_m, t_n)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dom[1],
        "bound_step_s": step,
        "roofline_fraction": (t_c / step) if step else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="keep each cell's trace as text")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--preset", action="store_true",
                    help="apply the per-arch production parallelism preset "
                         "(configs/presets.py)")
    ap.add_argument("--moe-impl", default=None, choices=["gspmd", "shard_map"])
    ap.add_argument("--dp-over-model", action="store_true")
    ap.add_argument("--remat", default=None,
                    choices=["nothing", "dots", "full", "offload_resid"])
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--seq-shard-resid", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--accum-dtype", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl
    if args.dp_over_model:
        overrides["dp_over_model"] = True
    if args.remat:
        overrides["remat_policy"] = args.remat
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.seq_shard_resid:
        overrides["seq_shard_resid"] = True
    if args.ssm_chunk:
        overrides["ssm_chunk"] = args.ssm_chunk

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in sorted(CONFIGS) for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for arch, shape_name in cells:
        for mk in meshes:
            path = out_dir / f"{arch}__{shape_name}__{mk}.json"
            cell_over = dict(overrides)
            if args.preset:
                from ..configs.presets import preset_overrides
                cell_over = {**preset_overrides(arch), **cell_over}
            rec = run_cell(arch, shape_name, mk, keep_hlo=args.keep_hlo,
                           overrides=cell_over or None,
                           grad_accum=args.grad_accum,
                           accum_dtype=args.accum_dtype, out_dir=out_dir)
            path.write_text(json.dumps(rec, indent=1))
            tag = rec["status"]
            extra = ""
            if tag == "ok":
                r = rec["roofline"]
                extra = (f" trace={rec['trace_s']}s"
                         f" dom={r['dominant']}"
                         f" frac={r['roofline_fraction']:.2f}"
                         f" mem={rec['memory']['peak_bytes_est']/2**30:.2f}"
                         "GiB")
            elif tag == "error":
                n_fail += 1
                extra = " " + rec["error"][:160]
            print(f"[{tag:7s}] {arch} × {shape_name} × {mk}{extra}",
                  flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
