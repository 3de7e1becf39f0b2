"""Elastic rescale demo on the PyTorch port — the M×N property: checkpoint
on one mesh, restore on a different mesh shape, keep training. The twin of
``examples/elastic_rescale.py``; runs on the CUDA card unless ``--device
cpu``.

Spawns itself as 8 rank processes that share one gloo process group over a
``FileStore`` in the workdir, so the demo has 8 ranks to re-shape. gloo on
the card too: NCCL refuses two ranks on one card, and the 8 ranks share
one. Rank 0 prints the demo's lines; the script fails if any rank does.

    PYTHONPATH=src python examples/torch_elastic_rescale.py [--device cpu]
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.devices import resolve_device  # noqa: E402

WORLD = 8
TIMEOUT_S = 900


def rank_main(rank: int, wd: str, device: str) -> dict:
    """One rank of the demo; returns what it saw (digests, restored steps,
    reports, its K7/K8 launches and peak device bytes)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.steps import CUBLAS_WORKSPACE

    # the deterministic train step needs it before cuBLAS first runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(wd, "rendezvous"), WORLD),
        rank=rank, world_size=WORLD)
    say = print if rank == 0 else (lambda *a: None)

    cfg = reduced(CONFIGS["llama4-scout-17b-a16e"])   # MoE: richest sharding

    def tc():
        return TrainerConfig(workdir=wd, batch=8, seq_len=64, ckpt_every=5,
                             seed=0, log_every=5)

    def mesh(shape):
        return make_host_mesh(shape, ("data", "model"), device=dev)

    say("== phase 1: train on a (2 data x 4 model) mesh")
    t1 = Trainer(cfg, tc(), mesh=mesh((2, 4)), device=dev)
    t1.init_or_restore()
    r1 = t1.fit(5)
    d1 = t1.params_digest()
    say("   checkpointed at step 5; digest", d1[:16])
    t1.manager.close()

    say("== phase 2: cluster shrank — restore on (4 data x 2 model)")
    t2 = Trainer(cfg, tc(), mesh=mesh((4, 2)), device=dev)
    t2.init_or_restore()
    d2 = t2.params_digest()
    assert d2 == d1, "restore must be value-exact across meshes"
    say("   exact restore onto new topology; continuing training")
    r2 = t2.fit(10)
    t2.manager.close()

    say("== phase 3: scale-up — restore on (8 data x 1 model)")
    t3 = Trainer(cfg, tc(), mesh=mesh((8, 1)), device=dev)
    t3.init_or_restore()
    say("   restored step:", t3.restored_from)
    r3 = t3.fit(12)
    d3 = t3.params_digest()
    t3.manager.close()
    say("== elastic rescale complete: 2x4 -> 4x2 -> 8x1, one checkpoint "
        "format")
    out = {"rank": rank, "digest_5": d1, "restored_digest_5": d2,
           "restored_from": [t2.restored_from, t3.restored_from],
           "reports": [(r["status"], r["step"]) for r in (r1, r2, r3)],
           "digest_12": d3,
           "launches": {"rmsnorm": norm_ops.launches,
                        "flash_attention": attn_ops.launches},
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev)
           if dev.type == "cuda" else None}
    dist.barrier()
    dist.destroy_process_group()
    return out


def main(device=None) -> dict:
    """Runs the 8 ranks; returns the workdir, each rank's result and
    ``check``: what the run asserted. Raises if a rank fails (with its
    stderr's end) or the ranks disagree."""
    dev = resolve_device(device)
    wd = tempfile.mkdtemp(prefix="repro-elastic-")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    sys.stdout.flush()
    logs = [open(os.path.join(wd, f"rank{r}.log"), "w+")
            for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--workdir", wd,
         "--device", str(dev)],
        stdout=None if r == 0 else subprocess.DEVNULL, stderr=logs[r],
        env=env) for r in range(WORLD)]
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else 0
                logs[r].seek(0)
                raise RuntimeError(
                    f"elastic rank {r} "
                    + (f"exited {procs[r].returncode}" if bad
                       else f"ran past {TIMEOUT_S} s")
                    + f"; its stderr ends:\n{logs[r].read()[-4000:]}")
            time.sleep(0.2)
        for r, p in enumerate(procs):
            if p.returncode:
                logs[r].seek(0)
                raise RuntimeError(
                    f"elastic rank {r} exited {p.returncode}; its stderr "
                    f"ends:\n{logs[r].read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = [json.loads(Path(wd, f"rank{r}.json").read_text())
             for r in range(WORLD)]
    for key in ("digest_5", "digest_12", "restored_from", "reports"):
        if any(r[key] != ranks[0][key] for r in ranks):
            raise RuntimeError(f"the ranks disagree on {key}")
    # each rank asserted its restore on (4,2) value-exact
    exact = all(r["restored_digest_5"] == r["digest_5"] for r in ranks)
    return {"workdir": wd, "ranks": ranks,
            "check": {"ok": exact and len(ranks) == WORLD,
                      "digests_equal_across_meshes": exact,
                      "restored_from": ranks[0]["restored_from"],
                      "reports": ranks[0]["reports"], "ranks": len(ranks)}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.rank is None:
        main(args.device)
    else:
        res = rank_main(args.rank, args.workdir, args.device)
        Path(args.workdir, f"rank{args.rank}.json").write_text(
            json.dumps(res))
