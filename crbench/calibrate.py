"""Readings that the limits of ``correct`` are set from, for one
configuration, in one process (``PERF.md`` gives them with the limits):

* the program: the first three steps through ``Trainer.fit`` on each
  seed, against the float32 reference (the lower readings);
* the control: the reference with float8 (e4m3) weight products in the
  program's place, the next precision below the configuration's bfloat16;
* a fault: half of each batch left out, the mean taken over the rest
  (the reference on half the rows in the program's place).

A state left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by
their definition and needs no run.

    python3 -m crbench.calibrate --workload <cell> --seeds 12 --controls 3

writes ``chiprun_out/calibrate-<configuration>.json`` and prints it."""
from __future__ import annotations

import argparse
import json
import sys

from .run import ROOT, environment


FIRST_SEED = 1_000_000_007
STRIDE = 7919


def seeds(n: int, first: int = FIRST_SEED) -> list:
    return [first + STRIDE * i for i in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=FIRST_SEED)
    a = p.parse_args(argv)
    environment()
    import torch

    from . import inputs
    from .bench import Bench
    from .driver import Run
    from .reference import compare
    from .reference import train as T
    bench = Bench(ROOT)
    run = Run(bench, a.workload, a.first_seed, 1.0, "cuda")
    from repro_torch.kernels import build
    build.build_all()
    out = {"workload": a.workload, "config": run.w["config"],
           "device": torch.cuda.get_device_name(run.device),
           "program": [], "control": [], "half_batch": []}
    for i, seed in enumerate(seeds(a.seeds, a.first_seed)):
        run.seed = seed
        t = run.start()
        prog = run.first_steps(t)
        t.manager.close()
        t.state = None
        del t
        batches = [inputs.batch(run.cj, run.seed, s, run.device)
                   for s in range(3)]
        ref = T.train(run.model, run.cj, run.w0, batches)
        row = {"seed": run.seed, **compare.gaps(prog, ref)}
        if i < a.controls:
            low = T.train(run.model, run.cj, run.w0, batches, T.fp8_matmul)
            out["control"].append({"seed": run.seed,
                                   **compare.gaps(low, ref)})
            half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                    for b in batches]
            hb = T.train(run.model, run.cj, run.w0, half)
            out["half_batch"].append({"seed": run.seed,
                                      **compare.gaps(hb, ref)})
        out["program"].append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    run.close()
    out["summary"] = {}
    for k in ("loss_gap", "grad_gap", "change_gap"):
        out["summary"][k] = {
            "lower": max(r[k] for r in out["program"]),
            "control": min((r[k] for r in out["control"]), default=None),
            "half_batch": min((r[k] for r in out["half_batch"]),
                              default=None)}
    dst = ROOT / "chiprun_out" / f"calibrate-{run.w['config']}.json"
    dst.parent.mkdir(exist_ok=True)
    dst.write_text(json.dumps(out, indent=1))
    print(json.dumps(out["summary"]))


if __name__ == "__main__":
    sys.exit(main())
