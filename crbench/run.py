"""Run one cell of the benchmark once and print its result line.

    python3 -m crbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with a trace ``breakdown``, and last ``checks``: each compared number with
its limit). The line before it gives the bytes the process wrote and the
card. Exits non-zero, printing no result, without a CUDA card, when the
program cannot be imported, or when JAX or the JAX package is loaded."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was loaded where that cannot be read."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_LOADED


T_LOADED = time.monotonic()


def environment():
    """Caches inside the checkout at fixed paths; deterministic cuBLAS,
    which the program's training step asks for."""
    build = ROOT / "build"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(build / "torch_kernels"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("USE_FLAX", "0")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def bytes_written() -> dict:
    try:
        io = dict(line.split(": ") for line in
                  Path("/proc/self/io").read_text().splitlines())
        return {"write_bytes": int(io["write_bytes"]),
                "wchar": int(io["wchar"])}
    except (OSError, KeyError, ValueError):
        return {}


def card() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def result(bench, run, traced: bool) -> dict:
    import torch
    from .driver import sync
    rec, dev = run.rec, run.device
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {}
    for entry, reader in bench.metrics(run.w["name"], traced):
        v = reader.read(rec)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": None, "attempted": rec.steps + len(rec.saves)
           + len(rec.restores), "failed": 0, "metrics": metrics,
           "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s()
        device["window_s"] = rec.trace.window_s()
        out["breakdown"] = rec.trace.breakdown()
    return out


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start=None) -> dict:
    """Set-up, window, result, check."""
    from .bench import Bench
    from .driver import Run
    bench = Bench(root)
    run = Run(bench, workload, seed, seconds, device, traced=traced,
              t_start=t_start)
    try:
        run.setup()
        run.measure()
        out = result(bench, run, traced)
        a = time.monotonic()
        checks = run.check()
        run.diag["check_s"] = time.monotonic() - a
        out["correct"] = all(v <= lim for v, lim in checks.values())
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}
        out["diag"] = run.diag
        return out
    finally:
        run.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    environment()
    import torch
    from .bench import Bench
    chips = Bench(ROOT).workload(a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"crbench: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t_start = time.monotonic() - process_age_s()
    out = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"crbench: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"run": out.pop("diag"),
                      "bytes_written": bytes_written(), "card": card()}))
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
