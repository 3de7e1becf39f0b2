"""Timing helpers for the scripts that measure the kernels on the card
(``chip_smoke.py``, ``scripts/k4_ablation.py``): the card's name and power
limit, CUDA-event times, and a kernel built from another source with the
same C interface (an earlier design, or a variant of the current one).

Nothing here runs at import, and nothing here is on a path the port's
entry points take."""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

from . import build


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of `fn()` over `iters` runs after `warmup`."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def load_variant(kernel: str, src: Path, out_dir: Path):
    """Build `src`, a source with the C interface of `kernel`
    (``build.SIGNATURES``), into `out_dir` with ``build.NVCC_FLAGS``, and
    return its entry point with its argument types set. A failed build
    raises."""
    so = Path(out_dir) / f"{Path(src).stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    sym, argtypes = build.SIGNATURES[kernel]
    entry = getattr(ctypes.CDLL(str(so)), sym)
    entry.argtypes = list(argtypes)
    entry.restype = ctypes.c_int
    return entry


def byteplane_inv_launcher(entry):
    """``fn(u8, out, k)``: `entry` (a ``byteplane_inv`` entry point, of any
    design) launched on the current stream into `out`, with a scratch
    large enough for tiles of 1,024 elements or more (``fn.scratch``)."""
    import torch
    scratch = {}

    def fn(u8, out, k):
        n = u8.numel()
        need = 8 * -(-n // 1024) + 64
        if scratch.get("t") is None or scratch["t"].numel() < need:
            scratch["t"] = torch.empty(need, dtype=torch.uint8,
                                       device=u8.device)
        err = entry(u8.data_ptr(), out.data_ptr(), scratch["t"].data_ptr(),
                    n, k, need, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"byteplane_inv failed to launch "
                               f"(cudaError {err})")
        return out
    fn.scratch = scratch
    return fn
