"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library (one source
may hold several kernels: ``int8_codec.cu`` holds K5 and K6), loaded with
``ctypes``
(no PyTorch headers: a build takes seconds, not minutes). Libraries are
built at first use from the sources in the checkout, into
``build/torch_kernels/`` at the repository root (git-ignored; override with
``REPRO_TORCH_BUILD_DIR``), and named by a hash of their source and of
``NVCC_FLAGS`` so an edited kernel or a changed flag is never served from
a stale build. ``build_all`` compiles
every kernel at once, one ``nvcc`` per source, all in parallel.

Nothing here runs at import: the CPU test suite imports every module on a
machine without ``nvcc``. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
_P, _I64, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
_INT, _F32 = ctypes.c_int, ctypes.c_float
# kernel → (C entry point, argument types); every entry point returns
# cudaGetLastError() as an int, and takes PyTorch's stream last. A kernel's
# source is csrc/<kernel>.cu unless SOURCES names another.
SIGNATURES = {
    "gear_scan": ("rt_gear_scan", (_P, _P, _P, _I64, _U32, _U32, _P)),
    "byteplane_fwd": ("rt_byteplane_fwd", (_P, _P, _I64, _I64, _P)),
    "rle_emit": ("rt_rle_emit", (_P, _P, _P, _I64, _I64, _P)),
    "rmsnorm": ("rt_rmsnorm", (_P, _P, _P, _I64, _I64, _F32, _INT, _INT,
                               _INT, _INT, _INT, _INT, _INT, _INT, _P)),
    "flash_attention": ("rt_flash_attention",
                        (_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT,
                         _F32, _F32, _INT, _INT, _INT, _INT, _P)),
    "flash_attention_bq": ("rt_flash_attention_bq",
                           (_P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT,
                            _INT, _F32, _F32, _INT, _INT, _INT, _INT, _INT,
                            _P)),
    "byteplane_inv": ("rt_byteplane_inv", (_P, _P, _P, _I64, _I64, _I64,
                                           _P)),
    "quantize_blocks": ("rt_quantize_blocks", (_P, _P, _P, _I64, _INT, _P)),
    "dequantize_blocks": ("rt_dequantize_blocks",
                          (_P, _P, _P, _I64, _INT, _P)),
}
SOURCES = {"quantize_blocks": "int8_codec", "dequantize_blocks": "int8_codec",
           "flash_attention_bq": "flash_attention"}
KERNELS = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def source(kernel: str) -> str:
    """The stem of the ``csrc/*.cu`` file that holds `kernel`."""
    return SOURCES.get(kernel, kernel)


def digest(name: str) -> str:
    """The digest that names source `name`'s library: its bytes and
    ``NVCC_FLAGS``, so that a change to either builds a new library
    (``core.aot_cache`` keys its programs by the same digests)."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _target(name: str) -> tuple:
    return SRC_DIR / f"{name}.cu", build_dir() / f"{name}-{digest(name)}.so"


def ptxas_log(kernel: str) -> Path:
    """Where the build of `kernel`'s source keeps nvcc's report (``-Xptxas
    -v``: registers, shared memory and spills of each kernel)."""
    return _target(source(kernel))[1].with_suffix(".log")


def _start(name: str):
    """Start one nvcc build; returns (so path, Popen or None if built)."""
    src, so = _target(name)
    if so.exists():
        return so, None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp)


def _finish(name: str, so: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(tmp, so)
    return out


def build_all(names=KERNELS) -> dict:
    """Compile the sources of every kernel in parallel (one nvcc per
    source); returns {source: nvcc output} (empty for libraries already
    built)."""
    srcs = list(dict.fromkeys(source(n) for n in names))
    with _lock:
        jobs = {n: _start(n) for n in srcs}
        return {n: _finish(n, *jobs[n]) for n in srcs}


def kernel(name: str):
    """The C entry point of kernel `name` (library built and loaded at
    first use), with its argument types set."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            src = source(name)
            so, job = _start(src)
            _finish(src, so, job)
            sym, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(so)), sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn


def launch(name: str, t, *args):
    """Launch kernel `name` on PyTorch's current stream of `t`'s device
    (arguments before the stream: `args`); raises if the launch failed.
    Switches the current device only where `t` lies on another one (the
    host cost of a launch counts on the decode path)."""
    import torch
    fn = _libs.get(name) or kernel(name)
    index = t.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")

