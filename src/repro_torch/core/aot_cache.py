"""AOT program cache — the static-linking analogue
(``src/repro/core/aot_cache.py`` on PyTorch).

Paper: "For best startup performance at scale, it is recommended to
broadcast a statically linked executable to all nodes." The port's
startup cost at restart is tracing its programs and building its kernels;
we serialize exported programs keyed by (tag, input avals, mesh, torch and
CUDA versions, and the digests of the kernel libraries the registered
operators launch) so a restarted (or newly scaled) job loads instead of
tracing again.

"Compile" is ``torch.export.export`` of `fn` at `args`: a program of aten
operators and the port's registered kernels (``repro_torch::rmsnorm``,
``repro_torch::flash_attention``), written with ``torch.export.save``
through a ``.tmp`` rename, without the example inputs (a program takes
its parameters as arguments: the entry holds the graph, not the
weights). A hit is ``torch.export.load(...).module()``;
the loaded program calls the registered operators, so on the card it
launches the hand-written kernels (``kernels.register_ops`` defines the
operators before a load). A stale or unreadable entry warns
``CKPT_W_AOT`` and is compiled again.
"""
from __future__ import annotations

import hashlib
import time
from pathlib import Path

from .errors import warn

# the kernel sources behind the registered operators that a program may
# call (``kernels.register_ops``)
OP_SOURCES = ("rmsnorm", "flash_attention")


def _key(tag: str, avals_repr: str, mesh_repr: str) -> str:
    import torch

    from ..kernels import build
    kernels = ",".join(f"{s}-{build.digest(s)}" for s in OP_SOURCES)
    blob = (f"{tag}|{avals_repr}|{mesh_repr}|torch-{torch.__version__}"
            f"|cuda-{torch.version.cuda}|{kernels}")
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _avals(x):
    """(shape, dtype, device type) of every tensor in nested args."""
    import torch
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, dict):
        return {k: _avals(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return tuple(_avals(v) for v in x)
    return x


def _module(fn):
    import torch

    class Program(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return Program()


class AotCache:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.stats = {"hits": 0, "misses": 0, "stores": 0, "errors": 0}

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.pt2"

    def load_or_compile(self, fn, args, *, tag: str, mesh=None):
        """Returns (program, source) where source is 'cache' | 'compile';
        ``program(*args)`` computes ``fn(*args)``."""
        import torch

        from ..kernels import register_ops
        register_ops()
        args = tuple(args)
        key = _key(tag, repr(_avals(args)), repr(mesh))
        path = self._path(key)
        if path.exists():
            t0 = time.monotonic()
            try:
                program = torch.export.load(path).module()
                self.stats["hits"] += 1
                self.stats["last_load_s"] = time.monotonic() - t0
                return program, "cache"
            except Exception as e:  # noqa: BLE001 — the cache is best-effort
                self.stats["errors"] += 1
                warn("CKPT_W_AOT", "stale AOT cache entry; recompiling",
                     key=key, err=str(e)[:120])
        t0 = time.monotonic()
        exported = torch.export.export(_module(fn), args)
        # the archive keeps the program, not the example inputs it was
        # traced at (a model's parameters would make it the model's size)
        exported.example_inputs = None
        self.stats["misses"] += 1
        try:
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                torch.export.save(exported, f)
            tmp.rename(path)
            self.stats["stores"] += 1
        except Exception as e:  # noqa: BLE001
            self.stats["errors"] += 1
            warn("CKPT_W_AOT", "program serialization unavailable",
                 err=str(e)[:120])
        self.stats["last_compile_s"] = time.monotonic() - t0
        return exported.module(), "compile"
