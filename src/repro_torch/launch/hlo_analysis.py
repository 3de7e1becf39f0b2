"""Cost analysis over a recorded dispatch trace (the port of
``src/repro/launch/hlo_analysis.py``; the file keeps the reference's name,
but it reads a trace of PyTorch operators, not HLO text).

``record(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` (on real
or fake tensors; ``launch.dryrun`` traces one rank under
``FakeTensorMode``) and keeps every ``aten``, ``repro_torch`` and ``c10d``
operator it dispatches, with its operands' and results' types. From that
trace:

  * flops        — the FLOP formula of each operator that has one
                   (``torch.utils.flop_counter``'s registry: ``mm``,
                   ``bmm``, ``addmm``, ``baddbmm``, convolutions; and the
                   two registered kernels, K7 ``4·N·D`` and K8
                   ``4·D·B·H·unmasked_pairs``). The reference counts dots
                   and convolutions only; ``flops_by_op`` splits the total;
  * hbm_bytes    — Σ (operand + result bytes) over the operators that
                   compute: views and metadata operators count nothing, as
                   the reference's ``_SKIP_BYTES_OPS``; nor do
                   allocations and collectives. An eager trace has no
                   fusions: each operator reads its operands from and writes
                   its result to device memory, so this is the traffic of
                   the eager program;
  * collectives  — per kind (all-gather, all-reduce, reduce-scatter,
                   all-to-all), the count, result bytes, ring wire bytes
                   (the reference's ``_wire_factor`` at the process group's
                   size) and the largest group.

All figures are the traced rank's own. The reference walks the HLO call
graph to multiply each while-loop body by its trip count
(``cost_analysis`` counts a body once); an eager trace has no loop bodies —
every layer's operators are dispatched, and so recorded, once per layer —
so there is nothing to multiply. Operators on ``meta`` tensors (shapes
only, such as an abstract parameter tree the code builds to read specs)
are left out: they do no device work.

``record`` also follows the tensors' storages (a weak reference on each
one's Python object, which PyTorch keeps alive exactly as long as the
storage): the bytes of the arguments, the peak of live bytes while ``fn``
runs (allocations are exact sizes: the caching allocator's rounding is not
modelled), the bytes of the outputs, and the peak per part between
``Trace.mark`` calls.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d (in place, the first argument takes the result) and
# _c10d_functional (a new result) operators by the reference's kinds
_COLLECTIVES = {
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
}

# operators that move no bytes of their own: allocations, metadata, and
# the views that the schema does not already mark
_SKIP_BYTES = {
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
    "aten.lift_fresh_copy", "aten._local_scalar_dense", "aten.set_",
    "aten.resize_", "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset", "aten.is_same_size", "aten.record_stream",
    "c10d.barrier", "c10d.monitored_barrier_", "_c10d_functional.wait_tensor",
}

# the reference's census categories, each as the aten operators that do
# that work in an eager trace; "fusion" and "while" have none (no fusions,
# no loop bodies), and the two registered kernels count apart
CENSUS = {
    "fusion": (),
    "convolution": ("aten.convolution", "aten.convolution_backward"),
    "dot": ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"),
    "scatter": ("aten.scatter", "aten.scatter_add", "aten.scatter_reduce",
                "aten.index_put", "aten.index_put_", "aten.index_add",
                "aten.index_add_", "aten.embedding_dense_backward"),
    "gather": ("aten.gather", "aten.index", "aten.index_select",
               "aten.embedding"),
    "transpose": ("aten.transpose", "aten.permute", "aten.t"),
    "dynamic-slice": ("aten.slice", "aten.select", "aten.narrow"),
    "dynamic-update-slice": ("aten.slice_scatter", "aten.select_scatter",
                             "aten.copy_"),
    "while": (),
    "rmsnorm": ("repro_torch.rmsnorm",),
    "flash_attention": ("repro_torch.flash_attention",),
}


def _tensors(x):
    """The tensors in `x` (nested lists, tuples and dicts; an object with
    ``to_local``, a shard wrapper, by its local tensor)."""
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif hasattr(x, "to_local"):
        yield x.to_local()
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _type(t) -> str:
    return f"{str(t.dtype)[6:]}{list(t.shape)}"


def _group_size(args) -> int | None:
    """The size of the process group among a collective's arguments (a
    boxed ``ProcessGroup``, or a group name)."""
    import torch
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(a).size()
    return None


class Trace:
    """What ``record`` kept: ``ops`` (name, FLOPs, bytes, collective or
    None, text or None per operator), ``argument_bytes``, ``peak_bytes``,
    ``output_bytes``, ``alias_bytes`` (outputs that are arguments) and
    ``parts`` (peak live bytes between marks)."""

    def __init__(self, keep_text: bool = False):
        self.ops: list = []
        self.keep_text = keep_text
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self.parts: dict = {}
        self._part_peak = 0
        self._storages: dict = {}

    # -- storage lifetimes --------------------------------------------
    def _track(self, t) -> bool:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return False
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        self._part_peak = max(self._part_peak, self.live)
        return True

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def mark(self, part: str):
        """End part `part`: its peak of live bytes is kept in ``parts``, and
        the next part's peak starts from the bytes live now."""
        self.parts[part] = self._part_peak
        self._part_peak = self.live

    def text(self) -> str:
        """The trace as text, an operator a line (``record(...,
        keep_text=True)``)."""
        return "\n".join(op[4] for op in self.ops if op[4])


def _recorder(trace: Trace):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            name = f"{func.namespace}.{packet.__name__}"
            if func.namespace not in ("aten", "repro_torch", "c10d",
                                      "_c10d_functional") or \
                    any(t.device.type == "meta" for t in _tensors(out)):
                # shapes only (an abstract parameter tree): no device work
                return out
            for t in _tensors(out):
                trace._track(t)
            flops = 0
            f = flop_registry.get(packet)
            if f is not None:
                flops = f(*args, **kwargs, out_val=out)
            coll = None
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                res = args[0] if name.startswith("c10d.") else out
                coll = (kind, sum(_nbytes(t) for t in _tensors(res)),
                        _group_size(list(args) + list(kwargs.values())))
                nbytes = 0
            elif func.is_view or name in _SKIP_BYTES:
                nbytes = 0
            else:
                nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                    + sum(_nbytes(t) for t in _tensors(out))
            text = None
            if trace.keep_text:
                ins = ", ".join(_type(t) for t in _tensors((args, kwargs)))
                outs = ", ".join(_type(t) for t in _tensors(out))
                text = f"{outs} = {func}({ins})"
            trace.ops.append((name, flops, nbytes, coll, text))
            return out

    return Recorder()


def record(fn, *args, keep_text: bool = False, trace: Trace | None = None):
    """Run ``fn(*args)`` under the recorder → ``(result, Trace)``. Pass
    `trace` to ``mark`` parts from inside ``fn``."""
    trace = trace or Trace(keep_text)
    for t in _tensors(args):
        if trace._track(t):
            trace.argument_bytes += t.untyped_storage().nbytes()
    trace._part_peak = trace.live
    with _recorder(trace):
        out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in _tensors(args)}
    seen = set()
    for t in _tensors(out):
        key = id(t.untyped_storage())
        if key in seen:
            continue
        seen.add(key)
        n = t.untyped_storage().nbytes()
        trace.output_bytes += n
        if key in arg_ids:
            trace.alias_bytes += n
    return out, trace


def _wire_factor(kind: str, group: int) -> float:
    if group <= 1:
        return 0.0
    f = (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * f
    if kind == "collective-permute":
        return 1.0
    return f


def analyze(trace: Trace, total_devices: int = 1) -> dict:
    """The reference's keys (``flops``, ``hbm_bytes``, ``collectives``,
    ``wire_bytes``) and ``flops_by_op``, over `trace`; a collective whose
    group is unknown spans `total_devices`."""
    flops, hbm = 0.0, 0.0
    by_op = defaultdict(float)
    colls = {}
    for name, f, nbytes, coll, _ in trace.ops:
        flops += f
        if f:
            by_op[name] += f
        hbm += nbytes
        if coll is not None:
            kind, nb, g = coll
            g = total_devices if g is None else g
            s = colls.setdefault(kind, {"count": 0.0, "result_bytes": 0.0,
                                        "wire_bytes": 0.0, "max_group": 1})
            s["count"] += 1
            s["result_bytes"] += nb
            s["wire_bytes"] += nb * _wire_factor(kind, g)
            s["max_group"] = max(s["max_group"], g)
    return {"flops": flops, "hbm_bytes": hbm, "collectives": colls,
            "wire_bytes": sum(v["wire_bytes"] for v in colls.values()),
            "flops_by_op": dict(by_op)}


def op_census(trace: Trace, census=None) -> dict:
    """Operators per census category (``CENSUS``: the reference's
    categories as aten names, and the two registered kernels), and each
    collective kind."""
    census = CENSUS if census is None else census
    names = defaultdict(int)
    for name, _, _, coll, _ in trace.ops:
        names[name] += 1
    out = {cat: sum(names[n] for n in ops) for cat, ops in census.items()}
    for kind in COLLECTIVE_KINDS:
        out[kind] = sum(1 for op in trace.ops
                        if op[3] is not None and op[3][0] == kind)
    return out


__all__ = ["CENSUS", "COLLECTIVE_KINDS", "Trace", "analyze", "op_census",
           "record"]
