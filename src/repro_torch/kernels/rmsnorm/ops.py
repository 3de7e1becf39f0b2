"""Fused RMSNorm (K7) — the gemma ``(1 + scale)`` convention, math in f32.

  rmsnorm_fused  the wrapper of the hand-written CUDA kernel
                 ``csrc/rmsnorm.cu`` (replaces the Pallas ``rmsnorm_rows``,
                 ``src/repro/kernels/rmsnorm/kernel.py``). A CUDA tensor
                 launches the kernel on the route ``launch_plan`` picks (or
                 raises); a CPU tensor takes the plain version — the only
                 reason it ever does;
  rmsnorm_plain  the plain PyTorch version: ``models/layers.py::rmsnorm``'s
                 math. The CPU tests hold it against the JAX package's
                 Pallas kernel in interpret mode, and ``chip_smoke.py``
                 holds the kernel against it on the card.
  launch_plan    the kernel's launch plan for (rows, D, itemsize, aligned):
                 its route, rows a stage, stages, warps, grid and shared
                 memory;
  rmsnorm_twin   a PyTorch twin of the kernel that walks a plan the way
                 the kernel's CTAs and warps do, and sums each row in the
                 kernel's order (per-lane ascending partial sums, then the
                 xor butterfly). The CPU tests hold the plan's coverage and
                 the twin's values to the plain version and to the JAX
                 package.

  op             the registered operator ``repro_torch::rmsnorm(x, scale,
                 eps)`` (``torch.library``): its CUDA implementation is
                 ``rmsnorm_fused`` (the kernel, its launch plan and its
                 count), its CPU implementation ``rmsnorm_plain``, its fake
                 implementation the output's shape, and its FLOP formula
                 ``4·N·D``. ``FakeTensorMode``, the dispatch trace of
                 ``launch.hlo_analysis`` and ``torch.export`` see the norm
                 as this one operator, and an exported program launches the
                 kernel through it; ``untraced`` says where nothing sees
                 it, and eager serving calls the CUDA implementation;
  rmsnorm        the differentiable norm the model calls: a
                 ``torch.autograd.Function`` whose forward is the operator
                 and whose backward is ``rmsnorm_backward``, written out in
                 PyTorch ops (the JAX package differentiates its XLA
                 ``layers.rmsnorm``; it has no backward Pallas kernel, so
                 neither has the port yet).

The kernel is bound by memory: it reads every input byte once and writes
every output byte once, ``(2·N·D + D)·itemsize`` bytes in all. Its routes
(``csrc/rmsnorm.cu`` says how each works), and the rows ``launch_plan``
gives each (chosen by CUDA-event times on an H100, ``PERF.md`` §6):

  warp      one warp a row and one warp a CTA, 16-byte loads of the row and
            its scale into registers: at most ``LATENCY_ROWS`` rows
            (decode, the training step's k norm), and rows of at least
            ``WARP_ROW_BYTES``
            (the block norms at D 1,152: 2,304 bytes);
  stream    a persistent grid of one or two CTAs an SM, each a ring of
            ``STAGES`` stages of R contiguous rows filled by 1-D bulk
            copies, one warp per R / warps rows, bulk stores out: many
            shorter rows (the q and k norms at D 256);
  scalar    D·itemsize not a multiple of 16 bytes, or a pointer that is not
            16-byte aligned: one warp a row, one element a lane at a time.

Routes warp and stream sum a row in the same order, so they give the same
bits; scalar sums in another order.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import NamedTuple

from .. import build

EPS = 1e-6
SMS = 132               # SMs of an H100 SXM (the plan's default)
SMEM_LIMIT = 232_448    # dynamic shared memory a CTA may use on sm_90
SMEM_PER_SM = 233_472   # shared memory of an SM (1 KB of it per CTA held)
STAGE_BYTES = 24 << 10  # a stream stage's target size
STAGES = 4
MAX_ROWS = 32           # rows of a stream stage, at most
MAX_WARPS = 8           # consumer warps of a stream CTA
LATENCY_ROWS = 4096     # at most this many rows take the warp route,
WARP_ROW_BYTES = 2048   # and so do rows of at least this many bytes
ROUTES = ("stream", "warp", "scalar")
_ROUTE_ID = {"stream": 1, "warp": 2, "scalar": 3}

launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()


class Plan(NamedTuple):
    """How the kernel is launched. `rows`: rows a stage (stream; 1 on the
    other routes, one row a warp); `stages`: the ring's stages (stream,
    else 0); `warps`: consumer warps a CTA (stream adds a producer warp)
    or warps a CTA; `grid`: CTAs; `smem`: dynamic shared memory bytes a
    CTA."""
    route: str
    rows: int
    stages: int
    warps: int
    grid: int
    smem: int


def _align128(n: int) -> int:
    return (n + 127) & ~127


def stream_smem(d: int, itemsize: int, rows: int, stages: int) -> int:
    """Shared memory of a stream CTA, as ``csrc/rmsnorm.cu::stream_smem``
    lays it out: 128 bytes of mbarriers, 1 + scale in f32, the ring."""
    return 128 + _align128(4 * d) + stages * _align128(rows * d * itemsize)


def _floor_pow2(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _stream_plan(n_rows, d, itemsize, sms):
    row_bytes = d * itemsize
    rows = _floor_pow2(min(MAX_ROWS, STAGE_BYTES // row_bytes))
    # small N: fewer rows a stage, so that the blocks still cover the SMs
    while rows > 1 and -(-n_rows // rows) < 2 * sms:
        rows //= 2
    for stages in range(STAGES, 1, -1):
        smem = stream_smem(d, itemsize, rows, stages)
        if smem <= SMEM_LIMIT:
            break
    else:
        return None
    warps = min(MAX_WARPS, rows)
    per_sm = max(1, min(2, SMEM_PER_SM // (smem + 1024)))
    grid = min(-(-n_rows // rows), per_sm * sms)
    return Plan("stream", rows, stages, warps, grid, smem)


@functools.lru_cache(maxsize=1024)
def launch_plan(n_rows: int, d: int, itemsize: int, aligned: bool,
                route: str | None = None, sms: int = SMS) -> Plan:
    """The plan for `n_rows` rows of `d` elements of `itemsize` bytes;
    `aligned`: x's and the scale's pointers are 16-byte aligned; `sms`: the
    card's SM count. `route` forces one of ``ROUTES`` (ValueError where it
    cannot run)."""
    if n_rows < 1 or d < 1:
        raise ValueError(f"no rows to plan: {n_rows} x {d}")
    vector = aligned and (d * itemsize) % 16 == 0
    if route is None:
        if not vector:
            route = "scalar"
        elif n_rows <= LATENCY_ROWS or d * itemsize >= WARP_ROW_BYTES:
            route = "warp"
        else:
            route = "stream"    # rows under 2 KB: four stages always fit
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
    if route == "scalar":
        return Plan("scalar", 1, 0, 4, min(-(-n_rows // 4), 8 * sms), 0)
    if not vector:
        raise ValueError(f"route {route!r} needs D·itemsize a multiple of 16 "
                         f"and 16-byte aligned pointers (D {d}, itemsize "
                         f"{itemsize}, aligned {aligned})")
    if route == "warp":
        return Plan("warp", 1, 0, 1, n_rows, 0)
    plan = _stream_plan(n_rows, d, itemsize, sms)
    if plan is None:
        raise ValueError(f"a stream stage of D {d} x {itemsize} bytes does "
                         "not fit in shared memory")
    return plan


def walk(plan: Plan, n_rows: int):
    """The rows each (CTA, warp) of `plan` computes, in the kernel's order:
    yields ``(cta, warp, first_row, count)``."""
    if plan.route == "stream":
        k = plan.rows // plan.warps
        n_blocks = -(-n_rows // plan.rows)
        for cta in range(plan.grid):
            for b in range(cta, n_blocks, plan.grid):
                nb = min(plan.rows, n_rows - b * plan.rows)
                for w in range(plan.warps):
                    cnt = max(0, min(k, nb - w * k))
                    if cnt:
                        yield cta, w, b * plan.rows + w * k, cnt
        return
    step = plan.grid * plan.warps
    for cta in range(plan.grid):
        for w in range(plan.warps):
            for row in range(cta * plan.warps + w, n_rows, step):
                yield cta, w, row, 1


def _lane_order_rows(xf, w, eps, per_vector):
    """y of the f32 rows `xf` (M, D) as the kernel sums them: lane l adds
    the squares of its vectors (``per_vector`` elements each; vectors l, l
    + 32, ...) in ascending order, one fused multiply-add each (the product
    is exact in f64, the sum rounded once to f32), then the xor butterfly
    16, 8, 4, 2, 1 in f32."""
    import torch
    m, d = xf.shape
    nvec = d // per_vector
    per_lane = -(-nvec // 32)
    v = torch.zeros((m, per_lane * 32, per_vector), dtype=torch.float64)
    v[:, :nvec] = xf.reshape(m, nvec, per_vector).double()
    v = v.view(m, per_lane, 32, per_vector)
    ss = torch.zeros((m, 32), dtype=torch.float32)
    for p in range(per_lane):
        for e in range(per_vector):
            ss = (ss.double() + v[:, p, :, e].square()).float()
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lanes ^ o]
    r = torch.rsqrt(ss[:, :1] / d + eps)
    return (xf * r) * w


def rmsnorm_twin(x, scale, plan: Plan, *, eps: float = EPS):
    """The kernel's arithmetic on the CPU: the rows of `x` (..., D) as
    `plan`'s CTAs and warps walk them, each summed in the kernel's order.
    Raises if the walk does not cover every row exactly once."""
    import torch
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    n = x2.shape[0]
    idx = torch.cat([torch.arange(r0, r0 + c)
                     for _, _, r0, c in walk(plan, n)] or
                    [torch.zeros(0, dtype=torch.long)])
    if idx.numel() != n or not torch.equal(idx.sort().values,
                                           torch.arange(n)):
        raise RuntimeError(f"plan {plan} does not cover {n} rows once")
    per_vector = 1 if plan.route == "scalar" else 16 // x.element_size()
    out = torch.empty((n, d), dtype=torch.float32)
    out[idx] = _lane_order_rows(x2[idx].float(), 1.0 + scale.float(), eps,
                                per_vector)
    return out.to(x.dtype).reshape(x.shape)


def rmsnorm_plain(x, scale, *, eps: float = EPS):
    """x: (..., D); scale: (D,). y = x·rsqrt(mean(x²) + eps)·(1 + scale),
    in f32, rounded once to x's dtype."""
    import torch
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_fused(x, scale, *, eps: float = EPS, route: str | None = None):
    """RMSNorm over the last axis of `x` (any leading shape). CUDA tensor →
    the K7 kernel on the current stream, on the route ``launch_plan`` picks
    (or `route`, forced); CPU tensor → ``rmsnorm_plain``."""
    import torch
    if not x.is_cuda:
        return rmsnorm_plain(x, scale, eps=eps)
    kinds = (torch.bfloat16, torch.float32)
    if x.dtype not in kinds or scale.dtype not in kinds:
        raise TypeError(f"rmsnorm kernel takes bf16/f32, got x {x.dtype}, "
                        f"scale {scale.dtype}")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    aligned = (x.data_ptr() | scale.data_ptr()) % 16 == 0
    plan = launch_plan(rows, d, x.element_size(), aligned, route,
                       _sms(x.get_device()))
    build.launch("rmsnorm", x, x.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), rows, d, float(eps),
                 int(x.dtype == torch.bfloat16),
                 int(scale.dtype == torch.bfloat16), _ROUTE_ID[plan.route],
                 plan.rows, plan.stages, plan.warps, plan.grid, plan.smem)
    global launches
    with _count_lock:
        launches += 1
    return out


@functools.cache
def _sms(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_backward(x, scale, dy, *, eps: float = EPS):
    """(dx, dscale) of ``rmsnorm_plain`` at (x, scale) for the cotangent
    `dy`, in f32 and rounded once to each input's dtype. With
    ``r = rsqrt(mean(x²) + eps)``, ``w = 1 + scale`` and ``g = dy·w``:
    ``dx = r·g − x·r³·mean(g·x)`` and ``dscale = Σ_rows dy·x·r``."""
    import torch
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyf = dy.float()
    g = dyf * (1.0 + scale.float())
    dx = r * g - xf * r.pow(3) * (g * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@functools.cache
def op():
    """The registered operator ``repro_torch::rmsnorm`` (defined at the
    first call in a process)."""
    import torch
    from torch.library import Library, register_fake
    from torch.utils.flop_counter import register_flop_formula
    lib = Library("repro_torch", "FRAGMENT")
    lib.define("rmsnorm(Tensor x, Tensor scale, float eps) -> Tensor")
    lib.impl("rmsnorm", lambda x, scale, eps: rmsnorm_fused(x, scale,
                                                            eps=eps), "CUDA")
    lib.impl("rmsnorm", lambda x, scale, eps: rmsnorm_plain(x, scale,
                                                            eps=eps), "CPU")
    # the kernel's output is a new contiguous tensor of x's shape and dtype
    register_fake("repro_torch::rmsnorm",
                  lambda x, scale, eps: x.new_empty(x.shape), lib=lib)
    _LIBRARIES.append(lib)
    packet = torch.ops.repro_torch.rmsnorm
    register_flop_formula(packet)(flops)
    return packet.default


_LIBRARIES: list = []


def flops(x_shape, scale_shape=None, *args, **kwargs) -> int:
    """The norm's FLOPs: a square, a sum, the product with the row's
    reciprocal root and with ``1 + scale``, per element of x."""
    return 4 * math.prod(x_shape)


@functools.cache
def _autograd_fn():
    import torch

    class RMSNorm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale, eps):
            ctx.save_for_backward(x, scale)
            ctx.eps = eps
            return op()(x, scale, eps)

        @staticmethod
        def backward(ctx, dy):
            x, scale = ctx.saved_tensors
            dx, dscale = rmsnorm_backward(x, scale, dy, eps=ctx.eps)
            return dx, dscale, None

    return RMSNorm


def untraced(x) -> bool:
    """Whether `x` is a plain CUDA tensor that nothing traces: no
    dispatch mode (``FakeTensorMode``, ``torch.export``'s, the trace of
    ``launch.hlo_analysis``), no tensor subclass, no ``torch.compile``.
    There the operator's CUDA implementation is ``rmsnorm_fused``, which
    can be called without the dispatcher's host cost."""
    import torch
    return (type(x) is torch.Tensor and x.is_cuda
            and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling())


def rmsnorm(x, scale, *, eps: float = EPS):
    """Differentiable RMSNorm: the operator's forward (K7 on the card,
    the plain version on the CPU), ``rmsnorm_backward`` as its gradient.
    Where no gradient is recorded (serving), the operator alone, without
    the autograd node's host cost; on an untraced CUDA tensor its CUDA
    implementation alone, without the dispatcher's (a decode step makes
    ~157 K7 calls, and is bound by the host)."""
    import torch
    if not (torch.is_grad_enabled()
            and (x.requires_grad or scale.requires_grad)):
        if untraced(x):
            return rmsnorm_fused(x, scale, eps=eps)
        return op()(x, scale, eps)
    return _autograd_fn().apply(x, scale, eps)
