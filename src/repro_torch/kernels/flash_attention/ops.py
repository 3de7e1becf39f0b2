"""Flash-attention forward (K8) on the model's (B, S, H, D) layout.

  flash_attention        the wrapper of the hand-written CUDA kernel
                         ``csrc/flash_attention.cu`` (replaces the Pallas
                         ``flash_attention_bhsd``,
                         ``src/repro/kernels/flash_attention/kernel.py``).
                         A CUDA tensor launches the kernel (or raises); a
                         CPU tensor takes the plain version;
  flash_attention_plain  the Pallas kernel's math in dense form: q scaled
                         in f32, scores in f32, the ``NEG_INF = -1e30``
                         mask, p rounded to V's type before it meets V,
                         ``l`` floored at 1e-30. The CPU tests hold it
                         against the Pallas kernel in interpret mode, and
                         ``chip_smoke.py`` holds the kernel against it;
  attention_reference    the naive softmax oracle of
                         ``kernels/flash_attention/ref.py`` on (B, H, S, D).

  op                     the registered operator
                         ``repro_torch::flash_attention`` (``torch.library``):
                         its CUDA implementation is ``flash_attention`` (the
                         kernel and its count), its CPU implementation
                         ``flash_attention_plain``, its fake implementation
                         the output's shape, and its FLOP formula
                         ``4·D·B·H·unmasked_pairs``: what
                         ``FakeTensorMode``, ``launch.hlo_analysis`` and
                         ``torch.export`` see, and what an exported program
                         launches;
  attention              the differentiable attention the model calls: a
                         ``torch.autograd.Function`` whose forward is the
                         operator and whose backward is
                         ``attention_backward``, PyTorch ops that recompute
                         the probabilities from q and k per call (the JAX
                         package differentiates its XLA attention and has no
                         backward Pallas kernel).

Masks: ``causal`` drops keys after the query; ``window`` W > 0 drops keys
W or more before it and, without causality, W or more after it. A query
row's position is its index plus ``q_offset`` (0 but for sequence-parallel
attention, where a rank holds the rows ``[q_offset, q_offset + Sq)`` of the
sequence against every key: the reference's ``attention_full`` on the whole
sequence, restricted to those rows). GQA indexes kv head ``h // (H // K)``;
K/V are never repeated.

Head dims: the Pallas kernel takes any D as its full last block dim; the
kernel takes 16..256 in steps of 16 (``HEAD_DIMS``). A D that is not a
power of two runs the instantiation ``kernel_dim(D)`` (hubert's 80 → 128)
over tensor maps whose inner dim is D: the columns past D load as zeros
and are never stored, the scale stays 1/√D, and the MMA work grows by
``kernel_dim(D) / D``.

The kernel is bound by operations: 4·D flops per unmasked (query, key)
pair. ``tile_plan`` states its tile arithmetic (which key tiles each query
tile visits, which of them need the per-element mask, the longest-first
launch order) for the CPU tests; ``csrc/flash_attention.cu`` carries the
same formulas.
"""
from __future__ import annotations

import functools
import math
import threading

from .. import build

NEG_INF = -1e30
HEAD_DIMS = tuple(range(16, 257, 16))
KERNEL_DIMS = (16, 32, 64, 128, 256)    # the kernel's instantiations
BLOCK_QS = (64, 128)    # query rows a CTA of the bf16 kernel
BLOCK_K = 64            # keys a tile of the bf16 kernel

launches = 0            # kernel launches since the last reset
_count_lock = threading.Lock()


def _mask(sq: int, sk: int, causal: bool, window: int, device,
          q_offset: int = 0):
    import torch
    qpos = torch.arange(q_offset, q_offset + sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
        if not causal:
            mask &= kpos - qpos < window
    return mask


def _softcap(s, cap: float):
    import torch
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale=None, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D) in q's
    dtype, dense per (b, h)."""
    import torch
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().view(B, Sq, K, G, D).permute(0, 2, 3, 1, 4) * scale
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]         # (B, K, 1, Sk, D)
    s = _softcap(qf @ kf.transpose(-1, -2), softcap)        # (B, K, G, Sq, Sk)
    s = torch.where(_mask(Sq, Sk, causal, window, q.device, q_offset), s,
                    NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    o = (p.to(v.dtype).float() @ vf) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale=None, q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D) → (B, H, Sq, D): plain
    softmax attention with K/V repeated over the group."""
    import torch
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kh = k.repeat_interleave(G, dim=1).float()
    vh = v.repeat_interleave(G, dim=1).float()
    s = _softcap((q.float() * scale) @ kh.transpose(-1, -2), softcap)
    s = torch.where(_mask(Sq, Sk, causal, window, q.device, q_offset), s,
                    NEG_INF)
    return (torch.softmax(s, dim=-1) @ vh).to(q.dtype)


def kernel_dim(d: int) -> int:
    """The instantiation that runs head dim `d` (``csrc/flash_attention.cu``
    ``kernel_dim``): the least of ``KERNEL_DIMS`` at or above it."""
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in 16..256 in "
                         f"steps of 16, got {d}")
    return next(k for k in KERNEL_DIMS if k >= d)


def _aligned(t):
    """Contiguous, at a 16-byte aligned address (the kernel reads rows with
    16-byte loads; a view may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None, q_offset: int = 0,
                    block_q: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D). CUDA tensors
    → the K8 kernel on the current stream; CPU tensors →
    ``flash_attention_plain``. `block_q` (bf16 only): the query rows a
    CTA takes, one of ``BLOCK_QS``; 0 (what the model passes) leaves it to
    the launcher's choice per shape (``chip_smoke.py`` times both)."""
    import torch
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset)
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, S, H, D) "
                         "attention with H % K == 0")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16/f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel_dim(D)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if block_q and block_q not in BLOCK_QS:
        raise ValueError(f"block_q takes 0 or {BLOCK_QS}, got {block_q}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must lie on one CUDA device")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, K, D, float(scale), float(softcap or 0.0),
            int(bool(causal)), int(window or 0), int(q_offset),
            int(q.dtype == torch.bfloat16))
    if block_q:
        build.launch("flash_attention_bq", q, *args, int(block_q))
    else:
        build.launch("flash_attention", q, *args)
    global launches
    with _count_lock:
        launches += 1
    return out


def attention_backward(q, k, v, do, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, scale=None, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention_plain`` for the cotangent `do`,
    in f32 and rounded once to the inputs' dtype. P is recomputed from q
    and k under the same scale, softcap and mask (nothing of the forward is
    kept but its inputs); GQA's dk/dv sum over the G query heads of a kv
    head."""
    import torch
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs = q.float().reshape(B, Sq, K, G, D).permute(0, 2, 3, 1, 4) * scale
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]         # (B, K, 1, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qs @ kf.transpose(-1, -2)                           # (B, K, G, Sq, Sk)
    t = torch.tanh(s / softcap) if softcap and softcap > 0.0 else None
    if t is not None:
        s = t * softcap
    mask = _mask(Sq, Sk, causal, window, q.device, q_offset)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    dof = do.float().reshape(B, Sq, K, G, D).permute(0, 2, 3, 1, 4)
    dv = (p.transpose(-1, -2) @ dof).sum(dim=2)             # (B, K, Sk, D)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    del p, dp
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = torch.where(mask, ds, 0.0)
    dq = (ds @ kf) * scale                                  # (B, K, G, Sq, D)
    dk = (ds.transpose(-1, -2) @ qs).sum(dim=2)             # (B, K, Sk, D)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


_SCHEMA = ("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
           "int window, float softcap, float? scale, int q_offset) -> Tensor")
_LIBRARIES: list = []


@functools.cache
def op():
    """The registered operator ``repro_torch::flash_attention`` (defined
    at the first call in a process); arguments ``(q, k, v, causal, window,
    softcap, scale, q_offset)``."""
    import torch
    from torch.library import Library, register_fake
    from torch.utils.flop_counter import register_flop_formula

    def kw(causal, window, softcap, scale, q_offset):
        return dict(causal=causal, window=window, softcap=softcap,
                    scale=scale, q_offset=q_offset)

    lib = Library("repro_torch", "FRAGMENT")
    lib.define(_SCHEMA)
    lib.impl("flash_attention",
             lambda q, k, v, *a: flash_attention(q, k, v, **kw(*a)), "CUDA")
    lib.impl("flash_attention",
             lambda q, k, v, *a: flash_attention_plain(q, k, v, **kw(*a)),
             "CPU")
    # the kernel's output is a new contiguous tensor of q's shape and dtype
    register_fake("repro_torch::flash_attention",
                  lambda q, k, v, *a: q.new_empty(q.shape), lib=lib)
    _LIBRARIES.append(lib)
    packet = torch.ops.repro_torch.flash_attention
    register_flop_formula(packet)(flops)
    return packet.default


def flops(q_shape, k_shape, v_shape=None, causal=True, window=0,
          softcap=0.0, scale=None, q_offset=0, **kwargs) -> int:
    """The kernel's FLOPs: 4·D per unmasked (query, key) pair of every
    (b, h) (q·k and p·v, a multiply and an add each)."""
    B, Sq, H, D = q_shape
    return 4 * D * B * H * unmasked_pairs(Sq, k_shape[1], bool(causal),
                                          int(window), int(q_offset))


@functools.cache
def _autograd_fn():
    import torch

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
            ctx.save_for_backward(q, k, v)
            ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                          scale=scale, q_offset=q_offset)
            return op()(q, k, v, causal, window, softcap, scale, q_offset)

        @staticmethod
        def backward(ctx, do):
            q, k, v = ctx.saved_tensors
            return (*attention_backward(q, k, v, do, **ctx.kw),
                    None, None, None, None, None)

    return Attention


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, scale=None, q_offset: int = 0):
    """Differentiable attention on (B, S, H, D): the operator's forward
    (K8 on the card, the plain version on the CPU),
    ``attention_backward`` as its gradient. Where no gradient is recorded
    (serving), the operator alone."""
    import torch
    args = (bool(causal), int(window or 0), float(softcap or 0.0),
            None if scale is None else float(scale), int(q_offset))
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return op()(q, k, v, *args)
    return _autograd_fn().apply(q, k, v, *args)


@functools.lru_cache(maxsize=4096)
def unmasked_pairs(sq: int, sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """(query, key) pairs that the mask keeps for one (b, h): the work the
    kernel's flop count is taken over."""
    total = 0
    for i in range(q_offset, q_offset + sq):
        lo, hi = 0, sk                       # keys [lo, hi) kept
        if causal:
            hi = min(hi, i + 1)
        if window > 0:
            lo = max(lo, i - window + 1)
            if not causal:
                hi = min(hi, i + window)
        total += max(hi - lo, 0)
    return total


def key_range(qt: int, sq: int, sk: int, causal: bool, window: int, bq: int,
              bk: int, q_offset: int = 0) -> tuple:
    """Key tiles [kb, ke) that some row of query tile `qt` (rows
    [qt·bq, min(qt·bq + bq, sq)), at positions `q_offset` further) may
    see; ke <= kb when none."""
    q0 = qt * bq + q_offset
    q_last = min(qt * bq + bq, sq) - 1 + q_offset
    ke = -(-sk // bk)
    if causal:
        ke = min(ke, q_last // bk + 1)
    elif window > 0:
        ke = min(ke, (q_last + window - 1) // bk + 1)
    kb = (q0 - window + 1) // bk if window > 0 and q0 - window + 1 > 0 else 0
    return kb, ke


def tile_masked(q0: int, q_last: int, k0: int, sk: int, causal: bool,
                window: int, bk: int) -> bool:
    """Whether key tile [k0, k0 + bk) needs the per-element mask for query
    rows [q0, q_last]: the ragged tail, the causal diagonal and the
    window's edges do; an interior tile holds no masked pair."""
    if k0 + bk > sk:
        return True
    if causal and k0 + bk - 1 > q0:
        return True
    if window > 0:
        if q_last - k0 >= window:
            return True
        if not causal and k0 + bk - 1 - q0 >= window:
            return True
    return False


def tile_plan(sq: int, sk: int, causal: bool, window: int, bq: int,
              bk: int = BLOCK_K, q_offset: int = 0) -> tuple:
    """The bf16 kernel's tile arithmetic: (tiles, order). ``tiles[qt]`` is
    the list of (key tile, masked) that query tile `qt` visits, in the
    kernel's order; ``order`` the launch order of the query tiles (rank r
    of ``blockIdx.y`` takes ``order[r]``): non-increasing visited tiles,
    the later tile first among equals. With `bq` 128 a CTA loads the key
    tiles of this plan, and each of its two consumer warpgroups computes
    those of its own 64-row tile, ``tile_plan(.., 64, bk)``, with that
    plan's mask flags. `q_offset` shifts every row's position: the key
    tiles past the last row's position are never visited."""
    nq = -(-sq // bq)
    tiles = []
    for qt in range(nq):
        q0 = qt * bq + q_offset
        q_last = min(qt * bq + bq, sq) - 1 + q_offset
        kb, ke = key_range(qt, sq, sk, causal, window, bq, bk, q_offset)
        tiles.append([(kt, tile_masked(q0, q_last, kt * bk, sk, causal,
                                       window, bk))
                      for kt in range(kb, ke)])
    order = sorted(range(nq), key=lambda t: (-len(tiles[t]), -t))
    return tiles, order

