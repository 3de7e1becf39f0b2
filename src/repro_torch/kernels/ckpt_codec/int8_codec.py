"""The int8 checkpoint codec on the device: block quantizer (K5) and
dequantizer (K6).

  quantize_blocks    the wrapper of ``csrc/int8_codec.cu``'s quantizer
                     (replaces the Pallas ``quantize_blocks_2d``,
                     ``src/repro/kernels/ckpt_codec/kernel.py``): the
                     snapshot's int8 route quantizes a leaf on the card
                     BEFORE the device→host copy (``core.save_path``);
  dequantize_blocks  the wrapper of its dequantizer (replaces
                     ``dequantize_blocks_2d``): the restore's device decode
                     of an int8 leaf (``core.restore_path``);
  quantize_plain /   their plain PyTorch versions. The CPU tests hold them
  dequantize_plain   against ``core.codec.quantize_int8``/``decode`` and the
                     Pallas kernels in interpret mode, and ``chip_smoke.py``
                     holds the kernels against them on the card.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version — the only reason it ever does. The function, bit for bit, is the
host codec's: per 256-element block (the input zero-padded to a multiple)
``scale = amax / 127`` in f32 (1.0 for an all-zero block) and
``q = clip(round_half_even(x / scale), ±127)``; dequantization is the f32
product ``q · scale``, rounded to nearest even for a bf16 leaf. Both
divisions divide (a tensor divisor: PyTorch multiplies by the reciprocal of
a Python-scalar divisor on the card). The kernels read and write bf16 and
f32; a leaf of another dtype crosses to f32 before K5 and from K6's f32
after it through ``numpy_cast``, on its device, as the host codec casts it.

Launch counts: ``quantize_launches`` (K5), ``dequantize_launches`` (K6).
"""
from __future__ import annotations

import threading

from .. import build

BLOCK = 256             # quantization granule (core.codec.BLOCK)

quantize_launches = 0   # K5 launches since the last reset
dequantize_launches = 0  # K6 launches since the last reset
_count_lock = threading.Lock()


def n_blocks(n: int) -> int:
    return -(-int(n) // BLOCK)


def quantize_plain(x):
    """x: any shape, float dtype → (q int8 (n_blocks·256,), scales f32
    (n_blocks,))."""
    import torch
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    xb = flat.view(-1, BLOCK)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_plain(q, scales, n: int, dtype):
    """(q int8 (n_blocks·256,), scales f32) → the first `n` elements of
    ``q · scale`` in f32, cast to `dtype` (bf16: nearest even)."""
    xb = q.view(-1, BLOCK).float() * scales[:, None]
    return xb.reshape(-1)[:n].to(dtype)


def numpy_cast(t, dtype):
    """`t` converted to `dtype` on its device as numpy's ``astype``
    converts: float targets round to nearest even; an integer target takes
    a float through int64 (truncation) and wraps to its width, as numpy
    does on x86-64 for every value the int8 codec gives back (the type's
    range and one step past it); uint16/uint32 cross as their signed views
    (PyTorch has few kernels for them)."""
    import torch
    if t.dtype == dtype:
        return t
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}
    if t.dtype in signed:
        bits = 8 * t.element_size()
        t = t.view(signed[t.dtype]).to(torch.int64)
        if bits < 64:
            t = t & ((1 << bits) - 1)
    if dtype.is_floating_point or dtype == torch.bool:
        return t.to(dtype)
    if t.dtype.is_floating_point:
        t = t.to(torch.int64)
    return t.to(signed.get(dtype, dtype)).view(dtype)


def _kernel_dtype(dtype):
    """The dtype the kernels read or write for a leaf of `dtype`."""
    import torch
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def quantize_blocks(x):
    """Quantize `x` (any shape and dtype; a dtype other than bf16/f32 is
    first cast to f32). CUDA tensor → K5 on the current stream; CPU tensor
    → ``quantize_plain``."""
    import torch
    x = numpy_cast(x, _kernel_dtype(x.dtype))
    if not x.is_cuda:
        return quantize_plain(x)
    bf16 = int(x.dtype == torch.bfloat16)
    x = x.contiguous()
    n = x.numel()
    nb = n_blocks(n)
    q = torch.empty(nb * BLOCK, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, scales
    build.launch("quantize_blocks", x, x.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), n, bf16)
    global quantize_launches
    with _count_lock:
        quantize_launches += 1
    return q, scales


def dequantize_blocks(q, scales, n: int, dtype):
    """Dequantize to a flat tensor of `n` elements of `dtype` (bf16/f32
    written by the kernel; any other dtype cast from its f32). CUDA tensors
    → K6 on the current stream; CPU tensors → ``dequantize_plain``."""
    import torch
    kdt = _kernel_dtype(dtype)
    if not q.is_cuda:
        return numpy_cast(dequantize_plain(q, scales, n, kdt), dtype)
    bf16 = int(kdt == torch.bfloat16)
    nb = n_blocks(n)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or \
            q.numel() != nb * BLOCK or scales.numel() != nb or \
            not scales.is_cuda:
        raise ValueError(f"dequantize takes int8 q of {nb * BLOCK} and f32 "
                         f"scales of {nb} on the card for n={n}, got "
                         f"{q.dtype} {q.numel()} / {scales.dtype} "
                         f"{scales.numel()} on {scales.device}")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty(n, dtype=kdt, device=q.device)
    if nb == 0:
        return numpy_cast(out, dtype)
    build.launch("dequantize_blocks", q, q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), n, bf16)
    global dequantize_launches
    with _count_lock:
        dequantize_launches += 1
    return numpy_cast(out, dtype)
