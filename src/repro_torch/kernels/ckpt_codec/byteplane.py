"""Device-side byteplane transform — checkpoint codec front-end (forward)
and restore-side decode (inverse).

The lossless byte-plane transpose + per-plane delta of ``core.codec``
(``byteplane_forward`` is the numpy oracle, re-exported here), run on the
device ahead of the CDC gear scan and the plane entropy stage in the fused
save dispatch (``core.cdc_scan.GearScanner.scan_transform_encode_async``).

  forward_planes  the wrapper of the hand-written CUDA kernel
                  ``csrc/byteplane_fwd.cu`` (K2; replaces the Pallas
                  ``forward_planes_2d``). A CUDA tensor launches the kernel
                  (or raises); a CPU tensor takes the plain version — the
                  only reason it ever does;
  forward_plain   the plain PyTorch version of the same function, on any
                  device. The CPU tests hold it against the JAX package,
                  and ``chip_smoke.py`` holds the kernel against it.

  inverse_planes  the wrapper of ``csrc/byteplane_inv.cu`` (K4; replaces
                  the Pallas ``inverse_planes_2d``): the restore's device
                  decode of a byteplane-coded leaf (``core.restore_path``).
                  Same dispatch rule as ``forward_planes``;
  inverse_plain   its plain PyTorch version (per-plane uint8 cumsum, which
                  wraps mod 256 as the oracle's does).

Launch counts: ``launches`` (K2), ``inverse_launches`` (K4).
"""
from __future__ import annotations

import threading

from ...core.codec import byteplane_forward, byteplane_inverse  # noqa: F401
# ^ oracle re-export
from .. import build

KERNEL_ITEMSIZES = (1, 2, 4, 8)

# K4's tiles and scratch (csrc/byteplane_inv.cu: TILE_ELEMS, STATUS_BYTES,
# COUNTER_BYTES): elements of each plane in a tile, by itemsize; one status
# word per (tile, group of four planes), then the tile counter
INV_TILE = (0, 32768, 16384, 8192, 8192, 4096, 4096, 4096, 4096)
INV_STATUS_BYTES = 8
INV_COUNTER_BYTES = 4

launches = 0            # K2 launches since the last reset
inverse_launches = 0    # K4 launches since the last reset
_count_lock = threading.Lock()


def forward_plain(u8, itemsize: int):
    """Plain PyTorch forward transform of a flat uint8 tensor: plane-major
    delta bytes, ragged tail appended unchanged (uint8 arithmetic wraps
    mod 256, as the oracle's does)."""
    import torch
    n = u8.shape[0]
    k = int(itemsize)
    if k <= 0:
        raise ValueError(f"itemsize must be positive, got {itemsize}")
    ne = n // k
    if ne == 0:
        return u8.clone()
    x = u8[:ne * k].view(ne, k)
    d = torch.empty_like(x)
    d[0] = x[0]
    torch.sub(x[1:], x[:-1], out=d[1:])
    return torch.cat([d.t().reshape(-1), u8[ne * k:]])


def forward_planes(u8, itemsize: int):
    """Forward transform of a flat contiguous uint8 tensor. CUDA tensor →
    the K2 kernel on the current stream; CPU tensor → ``forward_plain``."""
    import torch
    if u8.dtype != torch.uint8 or u8.dim() != 1:
        raise TypeError(f"expected a 1-D uint8 tensor, got {u8.dtype} "
                        f"{tuple(u8.shape)}")
    if not u8.is_cuda:
        return forward_plain(u8, itemsize)
    k = int(itemsize)
    if k not in KERNEL_ITEMSIZES:
        raise ValueError(f"byteplane kernel takes itemsize in "
                         f"{KERNEL_ITEMSIZES}, got {itemsize}")
    if not u8.is_contiguous() or u8.data_ptr() % k:
        raise ValueError("byteplane kernel needs a contiguous input "
                         "aligned to its itemsize")
    n = u8.shape[0]
    out = torch.empty_like(u8)
    if n == 0:
        return out
    build.launch("byteplane_fwd", u8, u8.data_ptr(), out.data_ptr(), n, k)
    global launches
    with _count_lock:
        launches += 1
    return out



def inverse_plain(u8, itemsize: int):
    """Plain PyTorch inverse transform of a flat uint8 tensor: per-plane
    cumulative sum mod 256, transposed back to element order, ragged tail
    appended unchanged."""
    import torch
    n = u8.shape[0]
    k = int(itemsize)
    if k <= 0:
        raise ValueError(f"itemsize must be positive, got {itemsize}")
    ne = n // k
    if ne == 0:
        return u8.clone()
    x = torch.cumsum(u8[:ne * k].view(k, ne), dim=1, dtype=torch.uint8)
    return torch.cat([x.t().reshape(-1), u8[ne * k:]])


def inverse_scratch_bytes(n: int, itemsize: int) -> int:
    """Bytes of scratch K4 takes for an n-byte stream of `itemsize`-byte
    elements: a status word per (tile, group of four planes) and the tile
    counter (the kernel zeroes them itself)."""
    k = int(itemsize)
    ntiles = -(-(n // k) // INV_TILE[k])
    return INV_STATUS_BYTES * ntiles * (-(-k // 4)) + INV_COUNTER_BYTES


def inverse_planes(u8, itemsize: int):
    """Inverse transform of a flat contiguous uint8 tensor. CUDA tensor →
    the K4 kernel on the current stream; CPU tensor → ``inverse_plain``."""
    import torch
    if u8.dtype != torch.uint8 or u8.dim() != 1:
        raise TypeError(f"expected a 1-D uint8 tensor, got {u8.dtype} "
                        f"{tuple(u8.shape)}")
    if not u8.is_cuda:
        return inverse_plain(u8, itemsize)
    k = int(itemsize)
    if not 1 <= k <= 8:
        raise ValueError(f"byteplane inverse kernel takes itemsize 1..8, "
                         f"got {itemsize}")
    u8 = u8.contiguous()
    n = u8.shape[0]
    out = torch.empty_like(u8)
    if n == 0:
        return out
    need = inverse_scratch_bytes(n, k)
    scratch = torch.empty(need, dtype=torch.uint8, device=u8.device)
    build.launch("byteplane_inv", u8, u8.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), n, k, need)
    global inverse_launches
    with _count_lock:
        inverse_launches += 1
    return out
