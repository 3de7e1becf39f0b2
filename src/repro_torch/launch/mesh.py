"""Device meshes (``src/repro/launch/mesh.py`` on PyTorch): 16×16 single
pod, 2×16×16 multi-pod, and a small mesh over whatever ranks the process
group has.

PyTorch's model is one process per rank: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, its dims named with the reference's axis names
(``"data"``, ``"model"``, ``"pod"``). Rank ``r`` sits at flat position
``r`` of the mesh (``init_device_mesh`` lays ranks out row-major), which
is the position ``jax.make_mesh`` gives device ``r``. Functions, not
module constants: importing this module joins no group.

``AbstractMesh`` is a mesh's shape and axis names with no devices behind
it (``jax.sharding.AbstractMesh``): partition specs, placements and index
ranges are pure functions of it, so a production mesh's layout is
computed without 256 processes. ``make_fake_mesh`` builds a real
``DeviceMesh`` of production size over the ``fake`` backend for one traced
rank (``launch.dryrun``).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

from ..devices import resolve_device


@dataclass(frozen=True)
class AbstractMesh:
    """``shape`` and ``mesh_dim_names`` of a mesh (the two attributes of
    a ``DeviceMesh`` the layout functions read)."""
    shape: tuple
    mesh_dim_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)


def init_distributed(device=None):
    """Join the default process group if this process is not in one yet;
    returns ``(rank, world_size)``. Under torchrun (``WORLD_SIZE`` > 1 in
    the environment) the group forms from its ``env://`` rendezvous; a
    lone process forms a group of one over an in-process store. The
    backend is NCCL for the card (``device`` ``None`` → CUDA, the rank's
    card by ``LOCAL_RANK``) and gloo for ``device="cpu"``."""
    import torch
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()


def _device_mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh
    _, n = init_distributed(device)
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks; the process group has {n}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_fake_mesh(shape, axes, *, rank: int = 0):
    """A ``DeviceMesh`` of `shape` on `axes` over ``torch.distributed``'s
    ``fake`` backend, this process at flat position `rank`: its groups
    have the mesh's sizes and its collectives return at once without
    moving data (``launch.dryrun`` traces one rank of a production mesh
    this way, on fake tensors). The process joins a fake group of that
    size and rank (leaving a fake group of another size first); it must
    not be in a real group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(f"a fake mesh {tuple(shape)} needs a fake "
                             "group; this process is in a "
                             f"{dist.get_backend()} group")
        if (dist.get_world_size(), dist.get_rank()) != (n, rank):
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         fake_rank: int | None = None):
    """(16, 16) on ("data", "model"), or (2, 16, 16) on ("pod", "data",
    "model"): built only under a process group of that size (a process
    in no group joins one first, ``init_distributed``), or, with
    `fake_rank`, over the fake backend at that rank (``make_fake_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake_rank is not None:
        return make_fake_mesh(shape, axes, rank=fake_rank)
    return _device_mesh(shape, axes, device)


def make_host_mesh(shape=None, axes=None, *, device=None):
    """Small mesh over the process group's ranks (tests, examples, the
    launcher): ``(world, 1)`` on ("data", "model") by default. The mesh's
    device type is the card's unless ``device="cpu"``; a process in no
    group joins one first (``init_distributed``)."""
    if shape is None:
        _, n = init_distributed(device)
        shape, axes = (n, 1), ("data", "model")
    return _device_mesh(shape, axes, device)


# The card's hardware model for the dry run's roofline: NVIDIA's published
# figures for the H100 SXM5 80GB at its 700 W limit (spec sheet numbers,
# not measurements; a card set below 700 W runs slower under load). The
# keys are the reference's (its values are TPU v5e constants); NVLink's
# rate per direction stands in ``ici_bw``'s role.
HW = {
    "name": "h100-sxm5-80gb",
    "peak_flops_bf16": 989.4e12,   # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,             # HBM3 bytes/s
    "ici_bw": 450e9,               # NVLink bytes/s per direction
    "chips_per_pod": 256,          # cards of the (16, 16) production mesh
}
