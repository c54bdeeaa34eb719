"""Production meshes and the card's rates (port of
``repro/launch/mesh.py``).

Single pod = 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod  = 2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
pod axis carries data parallelism (and joins the FSDP group for archs that
set ``fsdp_axes=("pod", "data")``).

A dry-run lays the production meshes out in its own process: over a fake
process group of 256 or 512 ranks (``torch.testing._internal.
distributed.fake_pg``: collectives return without moving data, so
``meta`` tensors flow through them), where this process is rank 0.  That
group is not a public torch API.  A process holds one default group, so
one process holds one production mesh.

Defined as functions (never module-level meshes), so importing this
module starts no process group.
"""
from __future__ import annotations

from typing import Optional

import torch

# the card's published rates, used by the roofline (NVIDIA H100 SXM5 80GB,
# "H100 80GB HBM3, 700 W": dense bf16 tensor-core FLOP/s, HBM3 bytes/s,
# and NVLink 4's bytes/s per direction to each peer of an 8-card node)
PEAK_FLOPS_BF16 = 989e12       # per card
HBM_BW = 3.35e12               # bytes/s per card
ICI_BW = 450e9                 # bytes/s per card and direction (NVLink 4)


def init_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake default group of
    ``world_size`` ranks (reused if one of that size exists)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"this process already holds a group of "
                f"{dist.get_world_size()} ranks, not {world_size}: one "
                f"process holds one mesh size")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(shape, axes, device_type: str = "cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return _mesh(shape, axes)


def make_host_mesh():
    """The default group's ranks as a 1-D ('data',) mesh (tests, one
    card); a fake group of 1 rank is started if none exists."""
    import torch.distributed as dist
    if not dist.is_initialized():
        init_fake_world(1)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    return _mesh((dist.get_world_size(),), ("data",), device_type)


class EngineMesh:
    """A 1-D ('shard',) layout of summarization engines: the
    ShardedSummarizer lays one or more engine replicas at each position.

    A position is what a device is in the JAX package's engine mesh.  A
    device may stand at several positions: ``EngineMesh(["cuda:0"] * 4)``
    runs a four-position mesh on one card, and ``EngineMesh(["cpu"] * 8)``
    is the counterpart of JAX's
    ``--xla_force_host_platform_device_count=8`` in the CPU tests.  A
    CUDA device that this host does not have raises here."""

    def __init__(self, devices):
        self.devices = [_present(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("an engine mesh needs at least one position")
        self.mesh_dim_names = ("shard",)
        self.shape = (len(self.devices),)

    def size(self) -> int:
        return len(self.devices)


def _present(device: torch.device) -> torch.device:
    """``device`` with its CUDA index made explicit; raises for a CUDA
    device that is not there."""
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = device.index
    if index is None and n:
        index = torch.cuda.current_device()
    if index is None or not 0 <= index < n:
        raise ValueError(f"mesh device {device} is not present: this host "
                         f"has {n} CUDA devices")
    return torch.device("cuda", index)


def make_engine_mesh(n_devices: Optional[int] = None) -> EngineMesh:
    """The first ``n_devices`` local CUDA devices (all of them by
    default), one position each."""
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else n_devices
    if not 1 <= n <= avail:
        raise ValueError(f"need 1..{avail} devices, got {n}")
    return EngineMesh(torch.device("cuda", i) for i in range(n))


def chips(mesh) -> int:
    return mesh.size()
