"""Production mesh construction.

Counterpart of the reference's ``repro.launch.mesh``.  Functions, not
module-level constants: importing this module touches no device and no
process group.  The production meshes lie over a *fake* process group
(:func:`init_fake_world`, torch's ``FakeProcessGroup``: rank 0 of a world
that exists only as a size, whose collectives move nothing), which is what
the dry-run lowers against; the host mesh lies over the real ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import make_mesh

#: the reference's production meshes: one pod of 16 x 16 chips, and two
#: pods on a leading pure-DP "pod" axis
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def init_fake_world(world_size: int = 512) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0 (a no-op if a process group exists and is that
    large)."""
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"init_fake_world: a process group of "
                               f"{dist.get_world_size()} ranks exists; "
                               f"{world_size} are needed")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips per pod; multi_pod stacks 2 pods (512 chips) on a
    leading pure-DP "pod" axis.  Over the first ranks of the default
    process group (:func:`init_fake_world` for a dry-run)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(device_type: str = "cuda"):
    """Single-host mesh (1, n) over the ranks that exist: one process per
    card (``torchrun``), or this process alone, for which a world of one
    is started (NCCL on the card, gloo on the CPU) if none is."""
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device_type='cpu' for a mesh on the host")
        _init_world_of_one(device_type)
    return make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device_type=device_type)


def _init_world_of_one(device_type: str) -> None:
    """A process group of this process alone: NCCL on the card, gloo on the
    CPU, rendezvous on a free localhost port."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
