"""Process group and device of each rank.

Counterpart of ``graph_odenet_tpu/parallel/mesh.py``.  The JAX package
runs one program over a device mesh; the port runs one process per card
(SPMD over ``torch.distributed``), and the "edge" axis of the mesh is the
default process group.  Rank ``r`` owns node block ``r`` and works on ``cuda:r`` of
its host.  CUDA tensors travel through NCCL, CPU tensors through gloo;
nothing stages a card's tensor through the host.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from graph_odenet_tpu_torch.utils.device import resolve_device

__all__ = ["world", "device_for", "bootstrap_distributed", "check_backend"]


def world() -> tuple[int, int]:
    """``(n_parts, rank)`` of the default process group; ``(1, 0)`` without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def device_for(device, rank: int) -> torch.device:
    """The rank's device: ``"cuda"`` maps rank ``r`` to ``cuda:r`` of its host.

    Raises without a card (``utils.device.resolve_device``).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def bootstrap_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    device="cuda",
    timeout: float = 300.0,
) -> tuple[int, int]:
    """Join the process group of a multi-process run; returns ``(n_parts, rank)``.

    A no-op for one process (``world_size`` None or 1).  ``init_method`` is
    ``"env://"`` under ``torchrun`` or ``tcp://host:port``; the backend is
    NCCL for ``device="cuda"`` (and the rank's card becomes the current
    device) and gloo for ``device="cpu"``.
    """
    if world_size is not None and world_size > 1:
        dev = device_for(device, rank)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return world()


def check_backend(t: torch.Tensor) -> None:
    """Raise unless the process group's backend moves ``t`` where it lies:
    NCCL for a CUDA tensor, gloo for a CPU tensor."""
    backend = dist.get_backend()
    want = "nccl" if t.is_cuda else "gloo"
    if backend != want:
        raise ValueError(
            f"a {t.device.type} tensor needs a {want} process group, not {backend}"
        )
