"""Process group and device of each rank.

Counterpart of ``graph_odenet_tpu/parallel/mesh.py``.  The JAX package
runs one program over a device mesh; the port runs one process per card
(SPMD over ``torch.distributed``).  With one mesh axis, the "edge" axis is
the default process group: rank ``r`` owns node block ``r`` and works on
``cuda:r`` of its host.  ``make_mesh`` lays the default group's ranks out
on a mesh of several named axes and gives each axis its process group;
every collective of ``parallel/`` takes the group it runs on (``group=``,
the default group when None).  CUDA tensors travel through NCCL, CPU
tensors through gloo; nothing stages a card's tensor through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from graph_odenet_tpu_torch.utils.device import resolve_device

__all__ = [
    "world", "global_rank", "Mesh", "make_mesh", "device_for", "bootstrap_distributed",
    "check_backend", "check_parts", "all_reduce_sum", "all_reduce_grads",
]


def world(group=None) -> tuple[int, int]:
    """``(size, rank)`` within ``group`` (the default process group when
    None); ``(1, 0)`` without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def global_rank(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``: point-to-point
    ops name their peer by it."""
    return rank if group is None else dist.get_global_rank(group, rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a mesh of processes: the mesh's ``shape`` and
    ``axis_names``, the rank's coordinate along each axis (``coords``) and
    the process group of the ranks that differ from it along that axis
    alone (``groups``; None for an axis that spans the default group, or
    when there is no process group)."""

    shape: tuple
    axis_names: tuple
    coords: tuple
    groups: tuple

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise KeyError(f"no mesh axis {name!r}; axes {self.axis_names}")
        return self.axis_names.index(name)

    def size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def coord(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def group(self, name: str):
        return self.groups[self._axis(name)]


def make_mesh(
    shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data", "edge"),
) -> Mesh:
    """Lay the default group's ranks out on a mesh, in row-major order.

    Counterpart of ``graph_odenet_tpu/parallel/mesh.make_mesh``.  Without a
    ``shape`` every rank is on the last axis (``(1, P)`` for two axes, ``(P,)``
    for one).  ``(P,)`` with ``("edge",)`` is the layout every collective
    takes with ``group=None``.  Every rank must call it with the same
    arguments: each group of the mesh is created on every rank, in the same
    order (``dist.new_subgroups_by_enumeration``).  Without a process group
    the shape must be all ones.
    """
    n, rank = world()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (1, n) if len(axis_names) == 2 else (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes {axis_names}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    ranks = np.arange(n).reshape(shape)
    groups = []
    for a, size in enumerate(shape):
        if size == n:  # the whole default group, in rank order
            groups.append(None)
            continue
        lines = np.moveaxis(ranks, a, -1).reshape(-1, size)
        groups.append(dist.new_subgroups_by_enumeration(lines.tolist())[0])
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return Mesh(shape, axis_names, coords, tuple(groups))


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


def check_backend(t: torch.Tensor, group=None) -> None:
    """Raise unless ``group``'s backend (the default group's when None)
    moves ``t`` where it lies: NCCL for a CUDA tensor, gloo for a CPU
    tensor."""
    backend = dist.get_backend() if group is None else dist.get_backend(group)
    want = "nccl" if t.is_cuda else "gloo"
    if backend != want:
        raise ValueError(
            f"a {t.device.type} tensor needs a {want} process group, not {backend}"
        )


def check_parts(pg, t: torch.Tensor, group=None) -> tuple[int, int]:
    """``world(group)`` for a call on the partitioning ``pg`` with the rank's
    tensor ``t``.  Raises unless ``pg.n_parts`` equals the group's size and,
    over several parts, unless the group's backend moves ``t``."""
    n_parts, me = world(group)
    if pg.n_parts != n_parts:
        where = ("the default process group" if group is None else
                 f"the process group of ranks {dist.get_process_group_ranks(group)}")
        raise ValueError(f"partitioning has {pg.n_parts} parts, but {where} has {n_parts}")
    if n_parts > 1:
        check_backend(t, group)
    return n_parts, me


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group``'s ranks in place (the default group when
    None; nothing with one part); returns ``t``."""
    if world(group)[0] > 1:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_grads(params: torch.nn.Module, group=None) -> None:
    """Sum every parameter gradient over ``group``'s ranks (the default
    group when None; one collective)."""
    if world(group)[0] == 1:
        return
    grads = [p.grad for p in params.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
