"""Mesh construction and multi-process initialization (counterpart:
``trpo_tpu/parallel/mesh.py``).

The reference is single-controller: one process holds a
``jax.sharding.Mesh`` over every chip and XLA emits the collectives. The
port follows PyTorch's idiom instead: one process per rank, a named
``torch.distributed.device_mesh.DeviceMesh`` with one process group per
axis, and an explicit collective at every batch reduction
(``ops/allreduce.py``). The backend is NCCL for CUDA and gloo for the
CPU, and gloo for CUDA ranks that share a card (more local ranks than
cards: NCCL refuses a second rank on a device).

Where the process group comes from:

* already initialized by the caller (``initialize_distributed``, or a
  test harness with its own store): it is used as it is, whatever its
  backend;
* launched by ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment):
  ``init_process_group`` reads them;
* a mesh of one rank needs no launcher: a one-rank group over an
  in-process store;
* more than one rank with neither: ``UnlaunchedMeshError`` (a
  ``RuntimeError``) naming ``torchrun``.
  It never quietly runs one rank of a larger mesh.

Stated difference: the reference takes the first ``prod(shape)`` devices
when the shape is smaller than the device count; a process mesh must
span its whole world, so a smaller shape raises.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "UnlaunchedMeshError", "check_shape", "make_mesh",
           "initialize_distributed"]


class Mesh:
    """A named mesh of ranks: ``shape`` maps each axis name to its size,
    as the reference's ``Mesh.shape`` does; :meth:`group` is the process
    group of one axis, :meth:`coordinate` this rank's index along it."""

    def __init__(self, device_mesh, axes: Tuple[str, ...],
                 device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, device_mesh.mesh.shape))
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self._coord = dict(zip(axes, device_mesh.get_coordinate()))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return self._coord[axis]

    @property
    def is_writer(self) -> bool:
        """True on rank 0: the one rank that writes rows, checkpoints and
        telemetry."""
        return self.rank == 0

    def barrier(self) -> None:
        """Every rank waits here until all have arrived."""
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


class UnlaunchedMeshError(RuntimeError):
    """A mesh of more than one rank in a process no launcher started."""


def check_shape(shape, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    """``shape`` as ints, with one size per axis name."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} rank mismatch")
    return shape


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _local_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK mod count>`` on CUDA, so two
    ranks on a one-card machine share it."""
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    idx = int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data",),
              device="cuda") -> Mesh:
    """Build a :class:`Mesh` over every rank of the process group.

    ``shape=None`` → a 1-D mesh over the world with the first axis name.
    A multi-axis ``shape`` must multiply out to the world size, e.g.
    ``shape=(2, 2), axes=("data", "seq")``."""
    device = torch.device(device)
    if shape is not None:
        shape = check_shape(shape, axes)
    if not dist.is_initialized():
        total = math.prod(shape) if shape is not None else None
        backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl" and int(os.environ.get(
                "LOCAL_WORLD_SIZE", 1)) > torch.cuda.device_count():
            # NCCL takes one rank per card: ranks sharing a card (two on
            # a one-card machine) reduce over gloo, staged through host
            # memory (ops/allreduce.py)
            backend = "gloo"
        if _launched():
            _local_device(device)
            dist.init_process_group(backend)
        elif total == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            raise UnlaunchedMeshError(
                f"mesh shape {shape} needs {total or 'several'} ranks and "
                "this process was not launched as one of them; run it "
                "under torchrun (torchrun --nproc_per_node N -m "
                "trpo_torch.train ...), or call initialize_distributed "
                "in every rank first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
        axes = tuple(axes[:1])
    total = math.prod(shape)
    if total > world:
        raise ValueError(
            f"mesh shape {shape} needs {total} devices, have {world}")
    if total < world:
        raise ValueError(
            f"mesh shape {shape} covers {total} of {world} ranks; a process "
            "mesh spans its whole world (the reference's sub-sized device "
            "mesh has no process counterpart)")
    from torch.distributed.device_mesh import init_device_mesh

    device = _local_device(device)
    # the mesh's device type only places DTensors, which the port does not
    # use; a gloo world (CPU, or two ranks sharing one card) builds its
    # axis groups as a CPU mesh
    mesh_type = "cpu" if dist.get_backend() == "gloo" else device.type
    device_mesh = init_device_mesh(mesh_type, shape,
                                   mesh_dim_names=tuple(axes))
    return Mesh(device_mesh, tuple(axes), device)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> None:
    """Join a multi-process group: ``init_process_group`` over
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this one
    ``process_id``. With no arguments it reads torchrun's environment.
    ``backend`` defaults to NCCL when CUDA is available, else gloo. Call
    once per process before building a mesh."""
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, **kw)
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)
