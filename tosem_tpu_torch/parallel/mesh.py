"""Device meshes and multi-host bring-up.

Counterpart of ``tosem_tpu/parallel/mesh.py``. A :class:`Mesh` is an
array of **positions** under named axes (``dp``, ``tp``, ``sp``, ...),
each position with a ``torch.device``. Several positions may sit on one
device: eight positions on ``cpu`` are what the JAX package's tests get
from ``--xla_force_host_platform_device_count=8``, and four positions on
``cuda:0`` are a sharded replica's pinned virtual devices on one card.
:mod:`tosem_tpu_torch.parallel.spmd` runs a body once per position, each
in its own thread on its position's device.

With no ``devices``, :func:`make_mesh` and :func:`default_mesh` take
every card (``torch.cuda.device_count()``) and raise when there is none:
a mesh never moves to the CPU on its own. ``multihost_init`` keeps the
JAX package's environment contract and joins a ``torch.distributed``
process group (gloo for CPU processes, nccl for a process that owns a
card).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tosem_tpu_torch.ops.common import resolve_device


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes and their sizes; -1 means 'absorb the remaining
    positions'.

    Conventional axis names used across the framework:
      dp — data parallel        tp — tensor parallel
      pp — pipeline parallel    sp — sequence/context parallel
      ep — expert parallel
    """
    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, **axes: int) -> "MeshSpec":
        return cls(tuple(axes.items()))

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = 1
        for k, v in sizes.items():
            if v != -1:
                fixed *= v
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices, have {n_devices}")
        return sizes


class Mesh:
    """Positions under named axes: ``devices`` is an object array of
    ``torch.device`` (one per position, repeats allowed) whose shape is
    the axis sizes, in ``axis_names`` order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"devices of shape {arr.shape} under axes "
                             f"{names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, flat: int) -> Dict[str, int]:
        """Axis name -> index of the position ``flat`` (row-major)."""
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(
                            flat, self.devices.shape))))

    def device_of(self, flat: int) -> torch.device:
        return self.devices.reshape(-1)[flat]

    def cards(self) -> int:
        """Distinct devices the positions sit on."""
        return len({str(d) for d in self.devices.reshape(-1)})

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, devices={devs})"


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _all_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a mesh with no devices takes every card, and "
            "torch.cuda.device_count() is 0: pass devices= (e.g. "
            "['cpu'] * 8 for eight positions on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(spec: MeshSpec, devices: Optional[Sequence] = None) -> Mesh:
    devices = _all_cards() if devices is None else list(devices)
    sizes = spec.resolve(len(devices))
    shape = tuple(sizes.values())
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr[:int(np.prod(shape))].reshape(shape),
                tuple(sizes.keys()))


def default_mesh(axis_name: str = "dp",
                 devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every card (or the given positions' devices)."""
    devices = _all_cards() if devices is None else list(devices)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, (axis_name,))


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh: how :func:`~tosem_tpu_torch.parallel.
    spmd.split` cuts a tensor among the positions."""
    mesh: Mesh
    spec: tuple


def replicated(mesh: Mesh) -> NamedSharding:
    from tosem_tpu_torch.parallel.spmd import P
    return NamedSharding(mesh, P())


def sharded(mesh: Mesh, *spec) -> NamedSharding:
    from tosem_tpu_torch.parallel.spmd import P
    return NamedSharding(mesh, P(*spec))


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Join a multi-process job.

    Reads ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID`` when
    the arguments are absent. Returns True if the process group was
    initialised, False for a single-process run (no address: nothing to
    do). An address without the other two raises, as in the JAX package:
    defaulting to a one-process group would make every process of a
    misconfigured job its own cluster. The group's backend is nccl in a
    process that sees a card and gloo otherwise."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return False
    nproc = num_processes if num_processes is not None else os.environ.get(
        "NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get(
        "PROCESS_ID")
    if nproc is None or pid is None:
        raise ValueError(
            "COORDINATOR_ADDRESS set but NUM_PROCESSES/PROCESS_ID missing")
    import torch.distributed as dist
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(nproc), rank=int(pid))
    return True
