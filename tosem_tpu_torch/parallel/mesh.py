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
process group: nccl where every rank of the host gets a card of its own
(``cuda:{local rank}``), gloo in a process that sees no card, and an
error at join time where the host's ranks outnumber its cards.

:func:`process_mesh` is the mesh of a multi-process job: its positions
span the processes (each process owns the positions of its local
devices, in rank order), ``shard_map`` runs the local positions only, and
a collective whose members lie in several processes exchanges their
values over the process group and combines them in global position
order on every rank, so each rank gets the bits a one-process mesh of
the same positions would give.
"""
from __future__ import annotations

import datetime
import itertools
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
    the axis sizes, in ``axis_names`` order. A mesh of a multi-process
    job (:func:`process_mesh`) also holds the rank owning each position
    (``ranks``, same shape) and this process's ``rank``; another
    process's positions have the device ``meta`` here."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 ranks=None, rank: int = 0):
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
        self.ranks = (None if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          arr.shape))
        self.rank = int(rank)
        self._groups: Dict[tuple, object] = {}

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
        """Distinct devices the positions sit on (this process's, in a
        multi-process mesh)."""
        return len({str(d) for d in self.devices.reshape(-1)
                    if d.type != "meta"})

    def rank_of(self, flat: int) -> int:
        return 0 if self.ranks is None else int(self.ranks.reshape(-1)[flat])

    def is_local(self, flat: int) -> bool:
        return self.ranks is None or self.rank_of(flat) == self.rank

    def local_positions(self) -> list:
        return [i for i in range(self.size) if self.is_local(i)]

    def process_group(self, members: Sequence[int]):
        """The process group over the ranks owning ``members`` (flat
        positions), or None when they all live in this process. Made
        when the mesh is (:func:`process_mesh`), one per group of
        members, so meetings of different groups never share one."""
        ranks = sorted({self.rank_of(i) for i in members})
        if len(ranks) < 2:
            return None
        return self._groups[tuple(sorted(members))]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        procs = "" if self.ranks is None else \
            f", rank {self.rank} of {int(self.ranks.max()) + 1}"
        return f"Mesh({self.shape}, devices={devs}{procs})"


def _device(d) -> torch.device:
    if str(d) == "meta":
        return torch.device("meta")
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


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _backend_for(local_rank: int, local_world: int) -> str:
    """nccl where every rank of this host gets a card of its own, gloo in
    a process that sees no card. More ranks than cards raises: two ranks
    on one card would form an nccl group that fails at its first
    collective (NCCL refuses a duplicate GPU)."""
    cards = _cards()
    if cards == 0:
        return "gloo"
    if local_world > cards or local_rank >= cards:
        raise RuntimeError(
            f"{local_world} ranks on this host but {cards} visible "
            f"card(s): an nccl group needs a card for each rank (local "
            f"rank {local_rank} would share one); hide the cards "
            "(CUDA_VISIBLE_DEVICES=) for a gloo group on the CPU")
    return "nccl"


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   timeout_s: float = 300.0) -> bool:
    """Join a multi-process job.

    Reads ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID`` when
    the arguments are absent. Returns True if the process group was
    initialised, False for a single-process run (no address: nothing to
    do). An address without the other two raises, as in the JAX package:
    defaulting to a one-process group would make every process of a
    misconfigured job its own cluster.

    The host's ranks are ``LOCAL_WORLD_SIZE`` (default: every process)
    and this one is ``LOCAL_RANK`` (default: ``PROCESS_ID``). A process
    that sees cards takes ``cuda:{local rank}`` before the group forms
    and joins over nccl; the host's ranks outnumbering its cards raises
    here, before any rank joins. A process that sees no card joins over
    gloo. Every collective of the group gives up after ``timeout_s``, so
    the survivors of a killed rank raise instead of hanging."""
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
    nproc, pid = int(nproc), int(pid)
    local_rank = int(os.environ.get("LOCAL_RANK", pid))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", nproc))
    backend = _backend_for(local_rank, local_world)
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init, world_size=nproc,
                            rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_mesh(spec: MeshSpec, local: Sequence) -> Mesh:
    """The mesh of every process of the job (``torch.distributed`` must be
    initialised, e.g. by :func:`multihost_init`): each rank gives its
    ``local`` positions' devices (every rank the same count; its card,
    ``cuda:{local rank}``, in an nccl group), positions ordered by rank,
    then by local index. Every rank must call it, in the same order as any other
    collective: the process groups of the mesh's meetings are made here."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs an initialised process "
                           "group (multihost_init)")
    local = list(local)
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every rank must give the same number of "
                         f"positions, got {counts}")
    n_local = counts[0]
    sizes = spec.resolve(world * n_local)
    shape = tuple(sizes.values())
    devs = np.empty(world * n_local, dtype=object)
    devs[:] = [local[i % n_local] if i // n_local == rank else "meta"
               for i in range(world * n_local)]
    ranks = np.arange(world * n_local) // n_local
    mesh = Mesh(devs.reshape(shape), tuple(sizes.keys()),
                ranks=ranks.reshape(shape), rank=rank)
    # one process group for each set of positions a meeting can join
    # (every subset of the axes, at every coordinate of the others) that
    # spans processes; new_group is collective, so every rank makes them
    # all, in one order
    names = mesh.axis_names
    made = set()
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            for flat in range(mesh.size):
                c = mesh.coords(flat)
                members = tuple(sorted(
                    j for j in range(mesh.size)
                    if all(mesh.coords(j)[a] == c[a] for a in names
                           if a not in axes)))
                if members in made:
                    continue
                made.add(members)
                procs = sorted({mesh.rank_of(j) for j in members})
                if len(procs) > 1:
                    mesh._groups[members] = dist.new_group(procs)
    return mesh
