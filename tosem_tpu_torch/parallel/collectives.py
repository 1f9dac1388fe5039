"""Mesh collectives and the NCCL-style bandwidth sweep.

Counterpart of ``tosem_tpu/parallel/collectives.py`` (north-star config
3, the all-reduce bandwidth sweep from 1 KB to 256 MB a position). Each
collective is a :func:`~tosem_tpu_torch.parallel.spmd.shard_map` program
over one mesh axis, global tensor in and global tensor out, and results
are reported as nccl-tests' **bus bandwidth**.

Bus-bandwidth conversion per collective (n = positions on the axis, B =
bytes of a position's buffer, t = seconds; algBw = B/t unless noted),
nccl-tests' PERFORMANCE.md definitions, as in the JAX package:

  all_reduce      busBw = (B/t) * 2(n-1)/n
  all_gather      busBw = (B_total/t) * (n-1)/n  with B_total = n*B_shard
  reduce_scatter  busBw = (B_total/t) * (n-1)/n
  all_to_all      busBw = (B/t) * (n-1)/n
  broadcast       busBw = B/t
  ppermute (ring) busBw = B/t

A row says how many positions and how many cards it ran on. With every
position on one card the "bus" is that card's memory: the time covers
cutting the global input into the positions' owned blocks, the
collective's copies and adds, and assembling the output, all in device
memory, and says nothing about NCCL or a link.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch

from tosem_tpu_torch.parallel.mesh import Mesh
from tosem_tpu_torch.parallel.spmd import (P, all_gather, all_to_all,
                                           pbroadcast, ppermute, psum,
                                           psum_scatter, shard_map)
from tosem_tpu_torch.utils.results import ResultRow
from tosem_tpu_torch.utils.timing import DeviceLoopBench


# ---------------------------------------------------------------------------
# collective ops (shard_map programs; global-view in, global-view out)


def all_reduce(mesh: Mesh, axis: str) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """x sharded on ``axis`` (leading dim = the positions' buffers) ->
    their sum, replicated (``ncclAllReduce``)."""
    return shard_map(lambda x: psum(x, axis), mesh, in_specs=P(axis),
                     out_specs=P())


def all_gather_op(mesh: Mesh, axis: str) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """Shards on ``axis`` -> the full array, replicated
    (``ncclAllGather``)."""
    return shard_map(lambda x: all_gather(x, axis, tiled=True), mesh,
                     in_specs=P(axis), out_specs=P())


def reduce_scatter_op(mesh: Mesh, axis: str) -> Callable[[torch.Tensor],
                                                         torch.Tensor]:
    """Each position's buffer (its shard on ``axis``) summed, each keeping
    its block of the sum (``ncclReduceScatter``)."""
    return shard_map(lambda x: psum_scatter(x, axis, tiled=True), mesh,
                     in_specs=P(axis), out_specs=P(axis))


def ring_permute(mesh: Mesh, axis: str) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """Neighbour shift around the ring, position i to i + 1: the building
    block of ring attention."""
    n = mesh.shape[axis]
    perm = [(i, (i + 1) % n) for i in range(n)]
    return shard_map(lambda x: ppermute(x, axis, perm), mesh,
                     in_specs=P(axis), out_specs=P(axis))


def all_to_all_op(mesh: Mesh, axis: str) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """Each position's rows cut into n blocks, block j to position j,
    received blocks concatenated back along the rows (``ncclAllToAll``,
    the Ulysses primitive)."""
    return shard_map(lambda x: all_to_all(x, axis, 0, 0, tiled=True), mesh,
                     in_specs=P(axis), out_specs=P(axis))


def broadcast(mesh: Mesh, axis: str, root: int = 0
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Position ``root``'s buffer to every position (``ncclBroadcast``)."""
    n = mesh.shape[axis]
    op = shard_map(lambda x: pbroadcast(x, axis, root), mesh,
                   in_specs=P(axis), out_specs=P())

    def f(x):
        if x.shape[0] % n:
            raise ValueError(f"broadcast input dim0 {x.shape[0]} not "
                             f"divisible by axis size {n}")
        return op(x)
    return f


# ---------------------------------------------------------------------------
# bandwidth sweep

_COLLECTIVES = {
    "all_reduce": all_reduce,
    "all_gather": all_gather_op,
    "reduce_scatter": reduce_scatter_op,
    "ring_permute": ring_permute,
    "all_to_all": all_to_all_op,
    "broadcast": broadcast,
}


def bus_bandwidth_factor(name: str, n: int) -> float:
    """Multiplier converting algorithm bandwidth to bus bandwidth."""
    if n <= 1:
        return 1.0
    if name == "all_reduce":
        return 2.0 * (n - 1) / n
    if name in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0  # broadcast, ring_permute


@dataclass(frozen=True)
class CollectiveSpec:
    name: str                 # key into _COLLECTIVES
    bytes_per_device: int     # a position's buffer size
    dtype: str = "float32"
    axis: str = "x"

    @property
    def bench_id(self) -> str:
        return f"{self.name}_{self.bytes_per_device}B_{self.dtype}"


def _make_global_input(spec: CollectiveSpec, mesh: Mesh) -> torch.Tensor:
    """Ones of the JAX package's global shape: 2-D, 128 columns where the
    buffer allows, rows a multiple of n (reduce_scatter) — on the device
    of this process's first position."""
    n = mesh.shape[spec.axis]
    dt = getattr(torch, spec.dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    per_dev = max(spec.bytes_per_device // itemsize, n)
    cols = 128 if per_dev % 128 == 0 and n <= 128 else n
    rows = max(per_dev // cols, 1)
    rows = ((rows + n - 1) // n) * n
    return torch.ones((n * rows, cols), dtype=dt,
                      device=mesh.device_of(mesh.local_positions()[0]))


def collective_bench(spec: CollectiveSpec, mesh: Mesh, *,
                     n_iter: int = 0, reps: int = 3) -> ResultRow:
    n = mesh.shape[spec.axis]
    if spec.name not in _COLLECTIVES:
        raise ValueError(f"unknown collective {spec.name!r}; "
                         f"one of {sorted(_COLLECTIVES)}")
    op = _COLLECTIVES[spec.name](mesh, spec.axis)
    x = _make_global_input(spec, mesh)
    sec = DeviceLoopBench(op=op, args=(x,), perturb=0).time(n_iter=n_iter,
                                                            reps=reps)
    nbytes = x.numel() * x.element_size()
    # nccl-tests' size convention: all_gather reports the gathered bytes,
    # everything else a position's buffer
    actual_bytes = nbytes if spec.name == "all_gather" else nbytes // n
    alg_bw = actual_bytes / sec
    bus_bw = alg_bw * bus_bandwidth_factor(spec.name, n)
    cards = mesh.cards()
    dev = mesh.device_of(mesh.local_positions()[0])
    extra = {"collective": spec.name, "bytes": actual_bytes,
             "alg_bw_gbps": alg_bw / 1e9, "time_us": sec * 1e6,
             "dtype": spec.dtype, "positions": n, "cards": cards}
    if cards == 1 and dev.type == "cuda":
        extra["bus"] = ("one card's memory: every position on "
                        f"{torch.cuda.get_device_name(dev)}; no link, "
                        "no NCCL")
    return ResultRow(
        project="parallel", config="collective_sweep",
        bench_id=f"{spec.name}_{actual_bytes}B_{spec.dtype}",
        metric="bus_bw_gbps", value=bus_bw / 1e9, unit="GB/s",
        device="gpu" if dev.type == "cuda" else "cpu", n_devices=n,
        extra=extra)


def _sweep_sizes(lo: int = 1024, hi: int = 1 << 30) -> List[int]:
    sizes = []
    b = lo
    while b <= hi:
        sizes.append(b)
        b *= 4
    return sizes


DEFAULT_COLLECTIVE_SWEEP = [
    CollectiveSpec(name, size)
    for name in ("all_reduce", "all_gather", "reduce_scatter",
                 "ring_permute", "all_to_all", "broadcast")
    for size in _sweep_sizes(1024, 1 << 28)  # 1KB -> 256MB a position
]
