"""Multi-process cluster jobs shipped with the framework.

Counterpart of ``tosem_tpu/parallel/jobs.py``: job targets for
:class:`~tosem_tpu_torch.parallel.cluster.LocalCluster`, importable by
``"module:function"`` name in its child processes. They run over
:func:`cluster_mesh`, the job's mesh of every process's positions.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence


def cluster_mesh(axis: str = "dp"):
    """A 1-D mesh over every position of the job: each process's
    ``TOSEM_CLUSTER_POSITIONS`` CPU positions (default 1), in rank
    order."""
    from tosem_tpu_torch.parallel.mesh import MeshSpec, process_mesh
    n = int(os.environ.get("TOSEM_CLUSTER_POSITIONS", "1"))
    return process_mesh(MeshSpec.of(**{axis: -1}), ["cpu"] * n)


def collective_sweep_job(workdir: str,
                         sizes: Sequence[int] = (1 << 16, 1 << 20),
                         names: Sequence[str] = ("all_reduce",
                                                 "all_gather"),
                         n_iter: int = 10,
                         reps: int = 2) -> Dict:
    """Cross-process collective bandwidth sweep over the job's mesh.

    Every rank runs the same program (``n_iter``/``reps`` are pinned:
    a trip count picked by each rank's own clock would differ across
    ranks and deadlock the collective); rank 0 writes the study-schema
    CSV.
    """
    if n_iter <= 0 or reps <= 0:
        raise ValueError("n_iter and reps must be positive (pinned "
                         "identically on every rank)")
    import torch.distributed as dist

    from tosem_tpu_torch.parallel.collectives import (CollectiveSpec,
                                                      collective_bench)
    from tosem_tpu_torch.utils.results import ResultWriter

    mesh = cluster_mesh("x")
    rows = []
    for name in names:
        for b in sizes:
            spec = CollectiveSpec(name=name, bytes_per_device=int(b))
            row = collective_bench(spec, mesh, n_iter=n_iter, reps=reps)
            row.config = "process_collective_sweep"
            row.extra["n_processes"] = dist.get_world_size()
            rows.append(row)
    if dist.get_rank() == 0:
        w = ResultWriter(os.path.join(workdir, "process_sweep.csv"))
        w.add_many(rows)
        w.flush()
    return {"rows": [{"bench_id": r.bench_id, "bus_bw_gbps": r.value,
                      "time_us": r.extra["time_us"]} for r in rows],
            "n_processes": dist.get_world_size(),
            "n_devices": mesh.size}
