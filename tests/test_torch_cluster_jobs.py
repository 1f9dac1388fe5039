"""Job targets run inside the port's LocalCluster child processes.

Kept in an importable module (not the test file) because cluster workers
are fresh interpreters that import jobs by ``"module:function"`` name.
The JAX package's ``tests/cluster_jobs.py`` imports JAX, so the port's
children import these instead. No tests here.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tosem_tpu_torch.parallel.jobs import cluster_mesh
from tosem_tpu_torch.parallel.spmd import P, all_gather, psum, shard_map

# position i holds row i; each column's sum depends on the order it is
# taken in (column 0: ((1e8 + 1) - 1e8) + 3 = 3, but (1e8 + 1) +
# (-1e8 + 3) = 0 in fp32)
FOLD_VALUES = np.ascontiguousarray(np.array(
    [[1e8, 1.0, -1e8, 3.0],
     [0.1, 0.2, 0.3, 0.4],
     [1.0, 1e-8, 1e-8, -1.0],
     [3.0, 1e8, 7.0, -1e8]], np.float32).T)


def allreduce_job(workdir: str):
    """Each position contributes (its process's rank + 1); the replicated
    sum proves the collective crossed the process boundary."""
    mesh = cluster_mesh("dp")
    x = torch.tensor([float(mesh.rank_of(i) + 1) for i in range(mesh.size)])
    total = shard_map(lambda v: psum(v, "dp"), mesh, in_specs=P("dp"),
                      out_specs=P())(x)
    return {"total": float(total[0]), "n_devices": mesh.size}


def fold_order_job(workdir: str):
    """psum and all_gather of FOLD_VALUES' rows, one row a position:
    the bits every rank gets."""
    mesh = cluster_mesh("dp")
    x = torch.from_numpy(FOLD_VALUES[:mesh.size].copy())

    def body(v):
        return psum(v, "dp"), all_gather(v, "dp", tiled=True)
    s, g = shard_map(body, mesh, in_specs=P("dp"), out_specs=P())(x)
    return {"psum_bits": s.view(torch.int32).tolist(),
            "gathered": g.tolist(), "n_devices": mesh.size}


def spin_job(workdir: str, seconds: float = 60.0):
    """Joins, signals readiness, then idles: the kill target."""
    cluster_mesh("dp")
    open(os.path.join(workdir, f"ready_p{dist.get_rank()}"), "w").close()
    t0 = time.time()
    while time.time() - t0 < seconds:
        time.sleep(0.1)
    return {"done": True}


def train_job(workdir: str, steps: int = 5, crash_rank: int = 1,
              crash_at: int = 2):
    """Toy distributed SGD with a checkpoint each step; rank
    ``crash_rank`` hard-exits after step ``crash_at`` the first time the
    job runs in ``workdir``. A relaunched generation restores the last
    checkpoint and finishes."""
    mesh = cluster_mesh("dp")
    rank, n = dist.get_rank(), mesh.size
    ckpt = os.path.join(workdir, "ckpt.json")
    start, w = 0, torch.zeros(4)
    if os.path.exists(ckpt):
        with open(ckpt) as f:
            d = json.load(f)
        start, w = d["step"], torch.tensor(d["w"], dtype=torch.float32)
    # a fixed global batch: position i's row is full of (i + 1)
    x = torch.arange(1.0, n + 1.0)[:, None].repeat(1, 4)

    def body(xs, w_rep):
        g = psum((xs - w_rep[None, :]).sum(0), "dp") / n
        return w_rep + 0.5 * g
    step = shard_map(body, mesh, in_specs=(P("dp"), P()), out_specs=P())
    sentinel = os.path.join(workdir, "crashed_once")
    for s in range(start, steps):
        w = step(x, w)
        if rank == 0:
            tmp = ckpt + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": s + 1, "w": w.tolist()}, f)
            os.replace(tmp, ckpt)
        dist.barrier()
        if (s + 1 == crash_at and rank == crash_rank
                and not os.path.exists(sentinel)):
            open(sentinel, "w").close()
            os._exit(17)
    return {"start_step": start, "final_w": w.tolist()}


# ------------------------------------- DistributedTrainer(backend="nodes")


def cpu_demo_job(**kw):
    """The port's ``demo_job`` on the CPU with one intra-op thread: a
    rank replica process computes its shards' gradients exactly as a
    rank thread of the test process (``torch.set_num_threads(1)``)."""
    from tosem_tpu_torch.train.distributed import demo_job
    torch.set_num_threads(1)
    return demo_job(**kw, device="cpu")


def npz_demo_job(npz: str, **kw):
    """:func:`cpu_demo_job` with the JAX package's ``demo_job`` weights
    and batches, read from ``npz`` (``p/<stage>/<leaf>`` initial
    parameters, ``b<step>/<key>`` batches): a JSON job ref carries a
    path, never the arrays."""
    from tosem_tpu_torch.train.distributed import dp_params_from_numpy
    job = cpu_demo_job(**kw)
    data = dict(np.load(npz))
    tree = {}
    for key, arr in data.items():
        if key.startswith("p/"):
            stage, leaf = key[2:].split("/")
            tree.setdefault(stage, {})[leaf] = arr
    job.init_params = lambda: dp_params_from_numpy(tree, device="cpu")
    job.batch_fn = lambda step: {
        k: torch.from_numpy(data[f"b{step}/{k}"].copy()) for k in ("x", "y")}
    return job
