"""Child-process entry point for :mod:`tosem_tpu_torch.parallel.cluster`.

Counterpart of ``tosem_tpu/parallel/cluster_worker.py``: join the
process group through :func:`multihost_init`'s real branch (gloo: the
cluster hides the cards from its children), import the named job
target, run it, and persist its JSON result for the parent process.
"""
from __future__ import annotations

import importlib
import json
import os
import sys


def main() -> int:
    spec_path = os.environ["TOSEM_CLUSTER_SPEC"]
    with open(spec_path) as f:
        spec = json.load(f)
    for p in spec.get("extra_sys_path", []):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TOSEM_CLUSTER_POSITIONS"] = str(spec["positions"])

    import torch.distributed as dist
    from tosem_tpu_torch.parallel.cluster import COLLECTIVE_TIMEOUT_S
    from tosem_tpu_torch.parallel.mesh import multihost_init
    joined = multihost_init(timeout_s=COLLECTIVE_TIMEOUT_S)
    rank = dist.get_rank()
    world = dist.get_world_size()

    mod_name, fn_name = spec["target"].split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    out = fn(workdir=spec["workdir"], **spec["kwargs"])

    result = {"joined": joined, "rank": rank,
              "n_global_devices": world * int(spec["positions"]),
              "n_local_devices": int(spec["positions"]),
              "backend": dist.get_backend(), "out": out}
    res_path = os.path.join(
        spec["workdir"], f"result_{spec['run']}_p{rank}.json")
    tmp = res_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, res_path)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
