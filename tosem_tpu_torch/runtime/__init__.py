"""Distributed runtime — tasks, actors, shared-memory objects (Ray-lite).

The port's copy of ``tosem_tpu/runtime``, the re-design of Ray 1.1.0's
core (SURVEY §2.1): a single-controller driver schedules tasks/actors onto
worker processes, with a native C++ shared-memory object store for large
payloads. The raylet/GCS/Redis daemons collapse into the driver; what
remains native is the data plane (:mod:`tosem_tpu_torch.native` objstore).
Workers start by spawn once torch is loaded (``runtime._default_start_method``)
and the store's segments are named ``/tosem_torch_rt_*``, apart from the JAX
package's ``/tosem_rt_*``.
"""
from tosem_tpu_torch.runtime.api import (ActorDiedError, DeadlineExceeded,
                                   ObjectLostError,
                                   ObjectRef, PlacementGroup,
                                   PlacementTimeout, TaskCancelledError,
                                   TaskError, WorkerCrashedError,
                                   add_worker, cancel, free, get, init,
                                   is_initialized, kill, placement_group,
                                   put, remote, remove_idle_worker,
                                   remove_placement_group, shutdown,
                                   stats, wait)
from tosem_tpu_torch.runtime.object_store import (MappedHandle, ObjectID,
                                            ObjectStore)

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "free", "kill", "cancel", "stats", "add_worker", "remove_idle_worker",
    "MappedHandle",
    "placement_group", "remove_placement_group", "PlacementGroup",
    "PlacementTimeout", "ObjectRef", "ObjectID", "ObjectStore", "TaskError",
    "WorkerCrashedError", "ObjectLostError", "ActorDiedError",
    "TaskCancelledError",
    "DeadlineExceeded",
]
