"""Public runtime API: ``init / remote / get / put / wait / kill / shutdown``.

The surface of the reference's Python API (``python/ray/worker.py:466`` init,
``:1318`` get, ``:1396`` put, ``:1424`` wait, ``:1680`` remote;
``python/ray/actor.py:269-280`` actor options) on the single-controller
runtime in :mod:`tosem_tpu_torch.runtime.runtime`.

    import tosem_tpu_torch.runtime as rt

    rt.init(num_workers=4)

    @rt.remote
    def f(x):
        return x * 2

    ref = f.remote(21)
    assert rt.get(ref) == 42

    @rt.remote(max_restarts=1)
    class Counter:
        def __init__(self): self.n = 0
        def inc(self): self.n += 1; return self.n

    c = Counter.remote()
    assert rt.get(c.inc.remote()) == 1
"""
from __future__ import annotations

import inspect
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union

from tosem_tpu_torch.runtime import common
from tosem_tpu_torch.runtime.common import (ActorDiedError, DeadlineExceeded,
                                      ObjectLostError, ObjectRef,
                                      PlacementTimeout, TaskCancelledError,
                                      TaskError, WorkerCrashedError)
from tosem_tpu_torch.runtime.runtime import Runtime

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "free", "kill", "cancel", "ObjectRef", "TaskError",
    "WorkerCrashedError", "ObjectLostError", "ActorDiedError",
    "TaskCancelledError", "DeadlineExceeded", "PlacementGroup",
    "PlacementTimeout", "placement_group", "remove_placement_group",
]

_runtime: Optional[Runtime] = None
_lock = threading.Lock()


def init(num_workers: int = 4, store_capacity: int = 256 << 20,
         max_task_retries: int = common.DEFAULT_MAX_TASK_RETRIES,
         start_method: Optional[str] = None,
         memory_monitor: bool = True,
         reconstruction: bool = True) -> Runtime:
    """start_method: None (env default; else spawn once torch is loaded,
    fork before) | "spawn" | "fork".
    memory_monitor: run the RSS/object-store watchdog thread.
    reconstruction: heal lost store objects by re-executing their
    producing task from lineage (False = typed ObjectLostError)."""
    global _runtime
    with _lock:
        if _runtime is None:
            _runtime = Runtime(num_workers=num_workers,
                               store_capacity=store_capacity,
                               max_task_retries=max_task_retries,
                               start_method=start_method,
                               memory_monitor=memory_monitor,
                               reconstruction=reconstruction)
        return _runtime


def is_initialized() -> bool:
    return _runtime is not None


def shutdown() -> None:
    global _runtime
    with _lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def _rt() -> Runtime:
    if _runtime is None:
        raise RuntimeError("runtime not initialized; call rt.init() first")
    return _runtime


class PlacementGroup:
    """Handle to an atomic gang reservation of worker slots.

    Usable as a context manager; on exit the reservation is released and
    actors placed in it are killed (reference semantics of
    ``ray.util.placement_group`` / ``remove_placement_group``)."""

    def __init__(self, pg_id: bytes, n_slots: int, strategy: str):
        self._pg_id = pg_id
        self.n_slots = n_slots
        self.strategy = strategy

    def remove(self) -> None:
        if _runtime is not None:
            _runtime.remove_placement_group(self._pg_id)

    def __enter__(self) -> "PlacementGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.remove()

    def __repr__(self):
        return (f"PlacementGroup(slots={self.n_slots}, "
                f"strategy={self.strategy!r})")


def placement_group(n_slots: int, strategy: str = "pack",
                    timeout: Optional[float] = None) -> PlacementGroup:
    """Atomically reserve ``n_slots`` worker slots (all-or-nothing, FIFO;
    ``timeout=0`` = try-acquire, raising :class:`PlacementTimeout`)."""
    pg_id = _rt().create_placement_group(n_slots, strategy, timeout)
    return PlacementGroup(pg_id, n_slots, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    pg.remove()


class RemoteFunction:
    def __init__(self, fn, max_retries: Optional[int] = None,
                 placement_group: Optional[PlacementGroup] = None,
                 deadline_s: Optional[float] = None):
        self._fn = fn
        self._max_retries = max_retries
        self._pg = placement_group
        self._deadline_s = deadline_s
        self._fn_id = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")

    def remote(self, *args, **kwargs) -> ObjectRef:
        rt = _rt()
        if self._fn_id is None:
            self._fn_id = rt.register_fn(common.dumps(self._fn))
        return rt.submit_task(
            self._fn_id, args, kwargs, max_retries=self._max_retries,
            pg=self._pg._pg_id if self._pg is not None else None,
            deadline_s=self._deadline_s)

    def options(self, max_retries: Optional[int] = None,
                placement_group: Optional[PlacementGroup] = None,
                deadline_s: Optional[float] = None) -> "RemoteFunction":
        rf = RemoteFunction(self._fn, max_retries=max_retries,
                            placement_group=placement_group,
                            deadline_s=deadline_s)
        rf._fn_id = self._fn_id
        return rf

    def __call__(self, *a, **k):
        raise TypeError(f"remote function {self.__name__!r} must be invoked "
                        f"with .remote()")


class ActorMethod:
    def __init__(self, actor_id: bytes, name: str,
                 deadline_s: Optional[float] = None):
        self._actor_id = actor_id
        self._name = name
        self._deadline_s = deadline_s

    def options(self, deadline_s: Optional[float] = None) -> "ActorMethod":
        """Per-call deadline: ``actor.m.options(deadline_s=1.0).remote()``
        resolves to :class:`DeadlineExceeded` if not finished in time."""
        return ActorMethod(self._actor_id, self._name, deadline_s=deadline_s)

    def remote(self, *args, **kwargs) -> ObjectRef:
        return _rt().submit_actor_call(self._actor_id, self._name, args,
                                       kwargs, deadline_s=self._deadline_s)


class ActorHandle:
    def __init__(self, actor_id: bytes, method_names: Sequence[str],
                 deadline_s: Optional[float] = None):
        self._actor_id = actor_id
        self._method_names = set(method_names)
        self._deadline_s = deadline_s    # default for every method call

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(f"actor has no public method {name!r}")
        return ActorMethod(self._actor_id, name,
                           deadline_s=self._deadline_s)


class ActorClass:
    def __init__(self, cls, max_restarts: int = 0,
                 placement_group: Optional[PlacementGroup] = None,
                 deadline_s: Optional[float] = None,
                 restore_state: bool = False,
                 snapshot_every: int = common.ACTOR_SNAPSHOT_EVERY):
        self._cls = cls
        self._max_restarts = max_restarts
        self._pg = placement_group
        self._deadline_s = deadline_s
        self._restore_state = restore_state
        self._snapshot_every = snapshot_every
        self.__name__ = getattr(cls, "__name__", "Actor")

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = _rt()
        blob = common.dumps((self._cls, args, kwargs))
        actor_id = rt.create_actor(
            blob, self._max_restarts,
            pg=self._pg._pg_id if self._pg is not None else None,
            restore_state=self._restore_state,
            snapshot_every=self._snapshot_every)
        methods = [n for n, _ in inspect.getmembers(
            self._cls, predicate=callable) if not n.startswith("_")]
        return ActorHandle(actor_id, methods,
                           deadline_s=self._deadline_s)

    def options(self, max_restarts: Optional[int] = None,
                placement_group: Optional[PlacementGroup] = None,
                deadline_s: Optional[float] = None,
                restore_state: Optional[bool] = None,
                snapshot_every: Optional[int] = None) -> "ActorClass":
        return ActorClass(self._cls,
                          self._max_restarts if max_restarts is None
                          else max_restarts,
                          placement_group=placement_group,
                          deadline_s=(self._deadline_s if deadline_s is None
                                      else deadline_s),
                          restore_state=(self._restore_state
                                         if restore_state is None
                                         else restore_state),
                          snapshot_every=(self._snapshot_every
                                          if snapshot_every is None
                                          else snapshot_every))

    def __call__(self, *a, **k):
        raise TypeError(f"actor class {self.__name__!r} must be instantiated "
                        f"with .remote()")


def remote(*args, **options):
    """Decorator: ``@remote`` or ``@remote(max_retries=…, max_restarts=…,
    deadline_s=…, restore_state=…)``. ``deadline_s`` on an actor class
    becomes the default deadline for every method call (override per
    call with ``actor.m.options(deadline_s=…)``). ``restore_state=True``
    makes restarts restore the actor's STATE (snapshot + method replay),
    not just re-run ``__init__``."""
    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target,
                              max_restarts=options.get("max_restarts", 0),
                              deadline_s=options.get("deadline_s"),
                              restore_state=options.get("restore_state",
                                                        False),
                              snapshot_every=options.get(
                                  "snapshot_every",
                                  common.ACTOR_SNAPSHOT_EVERY))
        return RemoteFunction(target,
                              max_retries=options.get("max_retries"),
                              deadline_s=options.get("deadline_s"))
    if len(args) == 1 and callable(args[0]) and not options:
        return wrap(args[0])
    return wrap


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None, copy: bool = False) -> Any:
    """Resolve refs to values.

    Large (store-resident) objects come back MAPPED IN PLACE by default:
    ndarray buffers are readonly views over the shared-memory segment —
    no heap copy — pinned against eviction/spill until the caller's last
    reference dies. Pass ``copy=True`` for the previous heap-copying
    read (no aliasing, no pin; unpickled arrays are readonly either
    way — out-of-band buffers always were)."""
    rt = _rt()
    if isinstance(refs, ObjectRef):
        return rt.get(refs, timeout=timeout, copy=copy)
    return [rt.get(r, timeout=timeout, copy=copy) for r in refs]


def put(value: Any) -> ObjectRef:
    return _rt().put(value)


def free(refs: Union[ObjectRef, Sequence[ObjectRef]]) -> None:
    """Explicitly release objects now instead of waiting for ref GC
    (``ray.internal.free`` role): the store copy + spill file are
    deleted and the id is forgotten driver-side. Live mappings of the
    object stay valid (deferred free); later ``get`` of the ref raises."""
    _rt().free(refs)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return _rt().wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle) -> None:
    _rt().kill_actor(actor._actor_id)


def cancel(ref: ObjectRef) -> None:
    """Cancel the task producing ``ref``; it resolves to
    :class:`TaskCancelledError`. Best-effort on finished tasks
    (``ray.cancel`` force semantics)."""
    _rt().cancel(ref)


def stats() -> dict:
    """Scheduler load snapshot (pending/inflight/worker counts)."""
    return _rt().stats()


def add_worker() -> int:
    """Grow the worker pool by one; returns the new worker id."""
    return _rt().add_worker()


def remove_idle_worker() -> bool:
    """Retire one idle worker; False if all busy or pool is at 1."""
    return _rt().remove_idle_worker()
