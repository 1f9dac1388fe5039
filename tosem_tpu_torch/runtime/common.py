"""Shared types for the distributed runtime (driver ↔ worker protocol).

The wire protocol plays the role of the reference's task submission path
(``core_worker.cc:1292`` SubmitTask → ``direct_task_transport.cc:289`` worker
lease → push-to-worker): here the driver IS the scheduler (single-controller,
as fits a single-controller program), workers are leased processes on pipes, and the plasma
analog (:mod:`tosem_tpu_torch.runtime.object_store`) carries anything over
``INLINE_THRESHOLD`` bytes — the same >100KB spill rule as the reference's
``CoreWorker::Put`` (``core_worker.cc:849``).
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import cloudpickle

from tosem_tpu_torch.runtime.object_store import ObjectID, fast_token  # noqa: F401
# fast_token is re-exported: the runtime mints task/actor/fn/pg ids from it
# (os.urandom per id was the single biggest per-call tax on some kernels)

# Objects larger than this go to the shared-memory store instead of riding
# the control pipe (reference: core_worker.cc:849 plasma threshold).
INLINE_THRESHOLD = 100 * 1024

HEARTBEAT_INTERVAL_S = 0.2  # scheduler liveness-check cadence
MAX_INFLIGHT_PER_WORKER = 16  # pipeline depth per stateless worker
STEAL_AFTER_S = 1.0  # reclaim queued tasks from a worker stalled this long
DEFAULT_MAX_TASK_RETRIES = 3  # reference: ray default task max_retries

# lineage-based reconstruction bounds (the reconstruction_policy knobs):
# a lost object may be re-derived by re-executing its producing task up
# to MAX_RECONSTRUCTION_ATTEMPTS times, chasing missing ancestors up to
# MAX_RECONSTRUCTION_DEPTH levels; the driver remembers at most
# MAX_LINEAGE_ENTRIES completed task specs (oldest evicted first — an
# evicted entry's object is no longer reconstructible)
MAX_RECONSTRUCTION_ATTEMPTS = 3
MAX_RECONSTRUCTION_DEPTH = 8
MAX_LINEAGE_ENTRIES = 4096
# completed-task-id memory for at-least-once dedup: a late duplicate
# "done" (steal race: stolen AND finished by the original worker) must
# be dropped, not re-applied — bounded FIFO like lineage
MAX_COMPLETED_TIDS = 4096
# actor state recovery: snapshot the actor every N calls; between
# snapshots at most N method calls are kept for replay-on-restart
ACTOR_SNAPSHOT_EVERY = 8


class RuntimeError_(Exception):
    pass


class TaskError(RuntimeError_):
    """Remote function raised; carries the remote traceback text."""

    def __init__(self, cause: BaseException, remote_tb: str):
        super().__init__(f"{type(cause).__name__}: {cause}\n"
                         f"--- remote traceback ---\n{remote_tb}")
        self.cause = cause
        self.remote_tb = remote_tb


class WorkerCrashedError(RuntimeError_):
    """The worker executing the task died (after exhausting retries)."""


class ObjectLostError(WorkerCrashedError):
    """An object was lost from the store and could NOT be reconstructed
    (no lineage — e.g. a ``put`` or actor-call result — or the
    reconstruction attempt/depth budget was exhausted). Subclasses
    :class:`WorkerCrashedError` so pre-recovery callers keep working."""


class DependencyLostError(RuntimeError_):
    """A worker found a task dependency missing from the object store.

    Raised worker-side and shipped to the driver, which — when
    reconstruction is enabled and the dependency has lineage —
    re-derives the dependency and requeues the task (free of retry
    charge) instead of surfacing a :class:`TaskError`.
    """

    def __init__(self, key_hex: str):
        super().__init__(f"dependency {key_hex[:12]} missing from store")
        self.key_hex = key_hex


class ActorDiedError(RuntimeError_):
    """The actor's process died (and restarts, if any, were exhausted)."""


class PlacementTimeout(RuntimeError_):
    """create_placement_group could not reserve its slots in time."""


class TaskCancelledError(RuntimeError_):
    """The task was cancelled via ``rt.cancel`` (``ray.cancel`` semantics)."""


class DeadlineExceeded(RuntimeError_):
    """The task's per-task deadline elapsed before it produced a result.

    Fail-fast semantics: the result ref resolves to this error as soon
    as the scheduler notices the deadline (within one heartbeat tick);
    the worker is NOT killed — a late completion is discarded, so a
    deadline bounds the *caller's* wait, not the worker's CPU time."""


class ObjectRef:
    """Future for a task result or put object (the ``ray.ObjectRef`` shape)."""

    __slots__ = ("oid", "__weakref__")  # weakref: driver-side table GC

    def __init__(self, oid: ObjectID):
        self.oid = oid

    def hex(self) -> str:
        return self.oid.hex()

    def __hash__(self):
        return hash(self.oid)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.oid == other.oid

    def __repr__(self):
        return f"ObjectRef({self.hex()[:12]}…)"


@dataclass
class StoreRef:
    """Marker inside serialized args: fetch this id from the shm store."""
    binary: bytes


@dataclass
class InlineParts:
    """Marker inside serialized args: an inline object forwarded in its
    already-serialized ``(kind, parts)`` form (see :func:`dumps_parts`).

    Zero-copy arg forwarding: the driver ships the parts it already holds
    in its inline table instead of ``loads_parts`` + re-``dumps`` per
    dispatch; the worker runs ``loads_parts`` once, which copies — so the
    reconstructed value never aliases driver state."""
    kind: int
    parts: list


def dumps(value: Any) -> bytes:
    """Serialize a value (cloudpickle: closures, lambdas, local classes)."""
    return cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def dumps_args(value: Any) -> bytes:
    """Serialize an (args, kwargs) payload on the dispatch hot path.

    Stdlib pickle is C-speed; cloudpickle pays Python-level dispatch per
    call. Args are data in the overwhelmingly common case, so try pickle
    first and fall back to cloudpickle for closures/lambdas. A stdlib
    success that references ``__main__`` globals is ALSO demoted to
    cloudpickle: stdlib pickles those by reference, which a spawn-mode
    worker (fresh ``__main__``) could not resolve — cloudpickle pickles
    them by value, preserving the old behavior.
    """
    try:
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:
        return cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    if b"__main__" in blob:
        return cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    return blob


def loads(blob: bytes) -> Any:
    return pickle.loads(blob)


# --- large-value path: pickle protocol 5 with out-of-band buffers ----------
# Raw bytes-likes skip pickling entirely; numpy arrays / anything exposing
# PickleBuffer keeps its payload out of the pickle stream. Combined with the
# store's reserve/seal API this makes a large put a single memcpy into shm.

import struct as _struct

_RAW = 0    # parts = [payload]
_P5 = 1     # parts = [pickle5 header, buffer0, buffer1, ...]


def dumps_parts(value: Any):
    """→ (kind, [buffer-like parts]); no concatenation (no extra copies).

    RAW covers ``bytes`` (type-preserving) and ``memoryview`` (unpicklable
    otherwise; comes back as bytes); bytearray/ndarray ride protocol-5
    out-of-band buffers with their types intact.
    """
    if isinstance(value, (bytes, memoryview)):
        return _RAW, [value]
    buffers = []
    header = cloudpickle.dumps(value, protocol=5,
                               buffer_callback=buffers.append)
    return _P5, [header] + [b.raw() for b in buffers]


def loads_parts(kind: int, parts, copy: bool = True) -> Any:
    """Inverse of :func:`dumps_parts`.

    ``copy=True`` (default) copies every buffer onto the heap — the
    result never aliases the source parts. ``copy=False`` hands the
    buffers to pickle AS-IS (zero-copy): callers pass READONLY
    memoryviews over PINNED shm pages (see ``store_get_value``'s mapped
    path), so unpickled ndarrays alias the segment with
    ``writeable=False`` and in-place mutation raises. RAW payloads are
    ``bytes`` either way (the type contract)."""
    if kind == _RAW:
        return bytes(parts[0])
    if copy:
        return pickle.loads(bytes(parts[0]),
                            buffers=[bytes(p) for p in parts[1:]])
    return pickle.loads(bytes(parts[0]), buffers=parts[1:])


def store_put_parts(store, oid, kind: int, parts) -> None:
    """Write pre-split parts into the shm store in the layout
    ``[u32 kind][u32 n][u64 sizes…][part0][part1]…``."""
    views = [p if isinstance(p, memoryview) else memoryview(p) for p in parts]
    meta = _struct.pack(f"<II{len(views)}Q", kind, len(views),
                        *[v.nbytes for v in views])
    store.put_parts(oid, [meta] + views)


def store_put_value(store, oid, value) -> None:
    kind, parts = dumps_parts(value)
    store_put_parts(store, oid, kind, parts)


def robust_store_put_parts(store, oid, kind, parts) -> None:
    """Idempotent store write for retried tasks (deterministic result ids).

    EXISTS may mean (a) a finished earlier attempt — success; (b) an orphaned
    mid-write slot from a crashed attempt — reclaim and rewrite; (c) a live
    concurrent duplicate mid-write — poll until it seals (duplicates write
    identical content, so waiting is correct).
    """
    from tosem_tpu_torch.runtime.object_store import ObjectStoreError
    import time as _time
    # generous deadline scaled to object size: a live duplicate writer may
    # legitimately need seconds to memcpy a huge object before sealing
    nbytes = parts_nbytes(parts)
    deadline = _time.monotonic() + 10.0 + nbytes / (100 << 20)
    while True:
        try:
            store_put_parts(store, oid, kind, parts)
            return
        except ObjectStoreError as e:
            if e.code == -3:
                # store full with nothing evictable: every resident byte
                # is pinned by live mappings — wait-with-deadline for
                # pins to drop instead of failing the task outright
                if _time.monotonic() > deadline:
                    raise
                _time.sleep(0.02)
                continue
            if e.code != -1:
                raise
        state = store.is_sealed(oid)
        if state is True:
            return                       # earlier attempt completed
        if state is False:
            if not store.reclaim_orphan(oid):
                _time.sleep(0.02)        # live duplicate mid-write: wait
        # state None: slot vanished between checks — retry the put
        if _time.monotonic() > deadline:
            raise RuntimeError_(f"could not store result {oid!r}: slot "
                                f"stuck mid-write")


def split_parts(view) -> Tuple[int, list]:
    """Parse the ``[u32 kind][u32 n][u64 sizes…][parts…]`` store layout
    into ``(kind, [part views])`` — slices of ``view``, zero-copy. The
    single parser behind both read paths of :func:`store_get_value`."""
    kind, n = _struct.unpack_from("<II", view, 0)
    sizes = _struct.unpack_from(f"<{n}Q", view, 8)
    off = 8 + 8 * n
    parts = []
    for s in sizes:
        parts.append(view[off:off + s])
        off += s
    return kind, parts


def store_get_value(store, oid, copy: bool = True):
    """→ (found, value); read of the parts layout.

    ``copy=True``: heap-copying read (today's semantics — safe for
    callers that mutate the result). ``copy=False``: mapped-in-place
    read — pickle-5 buffer parts are READONLY memoryviews aliasing the
    object's shm pages, held alive (and the object pinned against
    eviction/spill) by the unpickled arrays themselves via the
    :class:`~tosem_tpu_torch.runtime.object_store.MappedHandle` machinery.
    RAW payloads copy either way (``bytes`` contract) and drop the pin
    immediately."""
    if copy:
        view = store.get_view(oid)
        if view is None:
            return False, None
        try:
            kind, parts = split_parts(view)
            return True, loads_parts(kind, parts)
        finally:
            store.release(oid)
    handle = store.get_mapped(oid)
    if handle is None:
        return False, None
    kind, parts = split_parts(handle.view)
    if kind == _RAW:
        try:
            return True, bytes(parts[0])
        finally:
            del parts
            handle.release()
    # zero-copy: the readonly slices ride into the unpickled value; the
    # pin rides the slices (released by GC when the last array dies)
    return True, loads_parts(kind, parts, copy=False)


def parts_nbytes(parts) -> int:
    return sum((p.nbytes if isinstance(p, memoryview) else len(p))
               for p in parts)


@dataclass
class TaskSpec:
    """Driver-side record of a submitted task, kept until completion so a
    worker crash can replay it (reference: lineage in
    ``raylet/reconstruction_policy.h:40``, here driver-held)."""
    task_id: bytes
    fn_id: Optional[bytes]      # None for actor method calls
    method: Optional[str]       # actor method name
    actor_id: Optional[bytes]
    args: tuple
    kwargs: dict
    result_ref: ObjectRef
    retries_left: int
    deps: set                   # unresolved ObjectRefs
    pg: Optional[bytes] = None  # placement group id (gang scheduling)
    # absolute time.monotonic() deadline; None = unbounded. Checked by
    # the scheduler sweep → DeadlineExceeded (fail-fast, worker survives)
    deadline: Optional[float] = None
