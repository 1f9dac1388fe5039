"""Worker process: executes tasks and hosts actors.

The per-process execution engine — the slim analog of the reference's core
worker (``src/ray/core_worker/core_worker.h:313``): receive task, resolve
large args from the shared-memory store (small ones arrive pre-serialized
inline), execute, return the result inline (small) or via the store (large).
One worker hosts either stateless tasks or exactly one actor instance (Ray
dedicates workers to actors the same way, ``_raylet.pyx:1093`` create_actor).

Messages in:  ("reg_fn", fn_id, blob) | ("task", tid, fn_id, blob)
              | ("actor_init", blob) | ("actor_call", tid, method, blob)
              | ("actor_snapshot",) | ("actor_restore", blob)
              | ("actor_replay", method, blob) | ("exit",)
              | ("batch", [msgs]) — coalesced pipe I/O (driver sender)
Messages out: ("ready",) | ("done", tid, kind, payload)
              | ("err", tid, blob, tb) | ("actor_ready",) |
              ("actor_err", blob, tb) | ("snapshot", blob) |
              ("snapshot_err", reason) | ("batch", [msgs])

Batched pipe I/O: results are buffered while more input is already queued
on the pipe and shipped as one ("batch", …) write — a burst of N fast tasks
costs O(N/8) syscalls instead of N. The buffer is flushed before blocking
on recv and capped at FLUSH_EVERY messages so the driver's progress clock
(steal/heartbeat) never runs more than a few results behind reality.
"""
from __future__ import annotations

import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

from tosem_tpu_torch.runtime import common
from tosem_tpu_torch.runtime.object_store import ObjectID, ObjectStore

FLUSH_EVERY = 8       # max results buffered before a forced pipe write
# max age of a buffered result before a forced flush: the driver's
# progress clock (last_progress) only advances on received messages, and
# its steal threshold is STEAL_AFTER_S=1.0 — results held longer than a
# fraction of that would read as a stalled worker and trigger duplicate
# re-dispatch of already-finished tasks
FLUSH_AFTER_S = common.STEAL_AFTER_S / 4.0


def _attach(store_name: str, store_box: list) -> ObjectStore:
    if store_box[0] is None:
        store_box[0] = ObjectStore(store_name, create=False)
    return store_box[0]


def _resolve(store_name: str, store_box: list, obj: Any) -> Any:
    """Replace top-level StoreRef/InlineParts markers with values."""
    if isinstance(obj, common.StoreRef):
        store = _attach(store_name, store_box)
        # mapped-in-place arg fetch (copy=False): large-arg ndarrays
        # alias the shm pages READONLY for the duration of the task —
        # the pin (which blocks eviction/spill) rides the arrays and
        # drops when the task's last reference dies. Tasks that need a
        # mutable copy own that copy (np.array(arg)), like the
        # reference's plasma-backed args.
        found, value = common.store_get_value(store, ObjectID(obj.binary),
                                              copy=False)
        if not found:
            # typed so the driver can reconstruct the dep and requeue
            # this task instead of surfacing a TaskError
            raise common.DependencyLostError(obj.binary.hex())
        return value
    if isinstance(obj, common.InlineParts):
        # zero-copy forwarded inline object: deserialize the driver's
        # already-serialized parts (loads_parts copies, so the value
        # never aliases the driver's inline table)
        return common.loads_parts(obj.kind, obj.parts)
    return obj


def _make_result(store_name: str, store_box: list, tid: bytes,
                 result_binary: bytes, value: Any) -> tuple:
    kind, parts = common.dumps_parts(value)
    if common.parts_nbytes(parts) > common.INLINE_THRESHOLD:
        store = _attach(store_name, store_box)
        # retry-safe: an earlier attempt of this task may have stored (or
        # died mid-storing) the same deterministic result id
        common.robust_store_put_parts(store, ObjectID(result_binary), kind,
                                      parts)
        return ("done", tid, "store", result_binary)
    return ("done", tid, "inline", (kind, [bytes(p) for p in parts]))


def _dump_exc(e: BaseException) -> bytes:
    """Serialize an exception, falling back when it is unpicklable (an open
    socket / lock in its attributes) so the real error isn't masked by a
    worker crash."""
    try:
        return common.dumps(e)
    except BaseException:
        return common.dumps(RuntimeError(
            f"{type(e).__name__}: {e!r} (original exception unpicklable)"))


def worker_main(conn, store_name: str) -> None:
    fns: Dict[bytes, Any] = {}
    actor: Optional[Any] = None
    store_box = [None]  # lazy attach; most small-task workers never need it
    inq: "deque[tuple]" = deque()
    out_buf: list = []
    buf_t0 = [0.0]      # monotonic time of the oldest buffered message

    def flush() -> None:
        if not out_buf:
            return
        if len(out_buf) == 1:
            conn.send(out_buf[0])
        else:
            conn.send(("batch", list(out_buf)))
        out_buf.clear()

    def emit(msg: tuple) -> None:
        if not out_buf:
            buf_t0[0] = time.monotonic()
        out_buf.append(msg)
        if len(out_buf) >= FLUSH_EVERY:
            flush()

    conn.send(("ready",))
    while True:
        # age-bounded buffering: with a deep inbound batch of slow tasks
        # the queue never runs dry, so without this a finished result
        # could sit here long enough for the driver to misread the
        # worker as stalled and steal (duplicate) its queued tasks
        if out_buf and time.monotonic() - buf_t0[0] > FLUSH_AFTER_S:
            flush()
        if not inq:
            # input queue dry: ship buffered results before blocking on
            # recv (and even when more input is readable, the cap in
            # emit() bounds how far the driver's view can lag)
            try:
                if out_buf and not conn.poll():
                    flush()
                msg = conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] == "batch":
                inq.extend(msg[1])
            else:
                inq.append(msg)
            continue
        msg = inq.popleft()
        kind = msg[0]
        if kind == "exit":
            break
        elif kind == "reg_fn":
            _, fn_id, blob = msg
            fns[fn_id] = common.loads(blob)
        elif kind == "task":
            _, tid, fn_id, result_binary, blob = msg
            try:
                args, kwargs = common.loads(blob)
                args = tuple(_resolve(store_name, store_box, a) for a in args)
                kwargs = {k: _resolve(store_name, store_box, v)
                          for k, v in kwargs.items()}
                value = fns[fn_id](*args, **kwargs)
                # drop mapped-arg pins the result does not alias BEFORE
                # the result put: in a near-full store the task's own
                # pinned args must not block its result's allocation
                del args, kwargs
                emit(_make_result(store_name, store_box, tid,
                                  result_binary, value))
            except BaseException as e:  # noqa: BLE001 — ship to driver
                emit(("err", tid, _dump_exc(e), traceback.format_exc()))
        elif kind == "actor_init":
            _, blob = msg
            try:
                cls, args, kwargs = common.loads(blob)
                args = tuple(_resolve(store_name, store_box, a) for a in args)
                kwargs = {k: _resolve(store_name, store_box, v)
                          for k, v in kwargs.items()}
                actor = cls(*args, **kwargs)
                emit(("actor_ready",))
            except BaseException as e:  # noqa: BLE001
                emit(("actor_err", _dump_exc(e), traceback.format_exc()))
        elif kind == "actor_snapshot":
            # pipe is FIFO: this snapshot reflects exactly the calls the
            # driver sent before requesting it — the driver's replay-log
            # cutoff accounting relies on that ordering (emit preserves
            # it: everything rides the same ordered out_buf)
            try:
                blob = common.dumps(actor)
                emit(("snapshot", blob))
            except BaseException as e:  # unpicklable actor state
                emit(("snapshot_err", repr(e)))
        elif kind == "actor_restore":
            # replace the freshly-init'd instance with the snapshot
            _, blob = msg
            try:
                actor = common.loads(blob)
            except BaseException as e:  # noqa: BLE001
                emit(("actor_err", _dump_exc(e), traceback.format_exc()))
        elif kind == "actor_replay":
            # best-effort state replay on restart: results are not
            # re-reported (the original callers already got them or an
            # ActorDiedError); a replay failure must not kill the actor
            _, method, blob = msg
            try:
                args, kwargs = common.loads(blob)
                args = tuple(_resolve(store_name, store_box, a) for a in args)
                kwargs = {k: _resolve(store_name, store_box, v)
                          for k, v in kwargs.items()}
                getattr(actor, method)(*args, **kwargs)
            except BaseException:  # noqa: BLE001
                pass
        elif kind == "actor_call":
            _, tid, method, result_binary, blob = msg
            try:
                args, kwargs = common.loads(blob)
                args = tuple(_resolve(store_name, store_box, a) for a in args)
                kwargs = {k: _resolve(store_name, store_box, v)
                          for k, v in kwargs.items()}
                value = getattr(actor, method)(*args, **kwargs)
                del args, kwargs   # as in the task path: unpin pre-put
                emit(_make_result(store_name, store_box, tid,
                                  result_binary, value))
            except BaseException as e:  # noqa: BLE001
                emit(("err", tid, _dump_exc(e), traceback.format_exc()))
    try:
        flush()
    except (OSError, ValueError):
        pass
    if store_box[0] is not None:
        store_box[0].close()
