"""Driver-side runtime: worker pool, scheduler loop, failure handling.

Single-controller re-design of the reference's raylet + GCS split: the
driver process owns scheduling (the reference's
``raylet/scheduling/cluster_task_manager.cc`` lease loop), the worker pool
(``raylet/worker_pool.cc``), failure detection (GCS heartbeats,
``gcs_redis_failure_detector.cc`` — here process sentinels watched by the
scheduler thread), and task replay on worker death (the lineage-reconstruction
role of ``raylet/reconstruction_policy.h:40``). A single-card program has one
controller anyway, so the distributed control store (Redis/GCS) collapses
into in-process maps.

Threading model: user threads submit under ``self.lock``; a scheduler thread
drains worker pipes and watches process sentinels; a dedicated sender thread
performs ALL pipe writes so no potentially-blocking ``conn.send`` ever runs
while the runtime lock is held (a blocked write + full return pipe would
otherwise deadlock driver and worker against each other).

Object lifetime: the driver object table is keyed by raw object-id bytes and
garbage-collected via ``weakref.finalize`` on the user-facing ObjectRef —
the single-process analog of the reference's distributed reference counting
(``core_worker/reference_count.cc``).
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import queue
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

from collections import OrderedDict, deque

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.runtime import common
from tosem_tpu_torch.runtime.common import (ActorDiedError, DeadlineExceeded,
                                      DependencyLostError, ObjectLostError,
                                      ObjectRef, PlacementTimeout, StoreRef,
                                      TaskCancelledError, TaskError, TaskSpec,
                                      WorkerCrashedError)
from tosem_tpu_torch.obs import metrics as _metrics
from tosem_tpu_torch.runtime.object_store import (ObjectID, ObjectStore,
                                            ObjectStoreError)

# runtime metric definitions (the src/ray/stats/metric_defs.h role)
M_TASKS_SUBMITTED = _metrics.counter(
    "rt_tasks_submitted_total", "tasks submitted to the runtime")
M_TASKS_FINISHED = _metrics.counter(
    "rt_tasks_finished_total", "task completions by outcome", ["outcome"])
M_ACTORS = _metrics.counter(
    "rt_actor_events_total", "actor lifecycle events", ["event"])
M_MEM_PRESSURE = _metrics.counter(
    "runtime_memory_pressure_total",
    "high-watermark firings of the runtime memory watchdog")
M_WORKERS_ALIVE = _metrics.gauge(
    "rt_workers_alive", "stateless worker processes in the pool")
M_RECONSTRUCTIONS = _metrics.counter(
    "rt_object_reconstructions_total",
    "lost objects re-derived by re-executing their producing task")
M_SPILLS = _metrics.counter(
    "rt_objects_spilled_total",
    "store objects demoted to the disk spill tier under pressure")


# shared-memory segment names of this runtime: /tosem_torch_rt_<pid>_<ms>
STORE_PREFIX = "/tosem_torch_rt_"


def _default_start_method() -> str:
    """fork is fastest, but a forked child cannot use a process that
    already loaded torch: CUDA refuses to initialise in a child once its
    parent has, and GNU OpenMP (CPU torch's intra-op pool) is not
    fork-safe after the parent ran a parallel region. So once torch is
    loaded we default to spawn. Env var overrides either way."""
    import sys
    env = os.environ.get("TOSEM_RT_START_METHOD")
    if env:
        return env
    return "spawn" if "torch" in sys.modules else "fork"


class _Worker:
    """One worker process + its control pipe (a leased worker slot)."""

    _ids = itertools.count()

    def __init__(self, ctx, store_name: str, actor_id: Optional[bytes] = None):
        import sys
        from tosem_tpu_torch.runtime.worker import worker_main
        self.wid = next(self._ids)
        self.conn, child_conn = mp.Pipe(duplex=True)
        self.proc = ctx.Process(target=worker_main,
                                args=(child_conn, store_name),
                                daemon=True, name=f"tosem-worker-{self.wid}")
        # spawn re-executes __main__ by path; a REPL/heredoc parent has
        # __file__ = "<stdin>" which the child can't run — hide it
        main_mod = sys.modules.get("__main__")
        fake_file = None
        if ctx.get_start_method() == "spawn" and main_mod is not None:
            mf = getattr(main_mod, "__file__", None)
            if mf and not os.path.exists(mf):
                fake_file = mf
                del main_mod.__file__
        try:
            self.proc.start()
        finally:
            if fake_file is not None:
                main_mod.__file__ = fake_file
        child_conn.close()
        self.actor_id = actor_id       # None = stateless task worker
        self.known_fns: Set[bytes] = set()
        self.inflight: List[bytes] = []   # task_ids in submission order
        self.ready = False
        self.last_progress = time.monotonic()
        # gang scheduling (placement groups): a reserved worker only runs
        # tasks tagged with its group; a parked worker backs an actor
        # placed in the group and runs nothing until the actor dies
        self.reserved_by: Optional[bytes] = None
        self.parked = False
        # O(1) scheduling bookkeeping: membership in the runtime's
        # per-pool idle deque (in_idle + which pool's deque), and a
        # tombstone set when the worker leaves the pool so stale deque
        # entries can be dropped lazily at pop time
        self.in_idle = False
        self.idle_key: Optional[bytes] = None
        self.retired = False
        # direct-send fast path: submitters may write this pipe
        # themselves (outside the runtime lock) when nothing for the
        # worker is queued on the sender thread. send_lock serializes
        # pipe writers; nqueued (guarded by nq_lock, never held during a
        # send) counts messages still owed by the sender thread — a
        # direct write is allowed only at nqueued == 0, preserving
        # per-worker FIFO between the two paths.
        self.send_lock = threading.Lock()
        self.nq_lock = threading.Lock()
        self.nqueued = 0

    def load_key(self):
        """Dispatch preference: non-stalled first, then least loaded. A
        worker grinding a long task must not swallow new work (head-of-line
        blocking): queued tasks behind it get stolen by the scheduler."""
        stalled = bool(self.inflight) and (
            time.monotonic() - self.last_progress > common.STEAL_AFTER_S)
        return (1 if stalled else 0, len(self.inflight))

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except Exception:
            pass


class _ActorRecord:
    # unpicklable actors fall back to full method replay; this bounds
    # that log (oldest dropped — restart state becomes best-effort)
    REPLAY_LOG_CAP = 1024

    def __init__(self, worker: _Worker, init_blob: bytes, max_restarts: int,
                 restore_state: bool = False,
                 snapshot_every: int = common.ACTOR_SNAPSHOT_EVERY):
        self.worker = worker
        self.init_blob = init_blob      # replayed on restart
        self.max_restarts = max_restarts
        self.restarts = 0
        self.dead = False
        # state recovery (restore_state=True): the driver snapshots the
        # actor every `snapshot_every` calls and keeps the method calls
        # sent since, so a restart replays init -> snapshot -> log
        # instead of just init (reference: actor checkpointing +
        # task-replay reconstruction, gcs_actor_manager.cc)
        self.restore_state = restore_state
        self.snapshot_every = max(1, snapshot_every)
        self.snapshot_blob: Optional[bytes] = None
        self.snapshot_unavailable = False   # actor state unpicklable
        self.replay_log: List[Tuple[int, str, bytes]] = []
        self.call_seq = 0                   # send ordinal (FIFO pipe)
        self.snapshot_cutoff: Optional[int] = None  # in-flight request


class _Lineage:
    """How to re-derive one store object: its producing stateless task.

    Deliberately does NOT hold the result ObjectRef (that would pin the
    driver-table entry forever); args/kwargs DO hold dep ObjectRefs —
    lineage pinning, so a reconstructible object's ancestors stay
    reconstructible too.
    """

    __slots__ = ("fn_id", "args", "kwargs")

    def __init__(self, fn_id: bytes, args: tuple, kwargs: dict):
        self.fn_id = fn_id
        self.args = args
        self.kwargs = kwargs


class Runtime:
    """The per-driver runtime singleton behind :mod:`tosem_tpu_torch.runtime.api`."""

    def __init__(self, num_workers: int = 4,
                 store_capacity: int = 256 << 20,
                 max_task_retries: int = common.DEFAULT_MAX_TASK_RETRIES,
                 start_method: Optional[str] = None,
                 memory_monitor: bool = True,
                 reconstruction: bool = True):
        # a pinned method (arg or env) is honored forever; otherwise the
        # context is re-picked at every worker spawn — a Runtime created
        # before torch was imported must still switch to spawn for
        # workers started AFTER torch arrives (respawns, new actors)
        self._pinned_method = start_method or os.environ.get(
            "TOSEM_RT_START_METHOD")
        self.ctx = self._make_ctx()
        # a prefix of its own: the JAX package's runtime names its
        # segments /tosem_rt_*, and the two may share one process
        self.store_name = (f"{STORE_PREFIX}{os.getpid()}_"
                           f"{int(time.time()*1e3)%int(1e9)}")
        self.store = ObjectStore(self.store_name, capacity=store_capacity)
        self.max_task_retries = max_task_retries

        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)
        # object table, keyed by raw 20-byte oid (NOT ObjectRef: the table
        # must not keep user refs alive — finalizers below GC these entries)
        # inline values are (kind, [part bytes, ...]) per common.dumps_parts
        self.inline: Dict[bytes, Tuple[int, List[bytes]]] = {}
        self.in_store: Set[bytes] = set()
        self.errors: Dict[bytes, BaseException] = {}
        # lineage (reconstruction_policy role): result-oid -> producing
        # task, kept AFTER completion so a lost object can be re-derived
        # by re-executing it; bounded FIFO, entries die with their ref
        self.reconstruction = reconstruction
        self.lineage: "OrderedDict[bytes, _Lineage]" = OrderedDict()
        self._recon_attempts: Dict[bytes, int] = {}
        self._reconstructing: Set[bytes] = set()
        # at-least-once dedup (steal races): task_id → (result kind,
        # result oid) of completed tasks, bounded FIFO like lineage, so
        # a duplicate "done" (task stolen AND finished by the original
        # worker) is dropped instead of re-applied; _evicted tracks the
        # result oids the DRIVER deleted from the store (chaos eviction)
        # so a duplicate's worker-side re-put can be told apart from a
        # legitimately live object and undone
        self._completed: "OrderedDict[bytes, Tuple[str, bytes]]" = \
            OrderedDict()
        self._evicted: Set[bytes] = set()
        # task state. Scheduling is indexed, not scanned (the fast path):
        #  - pending: every undispatched spec, keyed by task_id
        #  - _ready_q: per-placement-pool FIFO of dep-free stateless task
        #    ids (key = spec.pg; None = the default pool)
        #  - _waiters: dep object key → task_ids blocked on it; resolved
        #    objects wake exactly their dependants (no pending scan)
        #  - _idle: per-pool deque of workers with spare pipeline slots,
        #    validated lazily at pop (stale entries are just dropped)
        # so _dispatch_locked is O(ready tasks), not O(tasks × workers).
        self.specs: Dict[bytes, TaskSpec] = {}
        self.pending: Dict[bytes, TaskSpec] = {}
        self._ready_q: Dict[Optional[bytes], "deque[bytes]"] = {}
        self._waiters: Dict[bytes, List[bytes]] = {}
        self._idle: Dict[Optional[bytes], "deque[_Worker]"] = {}
        self._enqueued_during_dispatch = False
        # getters draining worker pipes themselves (see get()): while
        # any are active the scheduler waits on process sentinels only,
        # so every result doesn't wake two threads racing for the lock
        self._active_getters = 0
        self.fn_blobs: Dict[bytes, bytes] = {}
        # task_ids carrying a deadline — keeps the per-tick expiry sweep
        # O(deadlined tasks), i.e. free for workloads that use none
        self.deadlined: Set[bytes] = set()
        # chaos delay_result parking lot: (deliver_at, worker, done-msg)
        # tuples matured by the scheduler tick
        self._delayed_results: List[Tuple[float, _Worker, tuple]] = []
        # workers
        self.task_workers: List[_Worker] = []
        self.actors: Dict[bytes, _ActorRecord] = {}
        # placement groups: pg_id → record; the FIFO queue gives gang
        # requests head-of-line all-or-nothing grants (no partial holds,
        # therefore no deadlock between concurrent gangs)
        self.placement_groups: Dict[bytes, Dict[str, Any]] = {}
        self._pg_queue: List[Any] = []
        self._shutdown = False
        for _ in range(num_workers):
            w = _Worker(self.ctx, self.store_name)
            self.task_workers.append(w)
            self._push_idle_locked(w)
        M_WORKERS_ALIVE.set(len(self.task_workers))

        # completion wake pipe (self-pipe trick): getters block on the
        # worker pipes themselves, so a completion applied by ANOTHER
        # thread (scheduler drain, deadline sweep, cancel) must still
        # wake them — one nonblocking byte per completion event
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)

        self._sendq: "queue.SimpleQueue[Optional[Tuple[_Worker, tuple]]]" = \
            queue.SimpleQueue()
        self._sender = threading.Thread(target=self._sender_loop, daemon=True,
                                        name="tosem-sender")
        self._sender.start()
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        daemon=True, name="tosem-scheduler")
        self._thread.start()

        # memory watchdog (ray memory_monitor role): samples RSS + the
        # shared store into the metrics registry and counts pressure
        # events; cheap daemon thread, disable via memory_monitor=False
        self._memmon = None
        if memory_monitor:
            from tosem_tpu_torch.obs.memory_monitor import MemoryMonitor

            def _on_pressure(snap):
                M_MEM_PRESSURE.inc()
                spilled = self.spill_under_pressure()
                print(f"[tosem_tpu_torch] memory pressure: "
                      f"rss={snap['rss_bytes']/1e9:.2f}GB "
                      f"available={snap['available_bytes']/1e9:.2f}GB "
                      f"spilled={spilled} store objects to disk",
                      file=sys.stderr)
            self._memmon = MemoryMonitor(
                threshold=0.92, interval_s=5.0, store=self.store,
                on_pressure=_on_pressure).start()

    def _make_ctx(self):
        return mp.get_context(self._pinned_method
                              or _default_start_method())

    # ------------------------------------------------------------------ API

    def register_fn(self, blob: bytes) -> bytes:
        fn_id = common.fast_token(16)
        with self.lock:
            self.fn_blobs[fn_id] = blob
        return fn_id

    def submit_task(self, fn_id: bytes, args: tuple, kwargs: dict,
                    max_retries: Optional[int] = None,
                    pg: Optional[bytes] = None,
                    deadline_s: Optional[float] = None) -> ObjectRef:
        ref = self._new_ref()
        spec = TaskSpec(task_id=common.fast_token(16), fn_id=fn_id,
                        method=None, actor_id=None, args=args, kwargs=kwargs,
                        result_ref=ref,
                        retries_left=(self.max_task_retries
                                      if max_retries is None else max_retries),
                        deps=set(), pg=pg,
                        deadline=(None if deadline_s is None
                                  else time.monotonic() + deadline_s))
        M_TASKS_SUBMITTED.inc()
        with self.lock:
            if spec.deadline is not None:
                self.deadlined.add(spec.task_id)
            if pg is not None and pg not in self.placement_groups:
                self.errors[ref.oid.binary] = ValueError(
                    "unknown or removed placement group")
                self.cv.notify_all()
                return ref
            self.specs[spec.task_id] = spec
            spec.deps = self._unresolved_deps_locked(args, kwargs)
            direct = None
            if not spec.deps:
                # fast path: straight onto an idle worker's pipeline.
                # Re-index the worker UNCONDITIONALLY: on a send failure
                # (e.g. an errored dependency raising at materialize)
                # nothing was booked inflight, so no completion would
                # ever re-index it — skipping the push would leak the
                # worker out of the O(1) scheduler for good
                w = self._pop_worker_locked(pg)
                if w is not None:
                    try:
                        direct = self._send_task_locked(w, spec,
                                                        allow_direct=True)
                    except BaseException as e:
                        self._fail_task_locked(spec, e)
                    finally:
                        self._push_idle_locked(w)
                else:
                    self._enqueue_ready_locked(spec)
            else:
                self._index_deps_locked(spec)
        if direct is not None:
            self._direct_send(w, direct)
        return ref

    def create_actor(self, cls_blob_args: bytes, max_restarts: int,
                     pg: Optional[bytes] = None,
                     restore_state: bool = False,
                     snapshot_every: int = common.ACTOR_SNAPSHOT_EVERY
                     ) -> bytes:
        actor_id = common.fast_token(16)
        M_ACTORS.inc(labels=["created"])
        # ONE lock hold for slot consumption + actor registration: a gap
        # between them would let a concurrent remove_placement_group miss
        # the actor (it would outlive its removed group)
        with self.lock:
            victim = None
            if pg is not None:
                rec = self.placement_groups.get(pg)
                if rec is None:
                    raise ValueError("unknown or removed placement group")
                # an actor consumes one bundle slot: park one reserved
                # worker (idle preferred) — it runs nothing while the
                # actor lives, keeping the gang's slot accounting honest
                candidates = [w for w in self.task_workers
                              if w.reserved_by == pg and not w.parked]
                if not candidates:
                    raise ValueError(
                        "placement group has no free slot for an actor")
                victim = min(candidates, key=lambda w: len(w.inflight))
                victim.parked = True
                rec["actors"].add(actor_id)
            try:
                w = _Worker(self._make_ctx(), self.store_name,
                            actor_id=actor_id)
            except BaseException:
                if pg is not None:       # roll the slot back, don't leak it
                    victim.parked = False
                    rec["actors"].discard(actor_id)
                raise
            self.actors[actor_id] = _ActorRecord(
                w, cls_blob_args, max_restarts,
                restore_state=restore_state, snapshot_every=snapshot_every)
            self._send(w, ("actor_init", cls_blob_args))
            self.cv.notify_all()
        return actor_id

    # ------------------------------------------------ placement groups

    def create_placement_group(self, n_slots: int,
                               strategy: str = "pack",
                               timeout: Optional[float] = None) -> bytes:
        """Atomically reserve ``n_slots`` task workers (gang scheduling).

        All-or-nothing with FIFO head-of-line granting: a request never
        holds a partial reservation while waiting, so two concurrent gangs
        that each need more than half the pool cannot deadlock — one gets
        everything, the other waits its turn. ``timeout=0`` is a
        try-acquire. TPU-first collapse of the reference's placement
        groups (``gcs_placement_group_scheduler.cc``,
        ``python/ray/util/placement_group.py``): one controller, one
        resource kind (worker slots), so PACK/SPREAD only matter at the
        cluster layer (:mod:`tosem_tpu_torch.cluster.gang`).
        """
        if n_slots <= 0:
            raise ValueError("n_slots must be positive")
        if strategy not in ("pack", "spread", "strict_pack",
                            "strict_spread"):
            raise ValueError(f"unknown strategy {strategy!r}")
        token = object()
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self.cv:
            self._pg_queue.append(token)
            try:
                while True:
                    if self._shutdown:
                        raise RuntimeError("runtime is shut down")
                    if n_slots > len(self.task_workers):
                        raise ValueError(
                            f"placement group of {n_slots} slots can never "
                            f"be satisfied by a {len(self.task_workers)}-"
                            "worker pool")
                    if self._pg_queue[0] is token:
                        free = [w for w in self.task_workers
                                if w.reserved_by is None]
                        if len(free) >= n_slots:
                            pg_id = common.fast_token(16)
                            for w in free[:n_slots]:
                                w.reserved_by = pg_id
                                self._reindex_idle_locked(w)
                            self.placement_groups[pg_id] = {
                                "n_slots": n_slots, "strategy": strategy,
                                "actors": set()}
                            return pg_id
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise PlacementTimeout(
                                f"no {n_slots} free slots within "
                                f"{timeout}s")
                        self.cv.wait(min(remaining, 1.0))
                    else:
                        self.cv.wait(1.0)
            finally:
                self._pg_queue.remove(token)
                self.cv.notify_all()

    def remove_placement_group(self, pg_id: bytes) -> None:
        """Release the gang's workers. Actors placed in the group are
        killed (the reference's remove_placement_group semantics).

        One critical section for record removal + worker release, so a
        concurrent reader can never observe reserved workers whose group
        record is already gone (the reservation accounting invariant
        ``sum(reserved) == sum(booked slots)`` holds at every instant).
        """
        with self.cv:
            rec = self.placement_groups.pop(pg_id, None)
            if rec is None:
                return
            for aid in list(rec["actors"]):
                self.kill_actor(aid)     # re-entrant (RLock)
            for w in self.task_workers:
                if w.reserved_by == pg_id:
                    w.reserved_by = None
                    w.parked = False
                    self._reindex_idle_locked(w)
            # pending tasks tagged with the dead group can never run
            # (blocked or ready alike — _fail pops them from pending;
            # their ready-queue ids go stale and the queue is dropped)
            self._ready_q.pop(pg_id, None)
            self._idle.pop(pg_id, None)
            for spec in [s for s in self.pending.values()
                         if s.pg == pg_id]:
                self._fail_task_locked(spec, ValueError(
                    "placement group was removed"))
            self.cv.notify_all()
            self._dispatch_locked()

    # ------------------------------------------- O(1) scheduling indexes

    def _push_idle_locked(self, w: _Worker) -> None:
        """Index ``w`` as dispatchable in its pool (idempotent).

        Hot-stack order: a fully idle worker goes to the pop end (its
        process is hot — reusing it keeps sync round-trip latency low,
        matching the old least-loaded pick), a worker that still has
        tasks in flight goes to the far end (so bursts spread across
        idle workers before pipelining onto busy ones)."""
        if (w.in_idle or w.retired or w.parked or w.actor_id is not None
                or len(w.inflight) >= common.MAX_INFLIGHT_PER_WORKER):
            return
        w.in_idle = True
        w.idle_key = w.reserved_by
        q = self._idle.setdefault(w.reserved_by, deque())
        if w.inflight:
            q.appendleft(w)
        else:
            q.append(w)

    def _pop_worker_locked(self, key: Optional[bytes]) -> Optional[_Worker]:
        """Next dispatchable worker of pool ``key`` (idle-hot first),
        or None. Stale entries (retired / re-reserved / parked / full
        pipeline) are dropped; a stalled worker is skipped and re-indexed
        when it next makes progress (completion pushes it back)."""
        q = self._idle.get(key)
        if not q:
            return None
        for _ in range(len(q)):
            w = q.pop()
            w.in_idle = False
            if (w.retired or w.parked or w.reserved_by != key
                    or len(w.inflight) >= common.MAX_INFLIGHT_PER_WORKER):
                continue
            if w.load_key()[0] != 0:
                continue  # stalled: steal path works around it
            return w
        return None

    def _reindex_idle_locked(self, w: _Worker) -> None:
        """Move ``w`` to the idle deque matching its (possibly changed)
        reservation. Rare event (placement-group create/remove)."""
        if w.in_idle and w.idle_key != w.reserved_by:
            try:
                self._idle[w.idle_key].remove(w)
            except (KeyError, ValueError):
                pass
            w.in_idle = False
        self._push_idle_locked(w)

    def _enqueue_ready_locked(self, spec: TaskSpec, front: bool = False)\
            -> None:
        """Queue a dep-free stateless spec for dispatch (FIFO per pool;
        ``front=True`` for requeues — stolen/replayed/reconstruction
        work runs before fresh submissions, as the old list did with
        ``insert(0)``)."""
        self.pending[spec.task_id] = spec
        self._enqueued_during_dispatch = True
        q = self._ready_q.setdefault(spec.pg, deque())
        if front:
            q.appendleft(spec.task_id)
        else:
            q.append(spec.task_id)

    def _index_deps_locked(self, spec: TaskSpec) -> None:
        """Register an undispatched spec with unresolved deps: each dep
        key wakes exactly this spec when it resolves."""
        self.pending[spec.task_id] = spec
        for d in spec.deps:
            self._waiters.setdefault(d.oid.binary, []).append(spec.task_id)

    def _dispatch_unblocked_locked(self, spec: TaskSpec,
                                   front: bool = False,
                                   ready_stack: Optional[List[bytes]]
                                   = None) -> None:
        """Route a dep-free undispatched spec: actor specs go straight
        to their (ordered) pipe or fail if the actor is gone, stateless
        specs join their pool's ready queue. Shared by re-admission and
        the publish wake path so the two cannot diverge."""
        if spec.actor_id is not None:
            rec = self.actors.get(spec.actor_id)
            if rec is None or rec.dead:
                self._fail_task_locked(spec, ActorDiedError("actor died"),
                                       ready_stack=ready_stack)
                return
            try:
                self._send_task_locked(rec.worker, spec)
            except BaseException as e:
                self._fail_task_locked(spec, e, ready_stack=ready_stack)
            return
        self._enqueue_ready_locked(spec, front=front)

    def _admit_spec_locked(self, spec: TaskSpec, front: bool = False)\
            -> None:
        """(Re-)admit an undispatched spec: waiter-index unresolved deps
        or queue it ready. Requeue paths (steal, death replay, lost-dep
        recovery, reconstruction) land here."""
        spec.deps = {d for d in spec.deps
                     if not self._ready_locked(d.oid.binary)}
        if spec.deps:
            self._index_deps_locked(spec)
            return
        self._dispatch_unblocked_locked(spec, front=front)

    def _publish_ready_locked(self, key: bytes) -> None:
        """An object (result or error) for ``key`` is now available:
        wake exactly its waiting dependants. Iterative — failing a
        dependant publishes ITS result error onto the same worklist, so
        a deep error cascade cannot overflow the stack."""
        if key not in self._waiters:
            return
        stack = [key]
        while stack:
            for tid in self._waiters.pop(stack.pop(), ()):
                spec = self.pending.pop(tid, None)
                if spec is None or tid not in self.specs:
                    continue
                spec.deps = {d for d in spec.deps
                             if not self._ready_locked(d.oid.binary)}
                if spec.deps:
                    # still blocked: keep waiting (its remaining deps
                    # are already waiter-indexed from admission)
                    self.pending[tid] = spec
                    continue
                self._dispatch_unblocked_locked(spec, ready_stack=stack)

    def submit_actor_call(self, actor_id: bytes, method: str, args: tuple,
                          kwargs: dict,
                          deadline_s: Optional[float] = None) -> ObjectRef:
        ref = self._new_ref()
        spec = TaskSpec(task_id=common.fast_token(16),
                        fn_id=None, method=method,
                        actor_id=actor_id, args=args, kwargs=kwargs,
                        result_ref=ref, retries_left=0, deps=set(),
                        deadline=(None if deadline_s is None
                                  else time.monotonic() + deadline_s))
        with self.lock:
            rec = self.actors.get(actor_id)
            if rec is None or rec.dead:
                self.errors[ref.oid.binary] = ActorDiedError("actor is dead")
                self.cv.notify_all()
                return ref
            if spec.deadline is not None:
                self.deadlined.add(spec.task_id)
            self.specs[spec.task_id] = spec
            spec.deps = self._unresolved_deps_locked(args, kwargs)
            direct = None
            w = rec.worker
            if not spec.deps:
                # fast path: the actor's pipe IS its ordered queue
                try:
                    direct = self._send_task_locked(w, spec,
                                                    allow_direct=True)
                except BaseException as e:
                    self._fail_task_locked(spec, e)
            else:
                self._index_deps_locked(spec)
        if direct is not None:
            self._direct_send(w, direct)
        return ref

    def _unpark_for_actor_locked(self, actor_id: bytes) -> None:
        """Return the bundle slot an actor consumed to its group."""
        for pg_id, rec in self.placement_groups.items():
            if actor_id in rec["actors"]:
                rec["actors"].discard(actor_id)
                for w in self.task_workers:
                    if w.reserved_by == pg_id and w.parked:
                        w.parked = False
                        self._push_idle_locked(w)
                        break
                self.cv.notify_all()
                return

    def kill_actor(self, actor_id: bytes) -> None:
        with self.lock:
            rec = self.actors.get(actor_id)
            if rec is None or rec.dead:
                return
            rec.dead = True            # explicit kill: no restart (ray.kill)
            self._unpark_for_actor_locked(actor_id)
            # fail everything in flight or queued NOW — once dead the
            # scheduler stops watching this worker, so nothing else will
            for tid in list(rec.worker.inflight):
                spec = self.specs.get(tid)
                if spec is not None:
                    self._fail_task_locked(spec,
                                           ActorDiedError("actor was killed"))
            rec.worker.inflight.clear()
            self._fail_actor_tasks_locked(actor_id,
                                          ActorDiedError("actor was killed"))
            rec.worker.kill()
            self._dispatch_locked()

    def cancel(self, ref: ObjectRef) -> None:
        """Cancel the task producing ``ref`` (``ray.cancel(force=True)``).

        Pending (undispatched) tasks are simply dropped. Once the task has
        been written to a worker's pipe the worker WILL execute it, so the
        process is killed: for a stateless worker its other in-flight tasks
        are re-queued WITHOUT charging a retry (they are victims, not
        crashes) and a replacement worker is spawned immediately; for an
        actor the ``max_restarts`` policy applies and concurrent queued
        calls fail with :class:`ActorDiedError` (documented collateral —
        the process is the cancellation boundary, as with pynisher/ray
        force-cancel). The ref resolves to :class:`TaskCancelledError`.
        Already-finished tasks are untouched (best-effort, like the
        reference's ``core_worker.cc`` CancelTask path).
        """
        key = ref.oid.binary
        with self.lock:
            if self._ready_locked(key):
                return
            spec = next((s for s in self.specs.values()
                         if s.result_ref.oid.binary == key), None)
            if spec is None:
                return  # not a task ref (e.g. a put), or already GC'd
            # drain the owning worker's pipe first: a just-delivered "done"
            # beats the kill (narrowest possible completed-vs-running race)
            target: Optional[_Worker] = None
            workers = list(self.task_workers) + [
                r.worker for r in self.actors.values() if not r.dead]
            for w in workers:
                if spec.task_id in w.inflight:
                    target = w
                    self._drain_conn_locked(w)
                    break
            if self._ready_locked(key) or spec.task_id not in self.specs:
                return  # completed during the drain
            self.specs.pop(spec.task_id, None)
            self.pending.pop(spec.task_id, None)
            self.deadlined.discard(spec.task_id)
            self.errors[key] = TaskCancelledError("task was cancelled")
            self._publish_ready_locked(key)
            self.cv.notify_all()
            # re-locate the task: the drain may have re-homed it (worker
            # died mid-drain → death handler re-queued and re-dispatched
            # it onto a DIFFERENT worker). Killing only the original
            # target would leave the hung task grinding its new slot.
            target = None
            for w in (list(self.task_workers)
                      + [r.worker for r in self.actors.values()
                         if not r.dead]):
                if spec.task_id in w.inflight:
                    target = w
                    break
            if target is None:
                return  # never dispatched (or dropped back to pending)
            target.inflight.remove(spec.task_id)
            if target.actor_id is not None:
                target.kill()  # sentinel path applies the restart policy
                return
            # stateless: retire the whole worker NOW so the dispatcher
            # can't route new work to the corpse; re-queue its other
            # in-flight tasks free of charge
            if target in self.task_workers:
                self.task_workers.remove(target)
                target.retired = True
                for tid in reversed(target.inflight):
                    s = self.specs.get(tid)
                    if s is not None:
                        self._admit_spec_locked(s, front=True)
                target.inflight.clear()
                target.kill()
                if not self._shutdown:
                    repl = _Worker(self._make_ctx(), self.store_name)
                    self.task_workers.append(repl)
                    self._push_idle_locked(repl)
                M_WORKERS_ALIVE.set(len(self.task_workers))
                self._dispatch_locked()

    def put(self, value: Any) -> ObjectRef:
        kind, parts = common.dumps_parts(value)
        ref = self._new_ref()
        if common.parts_nbytes(parts) > common.INLINE_THRESHOLD:
            self._store_put_pressure(ref.oid, kind, parts)
            with self.lock:
                self.in_store.add(ref.oid.binary)
        else:
            with self.lock:
                self.inline[ref.oid.binary] = \
                    (kind, [bytes(p) for p in parts])
        return ref

    def _store_put_pressure(self, oid: ObjectID, kind: int, parts,
                            deadline_s: float = 5.0) -> None:
        """Store write that turns pressure into slow, not fatal: on a
        full store demote cold objects to the disk spill tier and retry;
        when nothing is spillable because every resident byte is PINNED
        by live mappings, wait-with-deadline for consumers to drop their
        pins before giving up."""
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                common.store_put_parts(self.store, oid, kind, parts)
                return
            except ObjectStoreError as e:
                if e.code != -3:
                    raise
                if time.monotonic() > deadline:
                    raise
                if not self.spill_under_pressure(target_fraction=0.25):
                    time.sleep(0.02)   # all pinned: wait for pins to drop

    def free(self, refs) -> None:
        """Explicitly release objects (the ``ray.internal.free`` role):
        drop the driver-table entry, lineage, and the store copy + spill
        file NOW instead of waiting for the ObjectRef to be GC'd. A
        consumer holding a live mapping keeps the pages alive (the store
        defers the free to the last release). Unlike ref GC, the key
        gets an :class:`ObjectLostError` tombstone — the caller still
        HOLDS the ref, so a later ``get`` must raise immediately rather
        than wait forever for an object nobody will produce. (The
        tombstone itself dies with the ref's finalizer.) Accepts a
        single ref or an iterable."""
        if isinstance(refs, ObjectRef):
            refs = [refs]
        for ref in refs:
            key = ref.oid.binary
            self._release_oid(key)
            with self.lock:
                self.errors[key] = ObjectLostError(
                    f"object {key.hex()[:12]} was explicitly freed")
                self.cv.notify_all()

    def get(self, ref: ObjectRef, timeout: Optional[float] = None,
            copy: bool = False) -> Any:
        key = ref.oid.binary
        # fast path: one lock hold, one dict probe — the overwhelmingly
        # common case of getting an already-resolved inline object (the
        # RAW-bytes case is unpacked here: parts[0] is already the
        # immutable value, no loads_parts frame needed)
        with self.lock:
            entry = self.inline.get(key)
        if entry is not None:
            kind, parts = entry
            if kind == common._RAW:
                return bytes(parts[0])
            return common.loads_parts(kind, parts)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self.lock:
                if key in self.errors:
                    raise self.errors[key]
                entry = self.inline.get(key)
                if entry is not None:
                    return common.loads_parts(*entry)
                stored = key in self.in_store
                if not stored:
                    watch = list(self.task_workers)
                    watch += [r.worker for r in self.actors.values()
                              if not r.dead]
            if stored:
                # copy=False (default): mapped-in-place read — array
                # buffers alias the shm pages readonly, pinned against
                # eviction/spill until the caller's last reference dies
                found, value = common.store_get_value(self.store, ref.oid,
                                                      copy=copy)
                if found:
                    return value
                # lost from the store (evicted / producing worker died
                # before the driver learned): heal through lineage, then
                # loop back and wait for the re-derived object
                err = self._begin_reconstruction(key)
                if err is not None:
                    raise err
                continue
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                # a timed-out waiter holds nothing: any
                # reconstruction it triggered keeps running and
                # re-publishes the object, so a later get()
                # succeeds (no permanently-in-flight ref)
                raise TimeoutError(f"get({ref!r}) timed out")
            # Block on the worker pipes themselves (+ the completion
            # wake pipe): an arriving result wakes THIS thread directly,
            # skipping the scheduler→condvar→getter double hop that
            # dominated sync round-trip latency. The short cap bounds
            # staleness of the pipe snapshot (worker churn) and covers
            # completion paths with no pipe traffic.
            step = 0.05 if remaining is None else min(remaining, 0.05)
            with self.lock:
                self._active_getters += 1
            try:
                ready = mpc.wait([w.conn for w in watch] + [self._wake_r],
                                 timeout=step)
            except (OSError, ValueError):
                time.sleep(0.01)   # a watched pipe died mid-wait
                continue
            finally:
                with self.lock:
                    self._active_getters -= 1
            if not ready:
                continue
            if self._wake_r in ready:
                try:
                    while os.read(self._wake_r, 4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
            by_conn = {w.conn: w for w in watch}
            with self.lock:
                for obj in ready:
                    w = by_conn.get(obj)
                    if w is not None:
                        self._drain_conn_locked(w)

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float]
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError(f"num_returns={num_returns} exceeds number of "
                             f"refs ({len(refs)})")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while True:
                done = [r for r in refs if self._ready_locked(r.oid.binary)]
                if len(done) >= num_returns:
                    done = done[:num_returns]
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self.cv.wait(remaining)
        done_set = set(done)
        return done, [r for r in refs if r not in done_set]

    # --------------------------------------------------- elasticity

    def stats(self) -> Dict[str, int]:
        """Scheduler load snapshot (the autoscaler's demand signal —
        ``monitor.py``/``resource_demand_scheduler`` read the same shape
        of data from the GCS in the reference)."""
        with self.lock:
            # only dep-resolved stateless tasks can drain onto new task
            # workers — dep-blocked or actor-bound work must not drive
            # up-scaling (it wouldn't dispatch to the added workers);
            # the ready queues hold exactly those (skipping stale ids)
            ready = sum(1 for q in self._ready_q.values()
                        for tid in q
                        if tid in self.pending and tid in self.specs)
            return {
                "num_workers": len(self.task_workers),
                "pending": len(self.pending),
                "pending_ready": ready,
                "inflight": sum(len(w.inflight)
                                for w in self.task_workers),
                "num_actors": len(self.actors),
            }

    def add_worker(self) -> int:
        """Grow the pool by one (autoscaler up-scale)."""
        with self.lock:
            if self._shutdown:
                raise RuntimeError("runtime is shut down")
            # _make_ctx, not the init-time ctx: torch may have been
            # imported since (fork → spawn re-pick, see __init__)
            w = _Worker(self._make_ctx(), self.store_name)
            self.task_workers.append(w)
            self._push_idle_locked(w)
            M_WORKERS_ALIVE.set(len(self.task_workers))
            self.cv.notify_all()
            self._dispatch_locked()
            return w.wid

    def remove_idle_worker(self) -> bool:
        """Retire one idle worker (autoscaler down-scale). Only workers
        with no inflight tasks are eligible, so nothing needs replay;
        returns False when every worker is busy or the pool is at 1."""
        with self.lock:
            if len(self.task_workers) <= 1:
                return False
            for i, w in enumerate(self.task_workers):
                if not w.inflight and w.reserved_by is None:
                    self.task_workers.pop(i)
                    w.retired = True     # idle-deque entries go stale
                    M_WORKERS_ALIVE.set(len(self.task_workers))
                    victim = w
                    break
            else:
                return False
        try:
            self._send(victim, ("exit",))
        except Exception:
            pass
        victim.proc.join(timeout=0.5)      # let the graceful exit land
        if victim.proc.is_alive():
            victim.kill()
        try:
            victim.conn.close()            # no fd leak across scale cycles
        except Exception:
            pass
        return True

    def shutdown(self) -> None:
        with self.lock:
            if self._shutdown:
                return
            self._shutdown = True
            M_WORKERS_ALIVE.set(0)
            workers = list(self.task_workers) + [r.worker
                                                 for r in self.actors.values()]
            self.cv.notify_all()   # wake blocked placement-group waiters
        if self._memmon is not None:
            self._memmon.stop()
        for w in workers:
            self._send(w, ("exit",))
        self._sendq.put(None)
        self._sender.join(timeout=2.0)
        self._thread.join(timeout=2.0)
        for w in workers:
            w.proc.join(timeout=1.0)
            if w.proc.is_alive():
                w.kill()
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        self.store.close()

    # ------------------------------------------------------------ internals

    def _new_ref(self) -> ObjectRef:
        """Mint an ObjectRef whose driver-table entry dies with it
        (single-process reference counting, `reference_count.cc` role)."""
        ref = ObjectRef(ObjectID.random())
        weakref.finalize(ref, self._release_oid, ref.oid.binary)
        return ref

    def _release_oid(self, key: bytes) -> None:
        if self._shutdown:
            return
        try:
            with self.lock:
                self.inline.pop(key, None)
                self.errors.pop(key, None)
                self.lineage.pop(key, None)
                self._recon_attempts.pop(key, None)
                self._reconstructing.discard(key)
                if key in self.in_store:
                    self.in_store.discard(key)
                    self.store.delete(ObjectID(key))
        except Exception:
            pass  # interpreter teardown / store already closed

    # ------------------------------------------- recovery: spill + lineage

    def spill_under_pressure(self, target_fraction: float = 0.5) -> int:
        """Demote store-resident objects to disk until usage is under
        ``target_fraction`` of capacity. Spilled objects stay "ready"
        (the store restores them transparently on get), so this turns
        memory pressure into a slow path instead of evicting data."""
        with self.lock:
            keys = list(self.in_store)
        spilled = 0
        try:
            used, _, cap = self.store.stats()
            for key in keys:
                if cap == 0 or used <= cap * target_fraction:
                    break
                oid = ObjectID(key)
                if self.store.contains_shm(oid) and self.store.spill(oid):
                    spilled += 1
                    M_SPILLS.inc()
                    used, _, cap = self.store.stats()
        except Exception:
            pass  # pressure relief is best-effort, never fatal
        return spilled

    def _begin_reconstruction(self, key: bytes) -> Optional[BaseException]:
        """Kick off lineage reconstruction of ``key`` if needed.

        Returns None when the caller should keep waiting (reconstruction
        started or already in flight, or the object turned out to be
        readable after all), or the typed error to raise."""
        with self.lock:
            if key in self.errors or key in self.inline:
                return None          # resolved meanwhile; caller re-checks
            if key in self._reconstructing:
                return None          # someone else is already healing it
            if self.store.contains(ObjectID(key)):
                return None          # restored meanwhile (spill tier)
            if not self.reconstruction:
                return ObjectLostError(
                    f"object {key.hex()[:12]} lost from store (evicted "
                    "under memory pressure?); reconstruction is disabled")
            err = self._start_reconstruction_locked(key)
            if err is None:
                self.cv.notify_all()
            return err

    def _start_reconstruction_locked(self, key: bytes
                                     ) -> Optional[BaseException]:
        """Plan + apply reconstruction of ``key`` (lock held).

        Two-phase so a non-reconstructible ancestor is discovered BEFORE
        any bookkeeping is mutated — a failed plan leaves no
        partially-resolved state behind.
        """
        try:
            planned = self._plan_reconstruction_locked(key, depth=0,
                                                       planned=[])
        except ObjectLostError as e:
            return e
        # apply: retract the stale in_store markers first, so dep
        # resolution below sees missing ancestors as pending deps
        for k in planned:
            self._reconstructing.add(k)
            self.in_store.discard(k)
            self._recon_attempts[k] = self._recon_attempts.get(k, 0) + 1
        for k in planned:
            lin = self.lineage[k]
            spec = TaskSpec(
                task_id=common.fast_token(16), fn_id=lin.fn_id, method=None,
                actor_id=None, args=lin.args, kwargs=lin.kwargs,
                # driver-internal ref: deliberately NO finalizer (the
                # user's original ObjectRef owns this entry's lifetime)
                result_ref=ObjectRef(ObjectID(k)),
                retries_left=self.max_task_retries,
                deps=self._unresolved_deps_locked(lin.args, lin.kwargs))
            self.specs[spec.task_id] = spec
            self._admit_spec_locked(spec, front=True)
            M_RECONSTRUCTIONS.inc()
        self._dispatch_locked()
        return None

    def _plan_reconstruction_locked(self, key: bytes, depth: int,
                                    planned: List[bytes]) -> List[bytes]:
        """DFS over missing ancestors; raises ObjectLostError when any
        required object has no lineage or a budget is exhausted."""
        if depth > common.MAX_RECONSTRUCTION_DEPTH:
            raise ObjectLostError(
                f"object {key.hex()[:12]} lost from store: reconstruction "
                f"needs more than {common.MAX_RECONSTRUCTION_DEPTH} "
                "lineage levels")
        if key in planned or key in self._reconstructing:
            return planned
        lin = self.lineage.get(key)
        if lin is None:
            raise ObjectLostError(
                f"object {key.hex()[:12]} lost from store and has no "
                "lineage (puts and actor-call results are not "
                "reconstructible)")
        if self._recon_attempts.get(key, 0) >= \
                common.MAX_RECONSTRUCTION_ATTEMPTS:
            raise ObjectLostError(
                f"object {key.hex()[:12]} lost from store: "
                f"{common.MAX_RECONSTRUCTION_ATTEMPTS} reconstruction "
                "attempts exhausted")
        planned.append(key)
        for v in list(lin.args) + list(lin.kwargs.values()):
            if not isinstance(v, ObjectRef):
                continue
            dkey = v.oid.binary
            if dkey in self.inline or dkey in self.errors:
                continue             # dispatch-time materialization handles it
            if dkey in self.in_store and \
                    not self.store.contains(ObjectID(dkey)):
                self._plan_reconstruction_locked(dkey, depth + 1, planned)
            elif dkey not in self.in_store and \
                    dkey not in self._reconstructing and \
                    not any(s.result_ref.oid.binary == dkey
                            for s in self.specs.values()):
                # the ancestor's driver entry is gone entirely (released)
                raise ObjectLostError(
                    f"object {key.hex()[:12]} lost from store: ancestor "
                    f"{dkey.hex()[:12]} was released and cannot be "
                    "re-derived")
        return planned

    def _recover_lost_dep_locked(self, spec: TaskSpec,
                                 cause: DependencyLostError) -> bool:
        """A worker reported a task dep missing from the store: rebuild
        the dep through lineage and requeue the task (no retry charge —
        the task is a victim, not a crash). False = not recoverable."""
        if not self.reconstruction:
            return False
        try:
            dkey = bytes.fromhex(cause.key_hex)
        except ValueError:
            return False
        if dkey in self.errors:
            return False
        if dkey not in self._reconstructing and \
                not self.store.contains(ObjectID(dkey)):
            if self._start_reconstruction_locked(dkey) is not None:
                return False
        spec.deps = {ObjectRef(ObjectID(dkey))}
        self._admit_spec_locked(spec, front=True)
        self.cv.notify_all()
        self._dispatch_locked()
        return True

    def _wake_getters(self) -> None:
        """One nonblocking byte on the completion wake pipe: unblocks
        any getter waiting in ``mpc.wait`` on pipes with no traffic
        (the completion was applied by a different thread). A full pipe
        just means wakeups are already pending — dropped safely.

        Skipped when no getter is blocked (callers hold the lock, so
        ``_active_getters`` is exact): in the common case the completer
        IS the getter — it already left its wait before draining, and a
        stray byte would cost it a spurious wake/read cycle on its very
        next get."""
        if not self._active_getters:
            return
        try:
            os.write(self._wake_w, b"\0")
        except (BlockingIOError, OSError):
            pass

    def _send(self, w: _Worker, msg: tuple) -> None:
        """Queue a pipe write for the sender thread (never blocks)."""
        with w.nq_lock:
            w.nqueued += 1
        self._sendq.put((w, msg))

    def _direct_send(self, w: _Worker, msg: tuple) -> None:
        """Write ``msg`` to ``w``'s pipe from the calling thread — the
        sync-latency fast path: no sender-thread hop (one fewer GIL
        handoff per dispatch). MUST be called WITHOUT the runtime lock
        (a blocking pipe write under the lock could deadlock against the
        draining scheduler). Falls back to the queue whenever the worker
        has queued messages or its pipe is busy (FIFO preserved)."""
        if w.send_lock.acquire(blocking=False):
            try:
                with w.nq_lock:
                    clear = w.nqueued == 0
                if clear:
                    try:
                        w.conn.send(msg)
                    except Exception:
                        pass  # dead worker: sentinel handling replays
                    return
            finally:
                w.send_lock.release()
        self._send(w, msg)

    def _sender_loop(self) -> None:
        """Drain the send queue and coalesce per-worker runs into one
        ``("batch", [msgs])`` pipe write — batched pipe I/O: a burst of
        N task submissions costs one syscall per worker, not N. Per-
        worker FIFO order is preserved (groups are built in scan order);
        cross-worker order was never guaranteed."""
        while True:
            item = self._sendq.get()
            stop = False
            groups: "OrderedDict[_Worker, list]" = OrderedDict()
            while True:
                if item is None:
                    stop = True
                    break
                w, msg = item
                groups.setdefault(w, []).append(msg)
                try:
                    item = self._sendq.get_nowait()
                except queue.Empty:
                    break
            for w, msgs in groups.items():
                # send under the worker's pipe lock (serializes with
                # direct senders), then retire the owed-message count —
                # decrementing only after the write keeps the direct
                # path closed until the pipe really is caught up
                with w.send_lock:
                    try:
                        if len(msgs) == 1:
                            w.conn.send(msgs[0])
                        else:
                            w.conn.send(("batch", msgs))
                    except Exception:
                        pass  # dead worker: sentinel handling replays
                with w.nq_lock:
                    w.nqueued -= len(msgs)
            if stop:
                return

    def _unresolved_deps(self, args, kwargs) -> Set[ObjectRef]:
        with self.lock:
            return self._unresolved_deps_locked(args, kwargs)

    def _unresolved_deps_locked(self, args, kwargs) -> Set[ObjectRef]:
        deps = set()
        for v in args:
            if isinstance(v, ObjectRef) and \
                    not self._ready_locked(v.oid.binary):
                deps.add(v)
        for v in kwargs.values():
            if isinstance(v, ObjectRef) and \
                    not self._ready_locked(v.oid.binary):
                deps.add(v)
        return deps

    def _ready_locked(self, key: bytes) -> bool:
        return key in self.inline or key in self.in_store or key in self.errors

    def _materialize_arg(self, v):
        """Substitute a ready ObjectRef: inline value or store marker.

        Like the reference, only *top-level* args are resolved
        (``direct_task_transport.cc`` dependency resolver behaviour).
        Zero-copy: an inline object is forwarded in its already-
        serialized ``(kind, parts)`` form — no ``loads_parts`` +
        re-``dumps`` per dispatch; the worker deserializes once (which
        copies, so the value never aliases driver state).
        """
        if not isinstance(v, ObjectRef):
            return v
        key = v.oid.binary
        if key in self.errors:
            raise self.errors[key]
        entry = self.inline.get(key)
        if entry is not None:
            return common.InlineParts(entry[0], entry[1])
        return StoreRef(key)

    def _dispatch_locked(self) -> None:
        """Push ready tasks to idle workers: O(dispatched + stale ids),
        with no scan of blocked tasks or the worker list. The outer loop
        re-snapshots because failing a task mid-dispatch can publish its
        error and wake dependants into a queue already visited."""
        if self._shutdown:
            return
        while True:
            self._enqueued_during_dispatch = False
            for key in list(self._ready_q):
                q = self._ready_q.get(key)
                while q:
                    spec = self.pending.get(q[0])
                    if spec is None or spec.task_id not in self.specs:
                        tid = q.popleft()   # stale: cancelled/expired/failed
                        self.pending.pop(tid, None)
                        continue
                    w = self._pop_worker_locked(key)
                    if w is None:
                        break               # pool saturated; next pool
                    q.popleft()
                    self.pending.pop(spec.task_id, None)
                    try:
                        self._send_task_locked(w, spec)
                    except BaseException as e:  # a dep errored → propagate
                        self._fail_task_locked(spec, e)
                    self._push_idle_locked(w)
                if not q:
                    self._ready_q.pop(key, None)
            if not self._enqueued_during_dispatch:
                return

    def _send_task_locked(self, w: _Worker, spec: TaskSpec,
                          allow_direct: bool = False) -> Optional[tuple]:
        """Book ``spec`` onto ``w`` and ship (or hand back) its message.

        With ``allow_direct=True`` and no companion control message
        (fn registration, snapshot request), the task message is
        RETURNED instead of queued — the caller sends it via
        :meth:`_direct_send` after releasing the runtime lock (the
        sync-latency fast path). All bookkeeping happens here either
        way, so the two paths cannot diverge.
        """
        args = tuple(self._materialize_arg(a) for a in spec.args)
        kwargs = {k: self._materialize_arg(v) for k, v in spec.kwargs.items()}
        blob = common.dumps_args((args, kwargs))
        # direct pipe writes only pay off for a latency-sensitive single
        # dispatch onto an idle worker; under a burst (worker already has
        # work in flight) the coalescing sender thread wins by an order
        # of magnitude — one pipe write per batch, not per task
        allow_direct = allow_direct and not w.inflight
        direct: Optional[tuple] = None
        if spec.actor_id is not None:
            msg = ("actor_call", spec.task_id, spec.method,
                   spec.result_ref.oid.binary, blob)
            rec = self.actors.get(spec.actor_id)
            if rec is not None and rec.restore_state and rec.worker is w:
                # record the call for replay-on-restart; the pipe is
                # FIFO, so a snapshot requested now covers exactly the
                # calls sent so far (cutoff = current send ordinal).
                # restore_state actors always ride the queue: the
                # snapshot request MUST follow this call on the pipe
                self._send(w, msg)
                rec.call_seq += 1
                rec.replay_log.append((rec.call_seq, spec.method, blob))
                if rec.snapshot_unavailable:
                    del rec.replay_log[:-rec.REPLAY_LOG_CAP]
                elif (rec.snapshot_cutoff is None
                        and len(rec.replay_log) >= rec.snapshot_every):
                    rec.snapshot_cutoff = rec.call_seq
                    self._send(w, ("actor_snapshot",))
            elif allow_direct:
                direct = msg
            else:
                self._send(w, msg)
        else:
            msg = ("task", spec.task_id, spec.fn_id,
                   spec.result_ref.oid.binary, blob)
            if spec.fn_id not in w.known_fns:
                # registration must precede the task on the pipe, so
                # both ride the (FIFO) sender queue together
                self._send(w, ("reg_fn", spec.fn_id,
                               self.fn_blobs[spec.fn_id]))
                w.known_fns.add(spec.fn_id)
                self._send(w, msg)
            elif allow_direct:
                direct = msg
            else:
                self._send(w, msg)
        if not w.inflight:
            # head task starts now — an idle worker isn't "stalled"
            w.last_progress = time.monotonic()
        w.inflight.append(spec.task_id)
        act = _chaos.fire("runtime.dispatch",
                          target="actor" if spec.actor_id is not None
                          else "task", worker=w.wid)
        if act is not None and act["action"] == "kill_worker":
            # chaos: the worker dies mid-task; the sentinel/heartbeat
            # path replays its in-flight work (charging a retry)
            w.kill()
        return direct

    def _fail_task_locked(self, spec: TaskSpec, err: BaseException,
                          ready_stack: Optional[List[bytes]] = None) -> None:
        rkey = spec.result_ref.oid.binary
        self.errors[rkey] = err
        self._reconstructing.discard(rkey)
        self.specs.pop(spec.task_id, None)
        self.pending.pop(spec.task_id, None)
        self.deadlined.discard(spec.task_id)
        M_TASKS_FINISHED.inc(labels=[type(err).__name__])
        # the error IS this ref's result: wake dependants (either onto
        # the caller's in-progress publish worklist, or directly)
        if ready_stack is not None:
            ready_stack.append(rkey)
        else:
            self._publish_ready_locked(rkey)
        self._wake_getters()
        self.cv.notify_all()

    def _complete_locked(self, w: _Worker, tid: bytes, kind: str,
                         payload, defer: bool = False) -> None:
        """Apply one task completion. ``defer=True`` (batch drain) skips
        the per-result notify/dispatch — the caller does both once per
        drained batch."""
        if tid in w.inflight:
            w.inflight.remove(tid)
            self._push_idle_locked(w)
        spec = self.specs.pop(tid, None)
        if spec is None:
            return
        self.deadlined.discard(tid)
        rkey = spec.result_ref.oid.binary
        self._completed[tid] = (kind, rkey)
        while len(self._completed) > common.MAX_COMPLETED_TIDS:
            self._completed.popitem(last=False)
        if kind == "inline":
            self.inline[rkey] = payload
        if kind == "inline" or kind == "store":
            if kind == "store":
                self.in_store.add(rkey)
                self._evicted.discard(rkey)
            if spec.fn_id is not None:
                # remember how to re-derive this object (lineage);
                # bounded FIFO — an evicted entry's object can no longer
                # be reconstructed, only re-read while it survives.
                # Inline results get lineage too: they cannot be lost
                # from the driver table, but recording the producer keeps
                # the healing bookkeeping uniform
                self.lineage[rkey] = _Lineage(spec.fn_id, spec.args,
                                              spec.kwargs)
                self.lineage.move_to_end(rkey)
                while len(self.lineage) > common.MAX_LINEAGE_ENTRIES:
                    self.lineage.popitem(last=False)
        if kind == "store":
            act = _chaos.fire("runtime.store")
            if act is not None and act["action"] == "evict_object":
                # chaos: memory-pressure eviction of a sealed result —
                # a later get() transparently re-executes the producing
                # task (lineage reconstruction), or raises the typed
                # ObjectLostError when reconstruction is off/exhausted.
                # Pressure eviction NEVER takes a pinned object (a live
                # mapping makes "lost but pinned" impossible by
                # construction — the eviction just picks another victim,
                # here: skips), so reconstruction can't race a consumer
                try:
                    if self.store.delete_if_unpinned(ObjectID(rkey)):
                        self._evicted.add(rkey)
                except Exception:
                    pass
        self._reconstructing.discard(rkey)
        M_TASKS_FINISHED.inc(labels=["ok"])
        self._publish_ready_locked(rkey)
        self._wake_getters()
        if not defer:
            self.cv.notify_all()
            self._dispatch_locked()

    def _scheduler_loop(self) -> None:
        while True:
            with self.lock:
                if self._shutdown:
                    return
                workers = list(self.task_workers) + [
                    r.worker for r in self.actors.values() if not r.dead]
                conn_by_fd = {w.conn: w for w in workers}
                sent_by_fd = {w.proc.sentinel: w for w in workers}
                # active getters drain the pipes themselves: watch only
                # the sentinels then, so one result doesn't wake two
                # threads racing for the same lock and messages
                wait_conns = ([] if self._active_getters
                              else list(conn_by_fd))
            try:
                ready = mpc.wait(wait_conns + list(sent_by_fd),
                                 timeout=common.HEARTBEAT_INTERVAL_S)
            except OSError:
                ready = []
            with self.lock:
                if self._shutdown:
                    return
                for obj in ready:
                    if obj in conn_by_fd:
                        self._drain_conn_locked(conn_by_fd[obj])
                for obj in ready:
                    if obj in sent_by_fd:
                        self._handle_death_locked(sent_by_fd[obj])
                # heartbeat-style sweep (catches deaths missed by sentinels)
                for w in workers:
                    if not w.alive() and (w.inflight or w.actor_id):
                        self._handle_death_locked(w)
                self._deliver_delayed_locked()
                self._expire_deadlines_locked()
                self._steal_from_stalled_locked()

    def _deliver_delayed_locked(self) -> None:
        """Deliver chaos-delayed result messages whose time has come."""
        if not self._delayed_results:
            return
        now = time.monotonic()
        mature = [e for e in self._delayed_results if e[0] <= now]
        if not mature:
            return
        self._delayed_results = [e for e in self._delayed_results
                                 if e[0] > now]
        for _, w, (tid, rkind, payload) in mature:
            w.last_progress = time.monotonic()
            self._complete_locked(w, tid, rkind, payload)

    def _expire_deadlines_locked(self) -> None:
        """Fail every task past its deadline with DeadlineExceeded.

        Fail-fast only: the executing worker is left alone (its late
        completion is discarded because the spec is gone), so deadlines
        bound caller latency without wasting a worker respawn."""
        if not self.deadlined:
            return
        now = time.monotonic()
        expired = []
        for tid in list(self.deadlined):
            spec = self.specs.get(tid)
            if spec is None:                 # finished/failed since
                self.deadlined.discard(tid)
            elif now > spec.deadline:
                self.deadlined.discard(tid)
                expired.append(spec)
        if not expired:
            return
        for spec in expired:
            # NOTE: the task_id stays in its worker's inflight list — the
            # worker really is still grinding it, and lying about that
            # would route fresh tasks onto a busy/hung worker. The entry
            # clears when the late done/err arrives (spec already gone →
            # discarded), and a never-finishing task keeps the worker
            # marked stalled so the steal path works around it.
            self._fail_task_locked(spec, DeadlineExceeded(
                "task exceeded its deadline before completing"))
        self.cv.notify_all()
        self._dispatch_locked()

    def _steal_from_stalled_locked(self) -> None:
        """Reclaim unstarted tasks queued behind a long-running one.

        The worker executes FIFO and reports each completion before starting
        the next, so after draining its pipe everything past inflight[0] is
        unstarted (modulo a tiny race — a doubly-executed task resolves to
        the same immutable object, at-least-once like the reference's
        retries). Plays the role of raylet work-stealing/lease rebalancing.
        """
        now = time.monotonic()
        stole = False
        for w in self.task_workers:
            if len(w.inflight) > 1 and \
                    now - w.last_progress > common.STEAL_AFTER_S:
                stolen = w.inflight[1:]
                del w.inflight[1:]
                for tid in reversed(stolen):
                    spec = self.specs.get(tid)
                    if spec is not None:
                        self._admit_spec_locked(spec, front=True)
                        stole = True
        if stole:
            self._dispatch_locked()

    def _drain_conn_locked(self, w: _Worker) -> None:
        """Drain EVERY pending message from one worker pipe under the
        single already-held lock acquisition — batched pipe I/O's receive
        half: one ``cv.notify_all`` and one dispatch per drained batch,
        not per result. Workers may coalesce results into a
        ``("batch", [msgs])`` envelope; it is unpacked here in order."""
        dirty = False
        try:
            while w.conn.poll():
                msg = w.conn.recv()
                msgs = msg[1] if msg[0] == "batch" else (msg,)
                for m in msgs:
                    applied = self._handle_msg_locked(w, m)
                    if applied is None:
                        return          # chaos killed the worker mid-batch
                    dirty = dirty or applied
        except (EOFError, OSError):
            self._handle_death_locked(w)
        finally:
            if dirty:
                self.cv.notify_all()
                self._dispatch_locked()

    def _handle_msg_locked(self, w: _Worker, msg: tuple) -> Optional[bool]:
        """Apply one worker→driver message. Returns True when it changed
        completion state (caller notifies/dispatches once per batch),
        False when it did not, None when the worker was chaos-killed and
        the rest of its batch must be discarded."""
        kind = msg[0]
        if kind == "ready":
            w.ready = True
            return True
        elif kind == "done":
            _, tid, rkind, payload = msg
            if tid not in self.specs and tid in self._completed:
                # at-least-once duplicate: the task was stolen (or
                # replayed) AND the original worker finished it too.
                # Drop it — never re-put, never re-record lineage — so
                # a stolen-then-finished task cannot resurrect an
                # evicted object and skew recovery determinism.
                return self._drop_duplicate_done_locked(w, tid, rkind)
            act = _chaos.fire("runtime.result",
                              target="actor" if w.actor_id
                              else "task", worker=w.wid)
            if act is not None and act["action"] == "drop_result":
                # chaos: the completion message is lost in
                # transit AND the worker dies — the death
                # handler replays the task (at-least-once,
                # like the reference's retry semantics)
                w.kill()
                return None
            if act is not None and act["action"] == "delay_result":
                # chaos: the message is in-flight for delay_s —
                # parked for later delivery, NOT slept on (this
                # code runs under the runtime lock; sleeping here
                # would freeze the whole scheduler, which is a
                # different fault than "one result delayed")
                self._delayed_results.append(
                    (time.monotonic() + act["delay_s"], w,
                     (tid, rkind, payload)))
                return False
            w.last_progress = time.monotonic()
            self._complete_locked(w, tid, rkind, payload, defer=True)
            return True
        elif kind == "err":
            _, tid, blob, tb = msg
            w.last_progress = time.monotonic()
            if tid in w.inflight:
                w.inflight.remove(tid)
                self._push_idle_locked(w)
            spec = self.specs.get(tid)
            if spec is not None:
                try:
                    cause = common.loads(blob)
                except Exception as e:  # undeserializable exception
                    cause = RuntimeError(f"(unpicklable) {e}")
                if (isinstance(cause, DependencyLostError)
                        and spec.actor_id is None
                        and self._recover_lost_dep_locked(spec, cause)):
                    return True   # dep rebuilt, task requeued
                self._fail_task_locked(spec, TaskError(cause, tb))
            return True
        elif kind == "snapshot":
            _, blob = msg
            rec = self.actors.get(w.actor_id)
            if rec is not None and rec.worker is w:
                rec.snapshot_blob = blob
                cutoff = rec.snapshot_cutoff or 0
                rec.snapshot_cutoff = None
                rec.replay_log = [e for e in rec.replay_log
                                  if e[0] > cutoff]
        elif kind == "snapshot_err":
            rec = self.actors.get(w.actor_id)
            if rec is not None and rec.worker is w:
                # unpicklable actor state: fall back to (bounded)
                # full method replay — restart becomes best-effort
                rec.snapshot_cutoff = None
                rec.snapshot_unavailable = True
        elif kind == "actor_ready":
            pass
        elif kind == "actor_err":
            _, blob, tb = msg
            rec = self.actors.get(w.actor_id)
            if rec is not None:
                rec.dead = True
                try:
                    cause = common.loads(blob)
                except Exception:
                    cause = RuntimeError("actor init failed")
                err = TaskError(cause, tb)
                self._fail_actor_tasks_locked(w.actor_id, err)
                return True
        return False

    def _drop_duplicate_done_locked(self, w: _Worker, tid: bytes,
                                    rkind: str) -> bool:
        """Discard a "done" for an already-completed task id.

        The reporting worker's bookkeeping still advances (inflight slot
        freed, progress clock bumped) but completion state does NOT: the
        first "done" already recorded inline/in_store and lineage. A
        "store"-kind duplicate has already re-put the result object
        worker-side (``robust_store_put_parts`` runs before the message
        is sent); when the driver's copy is gone — ref released, or
        deliberately evicted under chaos/memory pressure — that re-put
        is a resurrection that would make a later ``get()`` silently
        skip lineage reconstruction, so it is deleted here."""
        if tid in w.inflight:
            w.inflight.remove(tid)
            self._push_idle_locked(w)
        w.last_progress = time.monotonic()
        _, rkey = self._completed[tid]
        # never delete under an in-flight reconstruction: the healing
        # task re-puts the SAME object id, and racing its completion
        # here would destroy the freshly rebuilt result
        if rkind == "store" and rkey not in self._reconstructing \
                and (rkey not in self.in_store or rkey in self._evicted):
            try:
                # pin-safe: a consumer that mapped the re-put object in
                # the meantime keeps it (identical bytes either way)
                self.store.delete_if_unpinned(ObjectID(rkey))
            except Exception:
                pass
        return True

    def _fail_actor_tasks_locked(self, actor_id: bytes,
                                 err: BaseException) -> None:
        for spec in [s for s in self.specs.values()
                     if s.actor_id == actor_id]:
            self._fail_task_locked(spec, err)
        self.cv.notify_all()

    def _handle_death_locked(self, w: _Worker) -> None:
        if w.actor_id is not None:
            rec = self.actors.get(w.actor_id)
            if rec is None or rec.worker is not w:
                return
            # in-flight calls on the dead process fail (ray semantics)
            for tid in list(w.inflight):
                spec = self.specs.get(tid)
                if spec is not None:
                    self._fail_task_locked(spec, ActorDiedError(
                        "actor process died mid-call"))
            w.inflight.clear()
            self.cv.notify_all()
            if rec.dead:
                return
            if rec.restarts < rec.max_restarts:
                # restart policy: python/ray/actor.py:269-280 max_restarts
                rec.restarts += 1
                M_ACTORS.inc(labels=["restarted"])
                rec.worker = _Worker(self._make_ctx(), self.store_name,
                                     actor_id=w.actor_id)
                self._send(rec.worker, ("actor_init", rec.init_blob))
                if rec.restore_state:
                    # restore state, not just the process: latest
                    # snapshot, then replay the calls sent since (FIFO
                    # pipe ⇒ applied before any new call). Calls that
                    # were in flight at the crash ARE replayed even
                    # though their callers saw ActorDiedError —
                    # at-least-once, like task retries
                    rec.snapshot_cutoff = None  # request died with worker
                    if rec.snapshot_blob is not None:
                        self._send(rec.worker,
                                   ("actor_restore", rec.snapshot_blob))
                    for _, method, blob in rec.replay_log:
                        self._send(rec.worker,
                                   ("actor_replay", method, blob))
                    M_ACTORS.inc(labels=["state_restored"])
                self._dispatch_locked()
            else:
                rec.dead = True
                self._unpark_for_actor_locked(w.actor_id)
                self._fail_actor_tasks_locked(
                    w.actor_id, ActorDiedError("actor died; restarts "
                                               "exhausted"))
            return
        # stateless task worker: replay or fail its in-flight tasks, respawn
        if w in self.task_workers:
            self.task_workers.remove(w)
            w.retired = True
            for tid in reversed(list(w.inflight)):
                spec = self.specs.get(tid)
                if spec is None:
                    continue
                if spec.retries_left > 0:
                    spec.retries_left -= 1
                    self._admit_spec_locked(spec, front=True)
                else:
                    self._fail_task_locked(spec, WorkerCrashedError(
                        "worker died executing task; retries exhausted"))
            w.inflight.clear()
            if not self._shutdown:
                repl = _Worker(self._make_ctx(), self.store_name)
                # a reserved worker's replacement inherits the gang slot
                repl.reserved_by = w.reserved_by
                repl.parked = w.parked
                self.task_workers.append(repl)
                self._push_idle_locked(repl)
            M_WORKERS_ALIVE.set(len(self.task_workers))
            self.cv.notify_all()
            self._dispatch_locked()
