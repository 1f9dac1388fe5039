"""SLO-aware admission control with priority classes.

The pre-control-plane overload story was the circuit breaker: pile
requests into the router until enough of them fail, then reject
everything for a cool-down. This module replaces that failure mode with
*admission* semantics (the Envoy admission-control / Ray Serve
``max_queued_requests`` role):

- **Estimated-wait shedding.** Each deployment declares an
  :class:`SLOConfig` — a latency budget and an estimated per-request
  service time. At admission the router computes the wait a new request
  would see behind the current queue; when that estimate exceeds the
  budget the request is rejected IMMEDIATELY with a typed
  :class:`Overloaded` carrying ``retry_after`` — the client backs off
  with a number, the queue never builds into a breaker trip, and the
  breaker is reserved for what it means (the backend is *failing*, not
  merely busy).
- **Priority classes.** Admitted requests acquire a dispatch slot from
  a :class:`PriorityGate` (capacity = replicas ×
  ``target_inflight_per_replica``). Slots free up highest-class-first
  (decode steps preempt bulk encode in the router queue), FIFO within a
  class — and a waiter older than ``aging_s`` jumps every class, so
  sustained decode load cannot starve bulk encode forever.
- **Typed taxonomy.** ``Overloaded`` (busy now, retry after),
  :class:`~tosem_tpu_torch.cluster.node.NodeDrainingError` (this node is
  leaving, route elsewhere),
  :class:`~tosem_tpu_torch.serve.breaker.CircuitOpen` (the deployment is
  failing) — three different verdicts a client can
  act on, never one undifferentiated timeout.

Per-class shed counters feed ``serve_admission_shed_total`` in
:mod:`tosem_tpu_torch.obs.metrics` (and the ``/-/stats`` rollup). Clocks are
injectable so admission tests are instant and deterministic — the same
replayability contract as the breaker and :mod:`tosem_tpu_torch.chaos`.
"""
from __future__ import annotations

import heapq
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class Overloaded(RuntimeError):
    """Typed load-shed verdict: the deployment cannot meet its latency
    budget for this request RIGHT NOW. Not a failure of the backend
    (that is CircuitOpen's job) and not a dead node (NodeLostError) —
    retry after ``retry_after`` seconds."""

    def __init__(self, message: str, retry_after: float = 0.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


@dataclass
class SLOConfig:
    """Per-deployment admission contract.

    ``latency_budget_s`` is the wait a request may be asked to absorb
    before dispatch; ``est_service_s`` the planning estimate of one
    request's service time (the conversion from queue length to wait).
    ``classes`` maps request class names to priority ranks (higher
    preempts); unknown classes rank 0. ``aging_s`` bounds starvation:
    a waiter older than this is admitted before ANY class rank
    (0 disables aging — strict priority)."""

    latency_budget_s: float = 1.0
    est_service_s: float = 0.05
    target_inflight_per_replica: int = 2
    classes: Dict[str, int] = field(default_factory=dict)
    aging_s: float = 0.0

    def priority_of(self, klass: Optional[str]) -> int:
        if klass is None:
            return 0
        return int(self.classes.get(klass, 0))

    def to_dict(self) -> Dict[str, Any]:
        return {"latency_budget_s": self.latency_budget_s,
                "est_service_s": self.est_service_s,
                "target_inflight_per_replica":
                    self.target_inflight_per_replica,
                "classes": dict(self.classes),
                "aging_s": self.aging_s}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOConfig":
        return cls(latency_budget_s=float(d.get("latency_budget_s", 1.0)),
                   est_service_s=float(d.get("est_service_s", 0.05)),
                   target_inflight_per_replica=int(
                       d.get("target_inflight_per_replica", 2)),
                   classes={str(k): int(v)
                            for k, v in (d.get("classes") or {}).items()},
                   aging_s=float(d.get("aging_s", 0.0)))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


class _Waiter:
    __slots__ = ("priority", "seq", "t0", "event", "granted", "dropped")

    def __init__(self, priority: int, seq: int, t0: float):
        self.priority = priority
        self.seq = seq
        self.t0 = t0
        self.event = threading.Event()
        self.granted = False
        self.dropped = False


class PriorityGate:
    """Bounded dispatch-slot gate with class preemption and aging.

    ``acquire`` grants immediately while slots are free AND no one is
    queued (arrivals never overtake a non-empty queue — that is the
    FIFO-fairness contract); otherwise the caller waits. Every
    ``release`` hands its slot to the *best* waiter: any waiter older
    than ``aging_s`` first (oldest of those), else highest priority,
    arrival order within a class. Capacity is mutable — the control
    plane resizes the gate as replicas scale."""

    def __init__(self, capacity: int, aging_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        self._capacity = capacity
        self._aging_s = aging_s
        self._clock = clock
        self._inflight = 0
        self._seq = itertools.count()
        # heap of (-priority, seq, waiter): pop order = class rank then
        # arrival; aged waiters are found by linear scan (the queue is
        # bounded by admission, so the scan is tiny)
        self._heap: list = []

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    def set_capacity(self, capacity: int) -> None:
        """Resize (autoscaling moved the replica count). Growth wakes
        newly-admissible waiters immediately."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        with self._lock:
            self._capacity = capacity
            self._grant_locked()

    def waiting(self) -> int:
        with self._lock:
            self._compact_locked()
            # count LIVE waiters only: aged grants and timed-out drops
            # compact lazily from the heap top, and a phantom entry
            # counted here would inflate the admission wait estimate
            # into spurious sheds (the heap is admission-bounded, so
            # the scan is tiny — same tradeoff as the aged scan)
            return sum(1 for _, _, w in self._heap
                       if not (w.granted or w.dropped))

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _compact_locked(self) -> None:
        while self._heap and (self._heap[0][2].dropped
                              or self._heap[0][2].granted):
            heapq.heappop(self._heap)

    def _pop_best_locked(self) -> Optional[_Waiter]:
        self._compact_locked()
        if not self._heap:
            return None
        if self._aging_s > 0:
            now = self._clock()
            aged = [w for _, _, w in self._heap
                    if not (w.dropped or w.granted)
                    and now - w.t0 >= self._aging_s]
            if aged:
                # starvation bound: the OLDEST aged waiter outranks
                # every class
                best = min(aged, key=lambda w: w.seq)
                best.granted = True
                return best
        while self._heap:
            _, _, w = heapq.heappop(self._heap)
            if not (w.dropped or w.granted):
                w.granted = True
                return w
        return None

    def _grant_locked(self) -> None:
        while self._inflight < self._capacity:
            w = self._pop_best_locked()
            if w is None:
                return
            self._inflight += 1
            w.event.set()

    def acquire(self, priority: int = 0,
                timeout: Optional[float] = None) -> bool:
        """Take one dispatch slot (True) or time out (False). Waiters
        are served class-first / FIFO-within-class on every release."""
        with self._lock:
            self._compact_locked()
            if self._inflight < self._capacity and not self._heap:
                self._inflight += 1
                return True
            w = _Waiter(priority, next(self._seq), self._clock())
            heapq.heappush(self._heap, (-priority, w.seq, w))
        if w.event.wait(timeout):
            return True
        with self._lock:
            if w.granted:
                # the grant raced our timeout: keep the slot
                return True
            w.dropped = True
            return False

    def release(self) -> None:
        with self._lock:
            if self._inflight <= 0:
                raise RuntimeError("release() without a held slot")
            self._inflight -= 1
            self._grant_locked()


class AdmissionController:
    """One deployment's admission state at a router: the estimated-wait
    check in front of a :class:`PriorityGate`.

    ``admit`` either returns (slot held — caller MUST call ``release``
    after dispatch) or raises :class:`Overloaded`. The wait estimate is
    ``queue_position × est_service_s / replicas``: the requests that
    must finish before this one, served at the deployment's aggregate
    rate. Shed decisions are counted per class (the ``on_shed``
    callback feeds the metrics registry and ``/-/stats``)."""

    def __init__(self, deployment: str, slo: SLOConfig, replicas: int = 1,
                 shards: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 on_shed: Optional[Callable[[str, str], None]] = None):
        """``shards``: how many peers (routers) share this deployment's
        admission duty. Each controller only sees ITS router's queue,
        so both the dispatch-slot budget and the wait estimate are
        divided by the shard count — scaling the router tier must not
        multiply the aggregate inflight the SLO admits (capacity is
        ceil-divided, so the aggregate can exceed the exact budget by
        at most shards-1 slots)."""
        self.deployment = deployment
        self.slo = slo
        self._clock = clock
        self._on_shed = on_shed
        self._lock = threading.Lock()
        self._replicas = max(1, replicas)
        self._shards = max(1, shards)
        self._gate = PriorityGate(capacity=self._capacity(),
                                  aging_s=slo.aging_s, clock=clock)
        self._sheds: Dict[str, int] = {}

    def _capacity(self) -> int:
        total = self._replicas * max(
            1, self.slo.target_inflight_per_replica)
        return max(1, -(-total // self._shards))

    def update_replicas(self, replicas: int,
                        shards: Optional[int] = None) -> None:
        with self._lock:
            self._replicas = max(1, replicas)
            if shards is not None:
                self._shards = max(1, shards)
        self._gate.set_capacity(self._capacity())

    def _shed(self, klass: str, reason: str, wait: float) -> None:
        with self._lock:
            self._sheds[klass] = self._sheds.get(klass, 0) + 1
        if self._on_shed is not None:
            self._on_shed(klass, reason)
        # [retry_after=…] is a STRUCTURAL field: the cluster handle
        # parses it back out of the repr the RPC layer ships, so the
        # prose around it can change without silently zeroing the
        # client's backoff hint
        raise Overloaded(
            f"deployment {self.deployment!r} overloaded: estimated wait "
            f"{wait:.3f}s exceeds the {self.slo.latency_budget_s:.3f}s "
            f"budget (class {klass!r}) [retry_after={wait:.3f}s]",
            retry_after=wait)

    def admit(self, klass: Optional[str] = None) -> None:
        """Estimated-wait check, then block for a dispatch slot (bounded
        by the remaining budget). Raises :class:`Overloaded` instead of
        queueing past the deployment's latency budget."""
        slo = self.slo
        name = klass or "default"
        with self._lock:
            # this router's share of the deployment's service rate: it
            # sees only 1/shards of the backlog AND owns only 1/shards
            # of the replicas' throughput, so the estimate stays honest
            # as the router tier scales
            share = self._replicas / self._shards
        # requests that must clear before this one can dispatch: what's
        # queued plus the overage of in-flight work over dispatch slots
        outstanding = self._gate.waiting() + self._gate.inflight()
        position = max(0, outstanding + 1 - self._gate.capacity)
        est_wait = position * slo.est_service_s / share
        if est_wait > slo.latency_budget_s:
            self._shed(name, "est_wait", est_wait)
        # wait at most the budget for a slot: a stalled queue must turn
        # into a typed shed, never an unbounded block
        if not self._gate.acquire(priority=slo.priority_of(klass),
                                  timeout=slo.latency_budget_s):
            self._shed(name, "slot_timeout", slo.latency_budget_s)

    def release(self) -> None:
        self._gate.release()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sheds = dict(self._sheds)
            replicas = self._replicas
            shards = self._shards
        return {"waiting": self._gate.waiting(),
                "inflight": self._gate.inflight(),
                "capacity": self._gate.capacity,
                "replicas": replicas,
                "shards": shards,
                "sheds": sheds,
                "shed_total": sum(sheds.values())}
