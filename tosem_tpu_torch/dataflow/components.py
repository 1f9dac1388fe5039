"""Cyber-style component model: fused readers + timer components.

The reference's component runtime (`cyber/component/component.h:58-136`
``Component<M0..M3>`` — proc fires on the primary channel's message with
the latest fused message from each secondary channel;
`timer_component.h` — periodic proc; channels resolved through topology
discovery). A **deterministic virtual-time event loop** instead of
croutine scheduling — messages and timer firings are (time, seq) events
in one priority queue, so pipelines replay exactly (the property
record/replay and CI need), while heavy math inside a ``proc`` runs as
tensor ops on the component's device.

Channels register in the cluster :class:`~tosem_tpu_torch.cluster.discovery.
Registry` (kind ``"channel"``), so writers/readers are discoverable the
way Cyber's topology manager exposes them.

A copy of the JAX package's ``dataflow/components.py``: host code, the
same event order and the same QoS semantics.
"""
from __future__ import annotations

import collections
import heapq
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tosem_tpu_torch.cluster.discovery import Registry


class Component:
    """Fused-reader component (``Component<M0, M1...>`` analog).

    Subclass and override :meth:`proc`. The first declared channel is the
    primary: ``proc`` runs once per primary message, receiving the
    message plus the *latest* message seen on each secondary channel
    (``None`` until one arrives) — Apollo's fusion semantics.
    """

    def __init__(self, name: str, channels: Sequence[str]):
        if not channels:
            raise ValueError("component needs at least one channel")
        self.name = name
        self.channels = list(channels)

    def on_init(self, ctx: "ComponentContext") -> None:
        pass

    def proc(self, primary: Any, *fused: Any) -> None:
        raise NotImplementedError


class CoroutineComponent:
    """Cooperative multi-step task — the croutine role, deterministic.

    The reference schedules userspace coroutines that yield at blocking
    points (``cyber/croutine/croutine.h``: ``data_wait`` parks the
    routine until its reader has data, the scheduler resumes it). TPU
    collapse: :meth:`run` is a **generator**; every ``yield "channel"``
    parks the routine until the next message on that channel arrives
    (delivered as the value of the yield), and ``yield ("sleep", dt)``
    parks it for virtual time. Cooperative scheduling on the same
    deterministic (time, seq) event loop — no OS threads, fully
    replayable, which is what croutines buy Apollo minus the context-
    switch machinery XLA's async dispatch already makes unnecessary.

    Subclass and override :meth:`run`; it is started at ``add()`` time
    and retired when the generator returns.
    """

    def __init__(self, name: str):
        self.name = name

    def on_init(self, ctx: "ComponentContext") -> None:
        pass

    def run(self, ctx: "ComponentContext"):
        raise NotImplementedError
        yield  # pragma: no cover  (marks this as a generator template)


class TimerComponent:
    """Periodic component (``timer_component.h`` analog)."""

    def __init__(self, name: str, interval: float):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.name = name
        self.interval = float(interval)

    def on_init(self, ctx: "ComponentContext") -> None:
        pass

    def proc(self) -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class ChannelQos:
    """Per-channel QoS profile (cyber transport's QosProfile: history
    depth + reliability tier).

    ``reliability="reliable"`` delivers every message; ``"best_effort"``
    keeps at most ``depth`` undelivered messages per channel (KEEP_LAST:
    under write pressure the OLDEST pending message is dropped, the
    sensor-stream semantics — a fresher lidar frame supersedes a stale
    one). ``depth`` also sizes the reader-side history buffer
    (:meth:`ComponentRuntime.history`)."""
    depth: int = 1
    reliability: str = "reliable"

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError("qos depth must be >= 1")
        if self.reliability not in ("reliable", "best_effort"):
            raise ValueError(f"unknown reliability {self.reliability!r}")


_DEFAULT_QOS = ChannelQos()


@dataclass
class ComponentContext:
    """Handed to components at init: write access + the current clock."""
    runtime: "ComponentRuntime"

    def writer(self, channel: str,
               qos: Optional[ChannelQos] = None) -> Callable[[Any], None]:
        return self.runtime.writer(channel, owner="component", qos=qos)

    @property
    def now(self) -> float:
        return self.runtime.now


class ComponentRuntime:
    """Deterministic single-process component host.

    Events (message deliveries, timer firings) execute in (time, seq)
    order on a virtual clock; :meth:`run_until` advances it. Writers
    enqueue at the current virtual time plus an optional latency.
    """

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        self.now = 0.0
        self._seq = itertools.count()
        self._events: List[Tuple[float, int, Callable[[], None]]] = []
        self._components: List[Any] = []
        self._latest: Dict[str, Any] = {}          # channel -> last message
        self._subs: Dict[str, List[Component]] = {}
        self._stats: Dict[str, int] = {}
        self._qos: Dict[str, ChannelQos] = {}
        self._pending: Dict[str, Any] = {}         # best-effort queues
        self._history: Dict[str, Any] = {}         # channel -> deque
        self._drops: Dict[str, int] = {}
        self._waiters: Dict[str, List[Any]] = {}   # croutine data_wait

    # ------------------------------------------------------- channels

    def set_qos(self, channel: str, qos: ChannelQos) -> None:
        """Pin a channel's QoS profile (cyber's reader/writer QosProfile;
        here per-channel, single-controller collapse)."""
        self._qos[channel] = qos

    def qos(self, channel: str) -> ChannelQos:
        return self._qos.get(channel, _DEFAULT_QOS)

    def writer(self, channel: str, owner: str = "external",
               qos: Optional[ChannelQos] = None) -> Callable[[Any], None]:
        """Create a channel writer (``node->CreateWriter`` analog);
        registers the channel for discovery."""
        self.registry.register("channel", channel,
                               {"owner": owner}, unique=False)
        if qos is not None:
            self.set_qos(channel, qos)

        def write(message: Any, *, latency: float = 0.0) -> None:
            q = self.qos(channel)
            when = self.now + max(latency, 0.0)
            if q.reliability == "best_effort":
                # KEEP_LAST by write order, but each surviving message
                # still delivers at ITS OWN latency: pending is an
                # insertion-ordered id→message map; a dropped id's event
                # fires into nothing
                pend = self._pending.setdefault(channel, {})
                mid = next(self._seq)
                pend[mid] = message
                while len(pend) > q.depth:    # drop the oldest-written
                    pend.pop(next(iter(pend)))
                    self._drops[channel] = self._drops.get(channel, 0) + 1
                self._push(when,
                           lambda: self._deliver_token(channel, mid))
            else:
                self._push(when, lambda: self._deliver(channel, message))
        return write

    _MISSING = object()

    def _deliver_token(self, channel: str, mid: int) -> None:
        msg = self._pending.get(channel, {}).pop(mid, self._MISSING)
        if msg is not self._MISSING:   # else: superseded before arrival
            self._deliver(channel, msg)

    def history(self, channel: str) -> List[Any]:
        """Last ``qos(channel).depth`` DELIVERED messages, oldest first
        (the reader-side history buffer of a depth-k subscription)."""
        return list(self._history.get(channel, ()))

    def drop_counts(self) -> Dict[str, int]:
        """Messages dropped per best-effort channel (KEEP_LAST policy)."""
        return dict(self._drops)

    def channels(self) -> List[str]:
        return self.registry.list("channel")

    # ----------------------------------------------------- components

    def add(self, comp: Any) -> None:
        if isinstance(comp, CoroutineComponent):
            self._components.append(comp)
            comp.on_init(ComponentContext(self))
            gen = comp.run(ComponentContext(self))
            # first advance runs as a scheduled event so startup order
            # is (time, seq)-deterministic like everything else
            self._push(self.now,
                       lambda: self._advance_coroutine(comp, gen, None))
        elif isinstance(comp, TimerComponent):
            self._components.append(comp)
            comp.on_init(ComponentContext(self))
            self._schedule_timer(comp, self.now + comp.interval)
        elif isinstance(comp, Component):
            self._components.append(comp)
            for ch in comp.channels:
                self.registry.register("channel", ch,
                                       {"owner": "reader"}, unique=False)
                self._subs.setdefault(ch, [])
            self._subs[comp.channels[0]].append(comp)
            comp.on_init(ComponentContext(self))
        else:
            raise TypeError(f"not a component: {comp!r}")

    # ------------------------------------------------------ execution

    def _push(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._events, (t, next(self._seq), fn))

    def _schedule_timer(self, comp: TimerComponent, t: float) -> None:
        def fire():
            # reschedule BEFORE proc: a raising proc must not silently
            # unschedule the timer (message components stay subscribed
            # through failures; timers get the same semantics). Stats
            # count successful procs only, matching _deliver.
            self._schedule_timer(comp, t + comp.interval)
            comp.proc()
            self._stats[comp.name] = self._stats.get(comp.name, 0) + 1
        self._push(t, fire)

    def _park(self, comp: "CoroutineComponent", gen, req,
              mail=None) -> None:
        """Park a routine per its yield request (channel / sleep)."""
        if isinstance(req, str):        # data_wait: park with a mailbox
            rec = {"comp": comp, "gen": gen,
                   "mail": mail if mail is not None else
                   collections.deque(), "scheduled": False}
            self._waiters.setdefault(req, []).append(rec)
            if rec["mail"]:             # leftovers: drain immediately
                rec["scheduled"] = True
                self._push(self.now,
                           lambda: self._drain_waiter(req, rec))
        elif (isinstance(req, tuple) and len(req) == 2
                and req[0] == "sleep"):
            self._push(self.now + max(float(req[1]), 0.0),
                       lambda: self._advance_coroutine(comp, gen, None))
        else:
            raise TypeError(
                f"coroutine {comp.name!r} yielded {req!r}; expected a "
                "channel name or ('sleep', seconds)")

    def _advance_coroutine(self, comp: "CoroutineComponent", gen,
                           value: Any) -> None:
        """Resume a parked routine; park it again at its next yield."""
        try:
            req = gen.send(value)
        except StopIteration:
            return                      # routine finished: retire
        self._stats[comp.name] = self._stats.get(comp.name, 0) + 1
        self._park(comp, gen, req)

    def _drain_waiter(self, channel: str, rec) -> None:
        """Feed a parked routine one buffered message. The mailbox makes
        same-timestamp (or resume-in-flight) deliveries lossless: every
        message lands in the waiter's queue at _deliver time and is
        consumed one-per-yield here; leftovers follow the routine if it
        parks on the same channel again, so bursts are never dropped."""
        rec["scheduled"] = False
        if not rec["mail"]:
            return
        msg = rec["mail"].popleft()
        lst = self._waiters.get(channel, [])
        lst.remove(rec)
        if not lst:
            self._waiters.pop(channel, None)
        comp, gen = rec["comp"], rec["gen"]
        try:
            req = gen.send(msg)
        except StopIteration:
            return
        self._stats[comp.name] = self._stats.get(comp.name, 0) + 1
        if req == channel:
            self._park(comp, gen, req, mail=rec["mail"])
        else:
            self._park(comp, gen, req)

    def _deliver(self, channel: str, message: Any) -> None:
        self._latest[channel] = message
        hist = self._history.get(channel)
        depth = self.qos(channel).depth
        if hist is None or hist.maxlen != depth:
            hist = collections.deque(hist or (), maxlen=depth)
            self._history[channel] = hist
        hist.append(message)
        # wake parked routines (data_wait satisfied): the message goes
        # into each waiter's mailbox and the drain runs as a scheduled
        # event, so ordering stays (time, seq) and bursts are lossless
        for rec in list(self._waiters.get(channel, [])):
            rec["mail"].append(message)
            if not rec["scheduled"]:
                rec["scheduled"] = True
                self._push(self.now,
                           lambda r=rec: self._drain_waiter(channel, r))
        for comp in self._subs.get(channel, []):
            fused = [self._latest.get(ch) for ch in comp.channels[1:]]
            comp.proc(message, *fused)
            self._stats[comp.name] = self._stats.get(comp.name, 0) + 1

    def run_until(self, t: float) -> int:
        """Advance the virtual clock to ``t``; returns events executed.
        Timer events beyond ``t`` stay queued for the next call. The
        clock is monotonic: a ``t`` in the past is a caller bug (it
        would let new writes deliver before already-executed events)."""
        if t < self.now:
            raise ValueError(f"run_until({t}) would rewind the clock "
                             f"(now={self.now})")
        executed = 0
        while self._events and self._events[0][0] <= t:
            when, _, fn = heapq.heappop(self._events)
            self.now = when
            fn()
            executed += 1
        self.now = t
        return executed

    def proc_counts(self) -> Dict[str, int]:
        return dict(self._stats)
