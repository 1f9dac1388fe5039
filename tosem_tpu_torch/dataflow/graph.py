"""Stage-dataflow graph: sources → operators → sinks over runtime actors.

Design (vs the reference):

- **Cyber component model** (``cyber/component/component.h:58-136``): a
  component's ``Proc(msg...)`` fires when its input channels have data,
  under a croutine scheduler. Here an operator is a class with
  ``process(item) -> item | list | None`` (None = filtered) instantiated
  as ONE actor per parallel instance — state is explicit and per-instance,
  restarts follow the actor policy.
- **Ray streaming** (``streaming/src/data_writer.cc``): writers push to
  per-channel ring buffers with credit-based backpressure. Here the driver
  is the single controller: it tracks in-flight calls per instance and
  stops pulling from sources when any downstream instance is at its credit
  limit — bounded memory end to end.
- **Partitioning**: ``rebalance`` (round-robin), ``keyed(fn)`` (hash
  partitioning, preserves per-key ordering to ONE instance — the keyBy of
  cyber/ray streaming), ``broadcast`` (every instance sees every item).

End-of-stream: when sources exhaust and a stage's upstreams have fully
drained, the driver calls the operator's optional ``flush()`` on each
instance and forwards its output downstream — watermark propagation
collapsed to the single-controller case.

A copy of the JAX package's ``dataflow/graph.py`` on the port's actor
runtime (:mod:`tosem_tpu_torch.runtime`).
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import tosem_tpu_torch.runtime as rt


def rebalance():
    return ("rebalance", None)


def keyed(key_fn: Callable[[Any], Any]):
    return ("keyed", key_fn)


def broadcast():
    return ("broadcast", None)


class _FnOperator:
    """Wraps a plain function as a stateless operator."""

    def __init__(self, fn):
        self.fn = fn

    def process(self, item):
        return self.fn(item)


@dataclass
class Stage:
    name: str
    op_factory: Optional[Callable[[], Any]]   # None for sources/sinks
    parallelism: int = 1
    partitioning: Tuple[str, Optional[Callable]] = ("rebalance", None)
    is_source: bool = False
    is_sink: bool = False
    source_iter: Optional[Iterable] = None
    # runtime state
    handles: List[Any] = field(default_factory=list)
    inflight: Dict[int, List[Any]] = field(default_factory=dict)
    rr: Any = None
    upstreams: List["Stage"] = field(default_factory=list)
    downstreams: List["Stage"] = field(default_factory=list)
    closed: bool = False
    flushed: bool = False
    results: List[Any] = field(default_factory=list)


class _OperatorActor:
    """The per-instance actor: owns one operator instance."""

    def __init__(self, factory_blob):
        import cloudpickle
        factory = cloudpickle.loads(factory_blob)
        self.op = factory()

    def process(self, item):
        return self.op.process(item)

    def flush(self):
        f = getattr(self.op, "flush", None)
        return f() if f is not None else None


class StreamGraph:
    """Build + run a stage DAG.

    ::

        g = StreamGraph()
        src = g.source("nums", range(100))
        sq = g.stage("square", lambda x: x * x, parallelism=2)
        agg = g.stage("sum", SumOperator, partitioning=keyed(lambda x: 0))
        out = g.sink("out")
        g.connect(src, sq); g.connect(sq, agg); g.connect(agg, out)
        results = g.run()["out"]
    """

    def __init__(self):
        self.stages: Dict[str, Stage] = {}

    def _add(self, st: Stage) -> Stage:
        if st.name in self.stages:
            raise ValueError(f"duplicate stage {st.name!r}")
        self.stages[st.name] = st
        return st

    def source(self, name: str, iterable: Iterable) -> Stage:
        return self._add(Stage(name, None, is_source=True,
                               source_iter=iter(iterable)))

    def stage(self, name: str, op, parallelism: int = 1,
              partitioning=None) -> Stage:
        """``op``: a callable item→item (stateless) or an operator class
        with ``process``/optional ``flush`` (stateful, one per instance)."""
        import inspect
        if inspect.isclass(op):
            factory = op
        else:
            factory = (lambda f=op: _FnOperator(f))
        return self._add(Stage(name, factory, parallelism=parallelism,
                               partitioning=partitioning or rebalance()))

    def sink(self, name: str) -> Stage:
        return self._add(Stage(name, None, is_sink=True))

    def connect(self, a: Stage, b: Stage) -> None:
        a.downstreams.append(b)
        b.upstreams.append(a)

    # ------------------------------------------------------------------ run

    def run(self, max_inflight_per_instance: int = 4,
            timeout_s: float = 300.0) -> Dict[str, List[Any]]:
        """Pump until every source is exhausted and every stage drained.
        → {sink_name: [items]} (arrival order)."""
        import cloudpickle
        import time as _time

        own_rt = not rt.is_initialized()
        if own_rt:
            rt.init()
        actor_cls = rt.remote(max_restarts=1)(_OperatorActor)
        order = self._toposort()
        for st in order:
            if st.op_factory is not None:
                blob = cloudpickle.dumps(st.op_factory)
                st.handles = [actor_cls.remote(blob)
                              for _ in range(st.parallelism)]
                st.inflight = {i: [] for i in range(st.parallelism)}
                st.rr = itertools.count()

        deadline = _time.monotonic() + timeout_s
        try:
            while True:
                progressed = self._pump(order, max_inflight_per_instance)
                if self._finished(order):
                    break
                if not progressed:
                    done_any = self._drain(order, max_inflight_per_instance,
                                           block=True)
                    if _time.monotonic() > deadline:
                        raise TimeoutError("dataflow made no progress "
                                           f"within {timeout_s}s")
                    if not done_any:
                        _time.sleep(0.005)
            return {s.name: s.results for s in order if s.is_sink}
        finally:
            for st in order:
                for h in st.handles:
                    rt.kill(h)
            if own_rt:
                rt.shutdown()

    # ------------------------------------------------------------ internals

    def _toposort(self) -> List[Stage]:
        indeg = {s.name: len(s.upstreams) for s in self.stages.values()}
        queue = collections.deque(
            s for s in self.stages.values() if indeg[s.name] == 0)
        out: List[Stage] = []
        while queue:
            s = queue.popleft()
            out.append(s)
            for d in s.downstreams:
                indeg[d.name] -= 1
                if indeg[d.name] == 0:
                    queue.append(d)
        if len(out) != len(self.stages):
            raise ValueError("dataflow graph has a cycle")
        return out

    def _route(self, st: Stage, item: Any) -> List[int]:
        kind, fn = st.partitioning
        if kind == "broadcast":
            return list(range(st.parallelism))
        if kind == "keyed":
            return [hash(fn(item)) % st.parallelism]
        return [next(st.rr) % st.parallelism]

    def _emit(self, st: Stage, item: Any) -> None:
        """Send one item into stage ``st`` (or record at a sink)."""
        if st.is_sink:
            st.results.append(item)
            return
        for i in self._route(st, item):
            ref = st.handles[i].process.remote(item)
            st.inflight[i].append(ref)

    def _has_credit(self, st: Stage, cap: int) -> bool:
        if st.is_sink:
            return True
        return all(len(v) < cap for v in st.inflight.values())

    def _forward(self, st: Stage, out: Any) -> None:
        if out is None:
            return
        items = out if isinstance(out, list) else [out]
        for d in st.downstreams:
            for it in items:
                self._emit(d, it)

    def _drain(self, order: List[Stage], cap: int,
               block: bool = False) -> bool:
        """Collect finished calls, forward outputs. → any completions?

        Backpressure propagates stage to stage: a stage whose downstream
        is at its credit limit is NOT drained — its results stay parked in
        its (bounded) inflight lists until the downstream frees credit, so
        memory stays bounded along the whole chain, not just at sources.
        """
        refs = [ref for st in order for lst in st.inflight.values()
                for ref in lst]
        if not refs:
            return False
        if block:
            rt.wait(refs, num_returns=1, timeout=1.0)
        done, _ = rt.wait(refs, num_returns=len(refs), timeout=0.0)
        done = set(done)
        any_done = False
        for st in order:
            if not all(self._has_credit(d, cap) for d in st.downstreams):
                continue   # downstream saturated: hold our results
            for i in list(st.inflight):
                remaining = []
                for ref in st.inflight[i]:
                    if ref in done:
                        out = rt.get(ref)
                        self._forward(st, out)
                        any_done = True
                    else:
                        remaining.append(ref)
                st.inflight[i] = remaining
        return any_done

    def _pump(self, order: List[Stage], cap: int) -> bool:
        progressed = self._drain(order, cap)
        # pull from sources while every downstream has credit (backpressure)
        for st in order:
            if not st.is_source or st.closed:
                continue
            while all(self._has_credit(d, cap) for d in st.downstreams):
                try:
                    item = next(st.source_iter)
                except StopIteration:
                    st.closed = True
                    break
                for d in st.downstreams:
                    self._emit(d, item)
                progressed = True
        # end-of-stream: flush stages whose upstreams are fully done
        for st in order:
            if (st.is_source or st.is_sink or st.flushed
                    or not self._upstreams_done(st)):
                continue
            if any(st.inflight[i] for i in st.inflight):
                continue  # wait for own in-flight work first
            for h in st.handles:
                out = rt.get(h.flush.remote(), timeout=60.0)
                self._forward(st, out)
            st.flushed = True
            progressed = True
        return progressed

    def _upstreams_done(self, st: Stage) -> bool:
        for u in st.upstreams:
            if u.is_source:
                if not u.closed:
                    return False
            elif not u.flushed or any(u.inflight[i] for i in u.inflight):
                return False
        return True

    def _finished(self, order: List[Stage]) -> bool:
        for st in order:
            if st.is_source and not st.closed:
                return False
            if st.inflight and any(st.inflight[i] for i in st.inflight):
                return False
            if (not st.is_source and not st.is_sink and not st.flushed):
                return False
        return True
