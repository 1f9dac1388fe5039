"""Host-side span recording + Chrome-tracing dump.

A copy of ``tosem_tpu/profiler/spans.py`` (framework-free; the port
imports nothing of the JAX package).

The ``ray.profile`` analog: Ray's C++ workers batch ProfileEvent spans into
the GCS profile table (``src/ray/core_worker/profiling.h:27-38``) and
``ray timeline`` dumps them as Chrome tracing JSON
(``python/ray/state.py:521`` ``chrome_tracing_dump``). Here spans record in
-process (thread-safe), and the dump emits the same ``chrome://tracing`` /
Perfetto-loadable format.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    name: str
    cat: str
    start_us: float
    dur_us: float
    pid: int
    tid: int
    args: Dict[str, Any] = field(default_factory=dict)

    def to_chrome(self) -> Dict[str, Any]:
        # "X" = complete event (begin+duration), the same phase ray timeline
        # emits for task spans
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self.start_us, "dur": self.dur_us,
              "pid": self.pid, "tid": self.tid}
        if self.args:
            ev["args"] = self.args
        return ev


class SpanRecorder:
    """Thread-safe in-process span buffer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._meta: Dict[int, str] = {}

    @contextmanager
    def span(self, name: str, cat: str = "app", **args: Any):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur_ns = time.perf_counter_ns() - t0
            s = Span(name=name, cat=cat,
                     start_us=t0 / 1e3, dur_us=dur_ns / 1e3,
                     pid=os.getpid(), tid=threading.get_ident() % 0xFFFF,
                     args=args or {})
            with self._lock:
                self._spans.append(s)

    def add(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": [s.to_chrome() for s in self.spans()],
                "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_GLOBAL = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _GLOBAL


@contextmanager
def span(name: str, cat: str = "app", **args: Any):
    """``with span("step"): ...`` — records into the global recorder."""
    with _GLOBAL.span(name, cat, **args):
        yield


def chrome_trace_dump(path: str) -> str:
    """Dump all recorded spans as Chrome tracing JSON (``ray timeline``)."""
    return _GLOBAL.dump(path)
