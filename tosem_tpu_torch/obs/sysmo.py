"""System monitor — the periodic scheduler/process health checker.

The reference's Cyber SysMo (``cyber/sysmo/sysmo.cc``) runs a checker
thread on a fixed interval that samples the scheduler's coroutine
status and dumps it for operators. The framework's scheduler state
lives in Python threads and the deterministic component runtime, so the
equivalent samples here are process-level: CPU time deltas from
``/proc/self/stat``, RSS (shared with
:mod:`~tosem_tpu_torch.obs.memory_monitor`), the live thread inventory
(name/daemon/alive — worker pools, pollers, trial threads all show up
by their creation names), plus pluggable **sources** — callables
returning dicts — so any subsystem (a
:class:`~tosem_tpu_torch.dataflow.components.ComponentRuntime`, a node
agent's stats RPC) can join the same report. Snapshots optionally feed
:class:`~tosem_tpu_torch.obs.metrics.Gauge` rows, putting sysmo data on the
same dashboard as everything else.

A copy of the JAX package's ``obs/sysmo.py``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from tosem_tpu_torch.obs.memory_monitor import read_rss_bytes

__all__ = ["SysMo", "read_cpu_ticks"]

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def read_cpu_ticks(pid: Optional[int] = None) -> float:
    """utime+stime of a process in seconds (``/proc/<pid>/stat`` fields
    14/15); 0.0 where /proc is absent — samples degrade, never raise."""
    try:
        with open(f"/proc/{pid or os.getpid()}/stat", "rb") as f:
            # field 2 (comm) may contain spaces/parens: split after it
            rest = f.read().rsplit(b")", 1)[1].split()
        return (int(rest[11]) + int(rest[12])) / _CLK_TCK
    except (OSError, IndexError, ValueError):
        return 0.0


class SysMo:
    """Periodic checker thread (100 ms default, like the reference's
    ``sysmo_interval_ms_``); keeps the last ``history`` snapshots."""

    def __init__(self, interval_s: float = 0.1, history: int = 64,
                 registry=None):
        self.interval_s = interval_s
        self.history = history
        self.snapshots: List[Dict[str, Any]] = []
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu = read_cpu_ticks()
        self._last_t = time.monotonic()
        self._g_cpu = self._g_rss = self._g_threads = None
        if registry is not None:
            from tosem_tpu_torch.obs.metrics import Gauge
            self._g_cpu = registry.register(
                Gauge("sysmo_cpu_percent", "process CPU utilization"))
            self._g_rss = registry.register(
                Gauge("sysmo_rss_bytes", "resident set size"))
            self._g_threads = registry.register(
                Gauge("sysmo_threads", "live thread count"))

    def add_source(self, name: str,
                   fn: Callable[[], Dict[str, Any]]) -> None:
        """Join a subsystem's status dict to every snapshot (the role of
        SysMo's scheduler hook — e.g. a runtime's queue depths or a node
        agent's ``stats()``)."""
        with self._lock:
            self._sources[name] = fn

    def sample(self) -> Dict[str, Any]:
        """One snapshot; also appended to :attr:`snapshots`."""
        now = time.monotonic()
        cpu = read_cpu_ticks()
        dt = max(now - self._last_t, 1e-9)
        cpu_pct = 100.0 * max(cpu - self._last_cpu, 0.0) / dt
        self._last_cpu, self._last_t = cpu, now
        threads = [{"name": t.name, "daemon": t.daemon,
                    "alive": t.is_alive()}
                   for t in threading.enumerate()]
        snap: Dict[str, Any] = {
            "t": time.time(),
            "cpu_percent": round(cpu_pct, 2),
            "rss_bytes": read_rss_bytes(),
            "n_threads": len(threads),
            "threads": threads,
        }
        with self._lock:
            sources = dict(self._sources)
        for name, fn in sources.items():
            try:
                snap[name] = fn()
            except Exception as e:        # a sick source is itself data
                snap[name] = {"error": repr(e)}
        with self._lock:
            self.snapshots.append(snap)
            del self.snapshots[:-self.history]
        if self._g_cpu is not None:
            self._g_cpu.set(snap["cpu_percent"])
            self._g_rss.set(float(snap["rss_bytes"]))
            self._g_threads.set(float(snap["n_threads"]))
        return snap

    def dump(self) -> str:
        """Operator-readable status report (the checker's dump role)."""
        snap = self.snapshots[-1] if self.snapshots else self.sample()
        lines = [f"sysmo @ {snap['t']:.3f}: "
                 f"cpu {snap['cpu_percent']:.1f}% "
                 f"rss {snap['rss_bytes'] / 1e6:.1f}MB "
                 f"threads {snap['n_threads']}"]
        for t in snap["threads"]:
            lines.append(f"  thread {t['name']}"
                         f"{' (daemon)' if t['daemon'] else ''}")
        for k, v in snap.items():
            if k not in ("t", "cpu_percent", "rss_bytes", "n_threads",
                         "threads"):
                lines.append(f"  {k}: {v}")
        return "\n".join(lines)

    # -- lifecycle (Start/Shutdown) ------------------------------------

    def start(self) -> "SysMo":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True, name="sysmo")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
