"""Memory watchdog — the reference's ``python/ray/memory_monitor.py`` role.

Samples process RSS (``/proc/self/status``) and host availability
(``/proc/meminfo``) plus, when attached, the shared object store's
occupancy, exporting them as gauges and invoking a callback above a
threshold so long experiments degrade (evict/spill/abort a trial) instead
of getting OOM-killed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from tosem_tpu_torch.obs import metrics


def read_rss_bytes(pid: Optional[int] = None) -> int:
    path = f"/proc/{pid or 'self'}/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def read_available_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class MemoryMonitor:
    """Background sampler with a high-watermark callback.

    ``on_pressure(snapshot)`` fires (at most once per ``cooldown_s``) when
    used-fraction exceeds ``threshold`` — the memory_monitor.py contract.
    """

    def __init__(self, threshold: float = 0.9, interval_s: float = 1.0,
                 cooldown_s: float = 10.0,
                 on_pressure: Optional[Callable[[Dict], None]] = None,
                 store=None):
        self.threshold = threshold
        self.interval_s = interval_s
        self.cooldown_s = cooldown_s
        self.on_pressure = on_pressure
        self.store = store
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_fire = 0.0
        self.g_rss = metrics.gauge("process_rss_bytes",
                                   "resident set size of this process")
        self.g_avail = metrics.gauge("host_available_bytes",
                                     "MemAvailable on the host")
        self.g_store_used = metrics.gauge(
            "objstore_used_bytes", "shared object store bytes in use")
        self.g_store_cap = metrics.gauge(
            "objstore_capacity_bytes", "shared object store capacity")

    def snapshot(self) -> Dict[str, float]:
        rss = read_rss_bytes()
        avail = read_available_bytes()
        snap = {"rss_bytes": rss, "available_bytes": avail}
        self.g_rss.set(rss)
        self.g_avail.set(avail)
        if self.store is not None:
            try:
                used, n, cap = self.store.stats()
                snap.update(store_used=used, store_objects=n,
                            store_capacity=cap)
                self.g_store_used.set(used)
                self.g_store_cap.set(cap)
            except Exception:
                pass
        total = rss + avail
        snap["used_fraction"] = rss / total if total else 0.0
        return snap

    def check(self) -> Dict[str, float]:
        """One sample + threshold check (call directly or via the thread)."""
        snap = self.snapshot()
        if (snap["used_fraction"] > self.threshold
                and self.on_pressure is not None
                and time.monotonic() - self._last_fire > self.cooldown_s):
            self._last_fire = time.monotonic()
            self.on_pressure(snap)
        return snap

    def start(self) -> "MemoryMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="memory-monitor")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
