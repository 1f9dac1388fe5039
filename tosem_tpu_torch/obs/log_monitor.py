"""Log monitor — tails worker log files to the driver (log_monitor.py role).

The reference runs a per-node ``python/ray/log_monitor.py`` daemon that
tails every worker's stdout/stderr file and republishes lines to the
driver. Single-host analog: a thread polling registered files for appended
lines and invoking a sink callback with (tag, line). Register any file (worker
stdout/stderr redirections, experiment logs) with :meth:`add_file`.

A copy of the JAX package's ``obs/log_monitor.py``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class LogMonitor:
    def __init__(self, sink: Optional[Callable[[str, str], None]] = None,
                 interval_s: float = 0.2):
        self.sink = sink or (lambda tag, line:
                             print(f"({tag}) {line}", flush=True))
        self.interval_s = interval_s
        self._files: Dict[str, int] = {}      # path -> read offset
        self._tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_file(self, path: str, tag: Optional[str] = None) -> None:
        with self._lock:
            self._files.setdefault(path, 0)
            self._tags[path] = tag or os.path.basename(path)

    def poll_once(self) -> List[Tuple[str, str]]:
        """Drain appended lines from every registered file."""
        out: List[Tuple[str, str]] = []
        with self._lock:
            items = list(self._files.items())
        for path, off in items:
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size < off:          # truncated/rotated: restart at 0
                with self._lock:
                    self._files[path] = 0
                off = 0
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            # consume only complete lines: a poll landing mid-write must
            # not split one line into two — leave the partial tail for the
            # next poll
            cut = chunk.rfind(b"\n")
            if cut < 0:
                continue
            with self._lock:
                self._files[path] = off + cut + 1
                tag = self._tags[path]
            for line in chunk[:cut].decode(errors="replace").splitlines():
                if line:
                    out.append((tag, line))
        for tag, line in out:
            self.sink(tag, line)
        return out

    def start(self) -> "LogMonitor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="log-monitor")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
