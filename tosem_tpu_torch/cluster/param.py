"""Parameter server — shared named parameters with change notification.

The reference's Cyber parameter service
(``cyber/parameter/parameter_server.cc``: a node-hosted
SetParameter/GetParameter/ListParameters service backed by protobuf
``Param`` messages) gives every node one consistent view of tunable
values. Our KV store already IS the durable shared table (SURVEY's
GCS/Redis collapse), so the parameter server here is a thin facade over
a ``params`` namespace plus the piece the KV lacks: **monotonic change
versions and notifications** — local subscribers fire synchronously on
``set``, cross-process subscribers poll ``updates_since`` (a version
cursor, the same pull pattern the discovery registry uses), and
:func:`bind_runtime` bridges updates onto a dataflow runtime's channel
(anything with a ``writer(channel)``, as
:class:`~tosem_tpu_torch.dataflow.components.ComponentRuntime`) so
components consume parameter changes like any other message.

A copy of the JAX package's ``cluster/param.py``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tosem_tpu_torch.cluster.kv import KVStore

__all__ = ["ParameterServer", "ParameterPoller"]

_NS = "params"
_VERSION_KEY = "__version__"


class ParameterServer:
    """get/set/list over a shared KV namespace, with change versions."""

    def __init__(self, kv: Optional[KVStore] = None, ns: str = _NS):
        self._kv = kv or KVStore()
        self._ns = ns
        self._watchers: List[Callable[[str, Any, int], None]] = []
        self._lock = threading.Lock()

    # -- core surface (SetParameter / GetParameter / ListParameters) ---

    def _next_version(self) -> int:
        while True:
            cur = self._kv.get(self._ns, _VERSION_KEY)
            nxt = (int(cur) if cur else 0) + 1
            if self._kv.cas(self._ns, _VERSION_KEY, cur,
                            str(nxt).encode()):
                return nxt

    def set(self, name: str, value: Any) -> int:
        """Write a parameter (JSON-serializable) and notify local
        watchers; returns the global change version.

        The row write is a CAS loop ordered by version: a concurrent
        writer that allocated a LOWER version can never overwrite a
        higher one after a poller's cursor has passed it — the stale
        write loses (its value is superseded in version order), instead
        of landing late and being silently unobservable forever."""
        if name == _VERSION_KEY:
            raise ValueError(f"{_VERSION_KEY!r} is reserved")
        version = self._next_version()
        blob = json.dumps({"v": value, "version": version}).encode()
        while True:
            cur = self._kv.get(self._ns, name)
            if cur is not None and json.loads(cur)["version"] > version:
                break                    # a newer write already landed
            if self._kv.cas(self._ns, name, cur, blob):
                break
        with self._lock:
            watchers = list(self._watchers)
        for cb in watchers:
            cb(name, value, version)
        return version

    def get(self, name: str, default: Any = None) -> Any:
        raw = self._kv.get(self._ns, name)
        if raw is None:
            return default
        return json.loads(raw)["v"]

    def list(self) -> Dict[str, Any]:
        out = {}
        for k in self._kv.keys(self._ns):
            if k != _VERSION_KEY:
                out[k] = self.get(k)
        return out

    def delete(self, name: str) -> bool:
        return self._kv.delete(self._ns, name)

    # -- notifications -------------------------------------------------

    def watch(self, callback: Callable[[str, Any, int], None]) -> None:
        """Synchronous local subscription: ``callback(name, value,
        version)`` on every ``set`` through THIS server instance."""
        with self._lock:
            self._watchers.append(callback)

    def unwatch(self, callback) -> None:
        with self._lock:
            self._watchers = [w for w in self._watchers if w != callback]

    def version(self) -> int:
        cur = self._kv.get(self._ns, _VERSION_KEY)
        return int(cur) if cur else 0

    def rows(self) -> Dict[str, Tuple[Any, int]]:
        """Full table view ``{name: (value, version)}`` — the scan the
        per-key poller consumes."""
        out: Dict[str, Tuple[Any, int]] = {}
        for k in self._kv.keys(self._ns):
            if k == _VERSION_KEY:
                continue
            raw = self._kv.get(self._ns, k)
            if raw is None:
                continue
            row = json.loads(raw)
            out[k] = (row["v"], row["version"])
        return out

    def updates_since(self, version: int
                      ) -> List[Tuple[str, Any, int]]:
        """Changes with version > cursor, oldest first — the pull side
        cross-process subscribers use (writes from OTHER processes never
        reach local callbacks)."""
        out = []
        for k in self._kv.keys(self._ns):
            if k == _VERSION_KEY:
                continue
            raw = self._kv.get(self._ns, k)
            if raw is None:
                continue                 # deleted between keys() and get()
            row = json.loads(raw)
            if row["version"] > version:
                out.append((k, row["v"], row["version"]))
        return sorted(out, key=lambda r: r[2])

    def bind_runtime(self, runtime, channel: str = "param_events") -> None:
        """Publish every local ``set`` onto a dataflow channel, so
        components receive parameter changes as messages (the Cyber
        parameter-node-to-component path)."""
        writer = runtime.writer(channel)
        self.watch(lambda name, value, version: writer(
            {"name": name, "value": value, "version": version}))


class ParameterPoller:
    """Background per-key version poller: turns cross-process parameter
    writes into callbacks (the subscriber half for processes that do not
    share the writing :class:`ParameterServer` instance).

    Tracks the last-delivered version PER KEY (seeded from the table at
    construction), not one global cursor: with a global cursor, a slow
    writer whose allocated version lands AFTER a faster writer's higher
    version has been observed would slip below the cursor and never be
    delivered. Per-key comparison delivers any row whose version moved,
    regardless of cross-key allocation order."""

    def __init__(self, server: ParameterServer,
                 callback: Callable[[str, Any, int], None],
                 poll_s: float = 0.1):
        self._server = server
        self._callback = callback
        self._poll_s = poll_s
        self._seen: Dict[str, int] = {
            k: ver for k, (_v, ver) in server.rows().items()}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="param-poller")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                rows = self._server.rows()
            except Exception:
                rows = {}               # a flaky store: retry next tick
            changed = [(k, v, ver) for k, (v, ver) in rows.items()
                       if ver != self._seen.get(k)]
            for k, v, ver in sorted(changed, key=lambda r: r[2]):
                self._seen[k] = ver
                try:
                    self._callback(k, v, ver)
                except Exception:
                    # one sick subscriber callback must not kill the
                    # poller and silently drop all future updates
                    pass
            self._stop.wait(self._poll_s)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
