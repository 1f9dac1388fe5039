"""Cross-language call surface — named functions over a JSON wire.

The reference exposes its task plane to second languages: Ray's Java
API makes cross-language calls by registering functions under stable
names and narrowing arguments to a language-neutral serialization
(``src/ray/ray-1.1.0/java/api/``, ``python/ray/cross_language.py`` —
cross-language tasks take msgpack-able args only, by name not by
pickled function). The pickle RPC in :mod:`tosem_tpu_torch.cluster.rpc` is
deliberately Python-only; this module is the boundary a non-Python
client crosses:

- Wire: 4-byte big-endian length + UTF-8 JSON — implementable in any
  language in a screenful (see ``native/xlang_client.cpp``).
- Request ``{"method": name, "args": [...], "kwargs": {...}}`` →
  response ``{"ok": true, "result": ...}`` or ``{"ok": false,
  "error": "..."}``. Arguments and results are restricted to JSON
  (the cross-language narrowing, same tradeoff as msgpack in Ray).
- :meth:`XLangGateway.register` names a function; built-ins ``ping``
  and ``list_methods`` give clients discovery. A gateway can also
  front a node agent: :meth:`bridge_node` registers ``submit_trial`` /
  ``trial_status`` / ``kill_trial`` so a non-Python client can drive
  the remote training service end to end.

Loopback/private-interconnect only, like the rest of the control plane.

A copy of the JAX package's ``cluster/xlang.py``.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

__all__ = ["XLangGateway", "xlang_call"]

_LEN = struct.Struct(">I")
MAX_FRAME = 64 << 20


def _send_json(sock: socket.socket, obj: Any) -> None:
    blob = json.dumps(obj).encode("utf-8")
    if len(blob) > MAX_FRAME:
        raise ValueError("frame too large")
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_json(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise ConnectionError("oversized frame")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


class XLangGateway:
    """Thread-per-connection JSON call server over named functions."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._fns: Dict[str, Callable] = {
            "ping": lambda: "pong",
            "list_methods": self._list_methods,
            "list_signatures": self._list_signatures,
        }
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.address = "%s:%d" % self._srv.getsockname()
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="xlang-accept")
        self._accept_thread.start()

    def _list_methods(self) -> List[str]:
        with self._lock:
            return sorted(self._fns)

    def _list_signatures(self) -> List[Dict[str, Any]]:
        """Wire-level introspection for the stub generator
        (:mod:`tosem_tpu_torch.cluster.stubgen`): name + positional parameter
        names + first doc line per registered function."""
        from tosem_tpu_torch.cluster.stubgen import describe
        return [{"name": s.name, "params": list(s.params), "doc": s.doc}
                for s in describe(self)]

    def register(self, name: str, fn: Callable) -> None:
        """Expose ``fn`` to non-Python callers under ``name`` — the
        cross-language registration (args/result must be JSON-able)."""
        with self._lock:
            self._fns[name] = fn

    def bridge_node(self, node, prefix: str = "node.") -> None:
        """Front a node agent's trial plane for non-Python clients:
        the remote training service becomes reachable from any language
        that can frame JSON."""
        self.register(prefix + "submit_trial",
                      lambda tid, ref, config, iters: node.start_trial(
                          tid, ref, config, iters))
        self.register(prefix + "trial_status", node.trial_status)
        self.register(prefix + "kill_trial", node.kill_trial)
        self.register(prefix + "health", node.health)

    def bridge_experiments(self, manager,
                           prefix: str = "experiment.") -> None:
        """Front the durable experiment manager (the nnictl surface) for
        non-Python clients: create/start/status/results from any
        language. ``start`` runs the (blocking) experiment on a daemon
        thread and returns immediately — the client polls ``status``."""
        def start(name: str) -> str:
            manager.spec(name)           # unknown name fails THE CALL,
                                         # not a detached thread

            def run():
                try:
                    manager.run(name)
                except Exception:
                    # pre-lock failures (e.g. already running) must not
                    # die as a silent daemon-thread traceback; run()
                    # itself records post-lock failures as 'failed'
                    traceback.print_exc()

            threading.Thread(target=run, daemon=True,
                             name=f"xlang-exp-{name}").start()
            return "started"

        self.register(prefix + "create", manager.create)
        self.register(prefix + "start", start)
        self.register(prefix + "status", manager.status)
        self.register(prefix + "results", manager.results)
        self.register(prefix + "list", manager.list)

    # -- serving -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    req = _recv_json(conn)
                except (ConnectionError, OSError):
                    return
                try:
                    name = req["method"]
                    with self._lock:
                        fn = self._fns.get(name)
                    if fn is None:
                        raise KeyError(f"unknown method {name!r}")
                    result = fn(*req.get("args", []),
                                **req.get("kwargs", {}))
                    resp = {"ok": True, "result": result}
                    json.dumps(resp)       # JSON-ability is the contract
                except Exception as e:
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-1000:]}
                try:
                    _send_json(conn, resp)
                except (ConnectionError, OSError):
                    return

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass


def xlang_call(address: str, method: str, *args,
               timeout: float = 30.0, **kwargs) -> Any:
    """Python-side reference client (the same wire the C++ client
    speaks); raises RuntimeError on a remote error."""
    host, _, port = address.rpartition(":")
    with socket.create_connection((host or "127.0.0.1", int(port)),
                                  timeout=timeout) as sock:
        _send_json(sock, {"method": method, "args": list(args),
                          "kwargs": kwargs})
        resp = _recv_json(sock)
    if not resp.get("ok"):
        raise RuntimeError(resp.get("error", "remote error"))
    return resp.get("result")
