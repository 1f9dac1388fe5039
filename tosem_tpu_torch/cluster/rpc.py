"""TCP RPC layer — the cluster-internal control plane.

The reference's control plane is gRPC services between driver, raylets,
and the GCS (`src/ray/rpc/` — NodeManagerService, CoreWorkerService;
`src/ray/protobuf/*.proto`). Single-binary translation: length-prefixed
pickle frames over TCP with a thread-per-connection server and a
persistent-connection client. Pickle keeps the surface tiny and is
acceptable for the same reason the reference's protobuf services don't
authenticate: this is a **cluster-internal, trusted-network** protocol
(bind to loopback or a private interconnect, never the open internet).

Frame: 4-byte big-endian length + pickle payload.
Request: ``(method: str, args: tuple, kwargs: dict)``.
Response: ``("ok", value)`` or ``("err", repr, traceback_str)``.

A copy of the JAX package's ``cluster/rpc.py``: the frames are the same
bytes, so either package's client calls the other's server.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

_LEN = struct.Struct(">I")
MAX_FRAME = 256 << 20


def _check_bind_host(host: str) -> None:
    """Pickle frames are remote code execution by design (trusted-network
    protocol, see module docstring) — refuse to let that surface reach a
    public interface silently. Loopback and RFC1918/link-local binds pass;
    anything else (including 0.0.0.0) gets a loud warning."""
    import ipaddress
    import warnings
    if host == "":
        # empty host binds INADDR_ANY — same exposure as 0.0.0.0
        warnings.warn(
            "RpcServer binding to all interfaces (host=\"\"): this exposes "
            "an unauthenticated pickle-RPC (remote-code-execution) surface "
            "beyond loopback/private networks", RuntimeWarning,
            stacklevel=3)
        return
    try:
        addr = ipaddress.ip_address(host)
    except ValueError:
        if host == "localhost":
            return
        warnings.warn(
            f"RpcServer binding to non-address host {host!r}: the pickle "
            "RPC protocol executes arbitrary objects from the wire and "
            "must never face an untrusted network", RuntimeWarning,
            stacklevel=3)
        return
    if addr.is_loopback or (addr.is_private and not addr.is_unspecified):
        return
    warnings.warn(
        f"RpcServer binding to {host}: this exposes an unauthenticated "
        "pickle-RPC (remote-code-execution) surface beyond loopback/"
        "private networks", RuntimeWarning, stacklevel=3)


class RpcError(RuntimeError):
    """Remote handler raised; carries the remote traceback."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


def _send_frame(sock: socket.socket, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
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


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise ConnectionError("oversized frame")
    return pickle.loads(_recv_exact(sock, n))


class RpcServer:
    """Thread-per-connection request server.

    ``handlers``: a dict of name → callable, or any object whose public
    methods become handlers (the service-definition role of a .proto).
    """

    def __init__(self, handlers: Any, host: str = "127.0.0.1",
                 port: int = 0):
        if isinstance(handlers, dict):
            self._handlers: Dict[str, Callable] = dict(handlers)
        else:
            self._handlers = {
                n: getattr(handlers, n) for n in dir(handlers)
                if not n.startswith("_")
                and callable(getattr(handlers, n))}
        _check_bind_host(host)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._shutdown = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="tosem-rpc-accept")
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="tosem-rpc-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    method, args, kwargs = _recv_frame(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                try:
                    fn = self._handlers.get(method)
                    if fn is None:
                        raise KeyError(f"no such RPC method {method!r}")
                    _send_frame(conn, ("ok", fn(*args, **kwargs)))
                except ConnectionError:
                    return
                except BaseException as e:  # ship the error to the caller
                    try:
                        _send_frame(conn, ("err", repr(e),
                                           traceback.format_exc()))
                    except Exception:
                        return
        finally:
            conn.close()

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass


class RpcClient:
    """Persistent-connection caller; thread-safe (one in-flight call at
    a time per client, the simple-stub model).

    ``timeout`` bounds connection establishment; ``call_timeout`` bounds
    each request/response round trip (None = wait forever — the right
    default for long-running remote tasks; pass a bound for health
    probes so a wedged peer can't hang the caller).
    """

    def __init__(self, address: str, timeout: float = 30.0,
                 call_timeout: Optional[float] = None):
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout
        self._call_timeout = call_timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # the connect timeout must not linger as a read timeout: a
            # slow handler is not a dead peer
            s.settimeout(self._call_timeout)
            self._sock = s
        return self._sock

    def call(self, method: str, *args, **kwargs) -> Any:
        with self._lock:
            try:
                sock = self._connect()
                _send_frame(sock, (method, args, kwargs))
                status, *rest = _recv_frame(sock)
            except socket.timeout:
                self.close()
                raise TimeoutError(
                    f"rpc to {self._addr} timed out ({method})")
            except (ConnectionError, OSError):
                self.close()
                raise ConnectionError(
                    f"rpc to {self._addr} failed ({method})")
        if status == "ok":
            return rest[0]
        raise RpcError(rest[0], rest[1] if len(rest) > 1 else "")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **k: self.call(name, *a, **k)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
