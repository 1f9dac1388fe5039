"""Chunked cross-node tensor transport — framed binary streams that
land in the object store and map in place.

The port's copy of ``tosem_tpu/cluster/transport.py``, with torch
tensors where the reference has numpy arrays. The wire is the
reference's byte for byte (``MAGIC``, ``TRANSPORT_WIRE_VERSION``, the
header JSON, the chunk frames), so either package's sender streams to
the other's receiver: a dtype travels under numpy's name for it
(``"float32"``, ``"bfloat16"``, ``"bool"``), and a ``"bfloat16"`` spec
arrives here as a ``torch.bfloat16`` tensor with the same bits.

- **Framed, chunked wire.** A stream is one header frame (JSON: wire
  version, array specs, free-form metadata — for KV migration the
  metadata carries the :mod:`~tosem_tpu_torch.serve.kv_cache` wire
  header, so the spill payload IS the wire format) followed by sequence-
  numbered chunk frames and a FIN frame. Every frame is length-
  prefixed; a torn stream mid-chunk, a truncated header, or an
  out-of-order chunk index is a typed error
  (:class:`WireFormatError` / :class:`TransportError`), never a
  silently-short tensor.
- **Received into the object store, mapped in place.** The receiver
  reserves the stream's full byte extent in a shared-memory object
  store segment (:mod:`tosem_tpu_torch.runtime.object_store`,
  create/seal), copies each chunk at its wire offset — at most ONE copy
  per chunk — seals, and hands consumers CPU tensors that alias the
  segment (no hop through a coordinator, no heap copy on arrival). When
  no segment is available the receiver degrades to a heap buffer with
  identical semantics.
- **Acknowledged commit.** The sender blocks until the receiver has
  sealed the stream, so a migration caller that sees
  :func:`send_tensors` return knows the destination OWNS the bytes —
  the source copy is then safe to free.
- **Host tensors only.** Tensors are sent from and arrive on the CPU. A
  CUDA tensor is refused: the caller copies it to the host itself, so
  a device-to-host copy is never hidden in a send.

Transport note: same trusted-network posture as the reference's RPC
layer (bind loopback or a private interconnect; the header is JSON, the
payload raw bytes — nothing on this wire executes).
"""
from __future__ import annotations

import ipaddress
import json
import os
import queue
import socket
import struct
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.chaos import network as _net
from tosem_tpu_torch.obs import metrics as _metrics

__all__ = ["TensorReceiver", "send_tensors", "send_kv_payload",
           "received_kv_payload", "TransportError", "WireFormatError",
           "ReceivedTensors", "TRANSPORT_WIRE_VERSION",
           "DEFAULT_CHUNK_BYTES"]

TRANSPORT_WIRE_VERSION = 1
MAGIC = b"KVX1"
DEFAULT_CHUNK_BYTES = 1 << 20
MAX_HEADER = 16 << 20
MAX_TOTAL = 4 << 30

_HLEN = struct.Struct(">I")
_CHUNK = struct.Struct(">IQI")          # (index, offset, length)
_FIN_INDEX = 0xFFFFFFFF


def _check_bind_host(host: str) -> None:
    """The reference's ``cluster/rpc.py`` guard, copied: loopback and
    RFC1918/link-local binds pass; anything else (including 0.0.0.0 and
    the empty host) gets a loud warning, because nothing on this wire
    is authenticated."""
    if host == "":
        warnings.warn(
            "TensorReceiver binding to all interfaces (host=\"\"): this "
            "exposes an unauthenticated stream surface beyond loopback/"
            "private networks", RuntimeWarning, stacklevel=3)
        return
    try:
        addr = ipaddress.ip_address(host)
    except ValueError:
        if host == "localhost":
            return
        warnings.warn(
            f"TensorReceiver binding to non-address host {host!r}: the "
            "transport must never face an untrusted network",
            RuntimeWarning, stacklevel=3)
        return
    if addr.is_loopback or (addr.is_private and not addr.is_unspecified):
        return
    warnings.warn(
        f"TensorReceiver binding to {host}: this exposes an "
        "unauthenticated stream surface beyond loopback/private networks",
        RuntimeWarning, stacklevel=3)


# numpy's dtype names, as the reference writes them into a spec, for
# the torch dtypes that have one
_WIRE_NAMES = ("bool", "uint8", "int8", "int16", "int32", "int64",
               "uint16", "uint32", "uint64", "float16", "bfloat16",
               "float32", "float64", "complex64", "complex128")


def wire_dtype_name(dtype) -> str:
    """A torch dtype's name on the wire (numpy's name for it)."""
    name = str(dtype).replace("torch.", "")
    if name not in _WIRE_NAMES:
        raise TypeError(f"{dtype} has no transport wire name")
    return name


def wire_dtype(name: str):
    """The torch dtype a spec's ``"dtype"`` names."""
    import torch
    if name not in _WIRE_NAMES or not hasattr(torch, name):
        raise WireFormatError(f"unknown wire dtype {name!r}")
    return getattr(torch, name)


class TransportError(ConnectionError):
    """Stream-level failure: torn stream mid-chunk, dead peer,
    receiver-side abort. The bytes on the floor are gone — the caller
    retries the whole stream (sends are idempotent by key)."""


class WireFormatError(TransportError):
    """Protocol violation: bad magic, truncated/oversized header,
    out-of-order or out-of-bounds chunk, FIN/total mismatch."""


def transport_counters():
    """The transport's instruments (registered once in the default
    registry — the ``metric_defs.h`` discipline):
    ``cluster_transport_bytes_total`` counts payload bytes by
    ``direction`` (sent/received) and
    ``cluster_transport_streams_total`` stream outcomes by ``outcome``
    (ok/error/duplicate — duplicate being a re-sent stream dropped by
    the receiver's by-key dedupe)."""
    return {
        "bytes": _metrics.counter(
            "cluster_transport_bytes_total",
            "tensor-transport payload bytes by direction",
            labels=("direction",)),
        "streams": _metrics.counter(
            "cluster_transport_streams_total",
            "tensor-transport stream outcomes",
            labels=("outcome",)),
    }


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except OSError as e:
            raise TransportError(f"torn stream reading {what}: {e}")
        if not chunk:
            raise TransportError(
                f"torn stream: peer closed mid-{what} "
                f"({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def _recv_into(sock: socket.socket, view: memoryview, what: str) -> None:
    """Receive exactly ``len(view)`` bytes DIRECTLY into ``view`` —
    the at-most-one-memcpy-per-chunk contract: kernel → destination
    buffer, no intermediate bytes object."""
    got = 0
    n = len(view)
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except OSError as e:
            raise TransportError(f"torn stream reading {what}: {e}")
        if r == 0:
            raise TransportError(
                f"torn stream: peer closed mid-{what} ({got}/{n} bytes)")
        got += r


class ReceivedTensors:
    """One committed stream: metadata + zero-copy tensor views.

    ``arrays()`` returns CPU tensors aliasing the receive buffer (the
    shm segment when store-backed — the mapping pins the pages until
    :meth:`release`). They are read-only by contract (torch has no
    read-only tensors): map transients, copy keepsakes."""

    def __init__(self, meta: Dict[str, Any], specs: List[Dict[str, Any]],
                 view: memoryview, release_cb=None):
        self.meta = meta
        self._specs = specs
        self._view = view
        self._release_cb = release_cb
        self.nbytes = len(view)

    def arrays(self) -> Dict[str, Any]:
        import torch
        out = {}
        for spec in self._specs:
            off, nb = int(spec["offset"]), int(spec["nbytes"])
            dtype = wire_dtype(str(spec["dtype"]))
            shape = [int(d) for d in spec["shape"]]
            if nb == 0:
                out[spec["name"]] = torch.empty(shape, dtype=dtype)
                continue
            with warnings.catch_warnings():
                # the committed view is read-only; so are these tensors
                warnings.filterwarnings("ignore", message=".*not writable.*")
                t = torch.frombuffer(self._view[off:off + nb], dtype=dtype)
            out[spec["name"]] = t.reshape(shape)
        return out

    def release(self) -> None:
        """Drop the buffer pin (store-backed: unpins + deletes the
        segment object so the pages recycle). Views handed out by
        :meth:`arrays` must not be read after this."""
        cb, self._release_cb = self._release_cb, None
        if cb is not None:
            cb()

    def __enter__(self) -> "ReceivedTensors":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _StoreBuffers:
    """Receive-buffer allocator over a dedicated object-store segment
    (reserve → chunk memcpys → seal → map in place). Falls back to
    heap bytearrays when the native segment cannot be created."""

    def __init__(self, capacity: int):
        self._store = None
        self._lock = threading.Lock()
        self._n = 0
        try:
            from tosem_tpu_torch.runtime.object_store import ObjectStore
            name = f"/tosem_torch_xfer_{os.getpid()}_{id(self) % 100000}"
            self._store = ObjectStore(name, capacity=capacity)
        except Exception:
            self._store = None          # heap fallback, same semantics

    @property
    def store_backed(self) -> bool:
        return self._store is not None

    def open(self, size: int):
        """→ (writable view, commit() -> (readonly view, release_cb),
        abort()). ``commit`` seals and maps in place (store mode) or
        just freezes the heap buffer."""
        if self._store is None or size == 0:
            buf = bytearray(size)
            view = memoryview(buf)
            return view, (lambda: (memoryview(buf).toreadonly(),
                                   None)), (lambda: None)
        from tosem_tpu_torch.runtime.object_store import ObjectID
        with self._lock:
            self._n += 1
        oid = ObjectID.random()
        try:
            view = self._store.reserve(oid, size)
        except Exception:
            # segment full / raced: heap fallback for THIS stream
            buf = bytearray(size)
            hview = memoryview(buf)
            return hview, (lambda: (memoryview(buf).toreadonly(),
                                    None)), (lambda: None)
        store = self._store

        def commit():
            store.seal(oid)
            handle = store.get_mapped(oid)

            def release():
                handle.release()
                try:
                    store.delete(oid)
                except Exception:
                    pass
            return handle.view, release

        def abort():
            try:
                store.abort(oid)
            except Exception:
                pass
        return view, commit, abort

    def close(self) -> None:
        if self._store is not None:
            try:
                self._store.close()
            except Exception:
                pass
            self._store = None


class TensorReceiver:
    """Server half of the transport: accepts framed tensor streams and
    parks committed payloads for :meth:`take` / :meth:`pop`.

    One stream per connection; concurrent streams ride concurrent
    connections (thread-per-stream, like the RPC server). Streams
    carrying a ``meta["key"]`` are retrievable by key (the KV-
    migration adopt path); keyless streams queue FIFO."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store_capacity: int = 256 << 20):
        _check_bind_host(host)
        self._buffers = _StoreBuffers(store_capacity)
        self._metrics = transport_counters()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._by_key: Dict[str, ReceivedTensors] = {}
        self._fifo: "queue.Queue[ReceivedTensors]" = queue.Queue()
        self._received = 0
        self._errors = 0
        self._bytes = 0
        self._intr_seq = 0
        self._last_error = ""
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="tosem-torch-xfer-accept")
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def store_backed(self) -> bool:
        """True when arrivals map in place over a shm segment (the
        zero-heap-copy path); False on the heap fallback."""
        return self._buffers.store_backed

    # ------------------------------------------------------------ server

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_stream, args=(conn,),
                             daemon=True,
                             name="tosem-torch-xfer-stream").start()

    def _serve_stream(self, conn: socket.socket) -> None:
        abort = None
        try:
            rx, abort = self._read_stream(conn)
        except (TransportError, WireFormatError, ValueError,
                json.JSONDecodeError) as e:
            if abort is not None:
                abort()
            with self._lock:
                self._errors += 1
                self._last_error = repr(e)
            self._metrics["streams"].inc(1, ("error",))
            try:
                blob = repr(e).encode()[:4096]
                conn.sendall(b"ER" + _HLEN.pack(len(blob)) + blob)
            except OSError:
                pass
            conn.close()
            return
        key = rx.meta.get("key")
        duplicate = False
        with self._cv:
            self._received += 1
            self._bytes += rx.nbytes
            if key is not None:
                if str(key) in self._by_key:
                    # duplicate delivery: the sender's COMMIT ack was
                    # lost and it re-sent the whole stream. The FIRST
                    # copy is the committed one — consumers may already
                    # hold views over it — so the replay is drained
                    # (fully read above) and DROPPED, never clobbering
                    # the parked payload and never pinning two copies
                    duplicate = True
                else:
                    self._by_key[str(key)] = rx
            else:
                self._fifo.put(rx)
            self._cv.notify_all()
        if duplicate:
            rx.release()
        self._metrics["bytes"].inc(rx.nbytes, ("received",))
        self._metrics["streams"].inc(
            1, ("duplicate" if duplicate else "ok",))
        try:
            conn.sendall(b"OK")
        except OSError:
            pass                    # sender gone: the payload still landed
        conn.close()

    def _read_stream(self, conn: socket.socket):
        magic = _recv_exact(conn, len(MAGIC), "magic")
        if magic != MAGIC:
            raise WireFormatError(f"bad magic {magic!r}")
        (hlen,) = _HLEN.unpack(_recv_exact(conn, 4, "header length"))
        if hlen == 0 or hlen > MAX_HEADER:
            raise WireFormatError(f"header length {hlen} outside "
                                  f"(0, {MAX_HEADER}]")
        try:
            header = json.loads(_recv_exact(conn, hlen, "header"))
        except json.JSONDecodeError as e:
            raise WireFormatError(f"truncated/garbled header: {e}")
        if header.get("version") != TRANSPORT_WIRE_VERSION:
            raise WireFormatError(
                f"transport wire version {header.get('version')!r} != "
                f"{TRANSPORT_WIRE_VERSION}")
        try:
            total = int(header["total_bytes"])
            specs = list(header["arrays"])
            meta = dict(header.get("meta") or {})
        except (KeyError, TypeError) as e:
            raise WireFormatError(f"header missing required field: {e}")
        if not 0 <= total <= MAX_TOTAL:
            raise WireFormatError(f"total_bytes {total} outside "
                                  f"[0, {MAX_TOTAL}]")
        if sum(int(s.get("nbytes", -1)) for s in specs) != total:
            raise WireFormatError("array specs do not sum to "
                                  "total_bytes")
        # specs must tile [0, total) exactly — overlapping or
        # out-of-bounds offsets would hand consumers silently-aliased
        # or out-of-range views AFTER the stream was acked OK
        off_check = 0
        for s in sorted(specs, key=lambda s: int(s.get("offset", -1))):
            o, n = int(s.get("offset", -1)), int(s.get("nbytes", -1))
            if o != off_check or n < 0:
                raise WireFormatError(
                    f"array spec {s.get('name')!r} spans [{o}, {o + n})"
                    f" but [{off_check}, …) was expected — specs must "
                    "tile the payload exactly")
            off_check += n
        view, commit, abort = self._buffers.open(total)
        try:
            expect_idx, off = 0, 0
            while True:
                idx, c_off, c_len = _CHUNK.unpack(
                    _recv_exact(conn, _CHUNK.size, "chunk header"))
                if idx == _FIN_INDEX:
                    if c_off != off or off != total:
                        raise WireFormatError(
                            f"FIN at {c_off} but received {off} of "
                            f"{total} bytes")
                    break
                if idx != expect_idx:
                    raise WireFormatError(
                        f"out-of-order chunk {idx} (expected "
                        f"{expect_idx}) — the transport is strictly "
                        "sequential per stream")
                if c_off != off or c_len == 0 or off + c_len > total:
                    raise WireFormatError(
                        f"chunk {idx} spans [{c_off}, {c_off + c_len}) "
                        f"outside the expected [{off}, {total}] extent")
                _recv_into(conn, view[off:off + c_len], f"chunk {idx}")
                off += c_len
                expect_idx += 1
        except BaseException:
            abort()
            raise

        ro_view, release = commit()
        return ReceivedTensors(meta, specs, ro_view, release), None

    # ------------------------------------------------------------ client

    def take(self, timeout: Optional[float] = 30.0) -> ReceivedTensors:
        """Next keyless stream, FIFO. Raises :class:`TimeoutError`."""
        try:
            return self._fifo.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no tensor stream arrived in time")

    def pop(self, key: str, timeout: Optional[float] = 30.0
            ) -> ReceivedTensors:
        """The stream sent with ``meta["key"] == key`` (the migration
        adopt path — streams land in any order). Raises
        :class:`TimeoutError` when it never arrives, or
        :class:`TransportError` when :meth:`interrupt` wakes the wait
        (a peer died — there is no point riding out the timeout)."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            entry_seq = self._intr_seq
            while str(key) not in self._by_key:
                if self._intr_seq != entry_seq:
                    raise TransportError(
                        f"wait for stream {key!r} interrupted")
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    last = self._last_error or "none"
                    raise TimeoutError(
                        f"stream {key!r} never arrived "
                        f"(last transport error: {last})")
                self._cv.wait(timeout=remaining)
            return self._by_key.pop(str(key))

    def interrupt(self) -> None:
        """Wake every blocked :meth:`pop` and fail it with
        :class:`TransportError` NOW — the caller learned out-of-band
        (a failure detector, a dead peer) that the streams it is
        waiting for can never arrive, so riding out the timeout only
        delays recovery. The receiver keeps serving: committed streams
        stay claimable and waits entered after this call are
        unaffected."""
        with self._cv:
            self._intr_seq += 1
            self._cv.notify_all()

    def put_back(self, key: str, rx: ReceivedTensors) -> None:
        """Re-park a popped stream under its key (a consumer that hit
        transient pressure retries the adopt later without re-paying
        the transfer)."""
        with self._cv:
            self._by_key[str(key)] = rx
            self._cv.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"received": self._received, "errors": self._errors,
                    "bytes_received": self._bytes,
                    "pending_keys": sorted(self._by_key),
                    "store_backed": self.store_backed,
                    "last_error": self._last_error}

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._buffers.close()

    def __enter__(self) -> "TensorReceiver":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def send_tensors(address: str, meta: Dict[str, Any],
                 arrays: Dict[str, Any], *,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 timeout: float = 60.0,
                 pace_bps: Optional[float] = None) -> int:
    """Stream ``arrays`` (name → CPU tensor) to a
    :class:`TensorReceiver` at ``address`` (this package's or the
    reference's); blocks until the receiver
    COMMITTED the stream (sealed into its store). Returns payload
    bytes sent. ``meta`` rides the header frame verbatim (JSON-safe
    values only); set ``meta["key"]`` for by-key retrieval.

    ``pace_bps`` emulates a bandwidth-limited interconnect: chunk sends
    are paced (sleeps, which burn no CPU and release the GIL) so the
    stream's payload rate is ≤ ``pace_bps`` bytes/second. On a
    CPU-saturated single host, loopback transfer time is pure CPU work
    (memcpy + syscalls), so nothing can hide behind it; pacing restores
    the cross-node regime — wire time the host CPUs do NOT pay for —
    which is what comms/compute overlap actually hides on a cluster.

    Chaos seam: ``transport.send`` fires once per stream (target: the
    stream key, falling back to the address). Action ``drop`` severs
    the stream (:class:`TransportError` — what a partition does to an
    in-flight transfer), ``delay`` stalls it, ``dup_stream`` replays
    the committed stream in full (the lost-ack retry the receiver's
    by-key dedupe must absorb). The emulated network
    (:mod:`tosem_tpu_torch.chaos.network`) applies too: a partition between
    ``meta["src_node"]`` and ``meta["dst_node"]`` (defaulting to
    head↔address) drops the stream, and an armed ``dup_stream`` is
    consumed per send.

    A CUDA tensor raises ``ValueError``: copy it to the host first."""
    import torch
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    for name, arr in arrays.items():
        if not torch.is_tensor(arr):
            raise TypeError(f"array {name!r} is a {type(arr).__name__}, "
                            "not a torch tensor")
        if arr.device.type != "cpu":
            raise ValueError(f"array {name!r} lies on {arr.device}: the "
                             "transport sends host tensors; copy it to the "
                             "CPU first")
    dup_replay = False
    act = _chaos.fire("transport.send",
                      target=str(meta.get("key") or address))
    if act is not None:
        if act.get("delay_s"):
            time.sleep(act["delay_s"])
        if act["action"] == "drop":
            raise TransportError(
                f"chaos: stream to {address} dropped (partition)")
        if act["action"] == "dup_stream" and meta.get("key"):
            # only keyed streams are deduped by the receiver; replaying
            # a keyless stream would DELIVER the payload twice
            dup_replay = True
    net = _net.state()
    src = str(meta.get("src_node", _net.HEAD))
    dst = str(meta.get("dst_node", address))
    if net.dropped(src, dst):
        raise TransportError(
            f"stream {src} -> {dst} dropped: network partition")
    extra = net.delay(dst)
    if extra > 0:
        time.sleep(extra)
    # keyless streams must not consume the armed fault either — it
    # would silently disarm the dup the NEXT (keyed) stream should eat
    if meta.get("key") and net.take_dup():
        dup_replay = True
    specs, views, total = [], [], 0
    for name, arr in arrays.items():
        a = arr.detach().contiguous()
        nbytes = a.numel() * a.element_size()
        # the spec records the tensor's own shape, so a streamed scalar
        # (a train state's step counter) arrives 0-d
        specs.append({"name": str(name), "dtype": wire_dtype_name(a.dtype),
                      "shape": [int(d) for d in a.shape],
                      "offset": total, "nbytes": int(nbytes)})
        # numpy has no bfloat16: a flat uint8 view of the same memory
        # carries any dtype's bytes
        views.append(memoryview(a.reshape(-1).view(torch.uint8).numpy()))
        total += nbytes
    header = json.dumps({"version": TRANSPORT_WIRE_VERSION,
                         "total_bytes": total, "arrays": specs,
                         "meta": meta}).encode()
    host, _, port = address.rpartition(":")
    mets = transport_counters()

    def _send_once() -> None:
        try:
            sock = socket.create_connection(
                (host or "127.0.0.1", int(port)), timeout=timeout)
        except OSError as e:
            raise TransportError(f"connect to {address} failed: {e}")
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(timeout)
            try:
                sock.sendall(MAGIC + _HLEN.pack(len(header)) + header)
                idx, off = 0, 0
                t0 = time.monotonic()
                for v in views:
                    pos = 0
                    while pos < v.nbytes:
                        n = min(chunk_bytes, v.nbytes - pos)
                        sock.sendall(_CHUNK.pack(idx, off, n))
                        sock.sendall(v[pos:pos + n])
                        pos += n
                        off += n
                        idx += 1
                        if pace_bps:
                            # sleep until the cumulative payload rate
                            # drops back under the emulated bandwidth
                            lag = (off / pace_bps
                                   - (time.monotonic() - t0))
                            if lag > 0:
                                time.sleep(lag)
                sock.sendall(_CHUNK.pack(_FIN_INDEX, off, 0))
                ack = _recv_exact(sock, 2, "ack")
            except socket.timeout:
                raise TransportError(f"send to {address} timed out")
            except OSError as e:
                raise TransportError(f"send to {address} failed: {e}")
            if ack == b"OK":
                return
            if ack == b"ER":
                (elen,) = _HLEN.unpack(
                    _recv_exact(sock, 4, "error length"))
                err = _recv_exact(sock, min(elen, 4096), "error").decode(
                    "utf-8", "replace")
                raise TransportError(f"receiver rejected stream: {err}")
            raise WireFormatError(f"bad ack {ack!r}")
        finally:
            sock.close()

    _send_once()
    mets["bytes"].inc(total, ("sent",))
    if dup_replay:
        # the lost-ack retry: the stream committed but chaos "lost" the
        # OK, so the sender replays the WHOLE stream — the receiver's
        # by-key dedupe drains and drops it. Replay failures are noise
        # (the payload already landed), not caller errors.
        try:
            _send_once()
        except (TransportError, WireFormatError):
            pass
    return total


# --------------------------------------------------------------- KV glue


def _page_tensor(a, dtype: str):
    """A payload's page array as the tensor that goes on the wire: a
    bf16 pool's pages (``uint16`` bits in the port's payloads) as
    ``torch.bfloat16``, so the wire names them ``"bfloat16"`` as the
    reference does."""
    import numpy as np
    import torch
    if torch.is_tensor(a):
        return a
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise WireFormatError(f"bfloat16 pages as {a.dtype} arrays")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def send_kv_payload(address: str, payload: Dict[str, Any], *, key: str,
                    meta: Optional[Dict[str, Any]] = None,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """Stream a :meth:`~tosem_tpu_torch.serve.kv_cache.PagedKVCache.
    export_seq` payload: the page bytes go as chunks under the pool's
    dtype (bf16 pages as ``"bfloat16"``), the KV wire header (version,
    page size, dtype, layout, ``page_offset``) rides the stream
    metadata — the destination's ``import_seq`` validates it before a
    single byte is scattered."""
    header = payload["header"]
    m = {"key": str(key), "kv_header": header}
    if meta:
        m.update(meta)
    dtype = str(header.get("dtype", ""))
    return send_tensors(address, m,
                        {"k": _page_tensor(payload["k"], dtype),
                         "v": _page_tensor(payload["v"], dtype)},
                        chunk_bytes=chunk_bytes)


def received_kv_payload(rx: ReceivedTensors) -> Dict[str, Any]:
    """Rebuild the spill-format payload from a committed stream — the
    page arrays are views over the receive segment in the port's payload
    form (numpy; bf16 as its ``uint16`` bits), so the destination pool's
    scatter is the first (and only) copy off the wire buffer."""
    import numpy as np
    import torch
    header = rx.meta.get("kv_header")
    if not isinstance(header, dict):
        raise WireFormatError("stream carries no kv_header metadata")
    arrs = rx.arrays()

    def page_array(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return {"header": header, "k": page_array(arrs["k"]),
            "v": page_array(arrs["v"]),
            "length": int(header.get("length", 0)),
            "released": int(header.get("page_offset", 0))}
