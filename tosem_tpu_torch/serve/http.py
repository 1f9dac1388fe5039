"""HTTP ingress for Serve-lite (the reference's proxy role).

``python/ray/serve/api.py:210`` starts an HTTP proxy actor translating
``POST /<endpoint>`` into router calls; single-controller here, so the
proxy is a threaded stdlib HTTP server in the driver process. JSON in,
JSON out; backend errors map to 500, unknown endpoints to 404.

The controller argument duck-types: anything that exposes
``get_deployment`` / ``get_handle`` / ``list_deployments`` / ``stats``,
as :class:`~tosem_tpu_torch.serve.core.Serve` does, and
:class:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe`. A handle whose
``call()`` takes ``key=`` gets ``POST /<endpoint>?key=<affinity>``.

The port's copy of ``tosem_tpu/serve/http.py``. Like the JAX package's,
a reply is ``json.dumps`` of the backend's result, so a backend that
returns numpy arrays (``BertEncodeBackend``) answers 500 ``TypeError``
over HTTP; call it through a handle (ROADMAP.md C-ref5).

``POST /<endpoint>?stream=1`` switches a decode deployment to chunked
transfer: one JSON line per committed token batch as the scheduler
emits it, then a final ``{"result": ...}`` line. The scheduler thread
never writes the socket — tokens bridge through a queue, so a slow or
dropped client stalls only its own ingress thread.
"""
from __future__ import annotations

import inspect
import json
import queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from tosem_tpu_torch.serve.core import Serve


class HttpIngress:
    def __init__(self, serve: Serve, host: str = "127.0.0.1",
                 port: int = 0, request_timeout: float = 30.0):
        ingress = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet
                pass

            def do_POST(self):
                parts = urlsplit(self.path)
                name = parts.path.strip("/")
                if serve.get_deployment(name) is None:
                    self._reply(404, {"error": f"no endpoint {name!r}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(n) or b"null")
                    handle = serve.get_handle(name)
                    qs = parse_qs(parts.query)
                    key = qs.get("key", [None])[0]
                    stream = qs.get("stream", ["0"])[0] \
                        not in ("0", "", "false")
                    if stream and hasattr(handle, "stream"):
                        self._stream(handle, request)
                        return
                    # affinity key: only a handle whose call() declares
                    # key= routes on it (the cluster handle); detected
                    # by SIGNATURE, never by catching TypeError around
                    # the live call — a backend's own TypeError must
                    # not trigger a second execution of the request
                    kwargs = {}
                    if key is not None and "key" in inspect.signature(
                            handle.call).parameters:
                        kwargs["key"] = key
                    result = handle.call(
                        request, timeout=ingress.request_timeout,
                        **kwargs)
                    self._reply(200, {"result": result})
                except Exception as e:  # backend failure → 500, not a crash
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _stream(self, handle, request) -> None:
                """Per-token chunked streaming: the decode scheduler
                pushes committed tokens into a queue (its callback
                never blocks on this socket); THIS thread drains the
                queue into chunked-transfer JSON lines."""
                q: "queue.Queue" = queue.Queue()

                def on_token(tokens, done):
                    q.put((tokens, done))

                worker_err = []

                def run():
                    try:
                        result = handle.stream(
                            request, on_token,
                            timeout=ingress.request_timeout)
                        q.put(("__result__", result))
                    except BaseException as e:
                        worker_err.append(e)
                        q.put(("__error__", e))

                t = threading.Thread(target=run, daemon=True,
                                     name="serve-http-stream")
                t.start()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    while True:
                        kind, payload = q.get(
                            timeout=ingress.request_timeout)
                        if kind == "__error__":
                            self._chunk({"error":
                                         f"{type(payload).__name__}: "
                                         f"{payload}"})
                            break
                        if kind == "__result__":
                            self._chunk({"result": payload})
                            break
                        self._chunk({"tokens": list(kind),
                                     "done": bool(payload)})
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionError, OSError,
                        queue.Empty):
                    pass     # client gone / stalled: fails alone

            def _chunk(self, payload) -> None:
                body = json.dumps(payload).encode() + b"\n"
                self.wfile.write(f"{len(body):x}\r\n".encode()
                                 + body + b"\r\n")
                self.wfile.flush()

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/-", "/-/routes"):
                    self._reply(200, {"routes": serve.list_deployments()})
                elif self.path.rstrip("/") == "/-/stats":
                    # data-plane telemetry: queue depth, batch sizes,
                    # per-request outcome counts — the operator's view
                    # of whether batching is actually engaging
                    payload = {"deployments": serve.stats()}
                    # distributed-training jobs share the stats surface
                    # (dp size, step, examples/s) when any are live; none
                    # can be unless their module is loaded, and a
                    # control-plane process need not load torch for this
                    try:
                        dist = sys.modules.get(
                            "tosem_tpu_torch.train.distributed")
                        train = dist.jobs_stats() if dist else {}
                        if train:
                            payload["train"] = train
                    except Exception:
                        pass     # telemetry never fails the endpoint
                    self._reply(200, payload)
                else:
                    self._reply(404, {"error": "POST to /<endpoint>"})

            def _reply(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.request_timeout = request_timeout
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
