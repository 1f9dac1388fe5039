"""Shared threaded-HTTP scaffold for the observability endpoints.

One server lifecycle (quiet handler, daemon thread, url, shutdown) used
by both :class:`~tosem_tpu_torch.obs.metrics.MetricsServer` and
:class:`~tosem_tpu_torch.obs.dashboard.DashboardServer`, so serving
fixes land in one place. The port's copy of ``tosem_tpu/obs/httpd.py``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Tuple

Route = Callable[[str], Tuple[int, str, bytes]]   # path -> status/ctype/body


class RouteServer:
    def __init__(self, route: Route, host: str = "127.0.0.1",
                 port: int = 0, name: str = "obs-http"):
        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):            # quiet
                pass

            def do_GET(self):
                try:
                    status, ctype, body = route(self.path)
                except Exception as e:            # route bug ≠ dead server
                    status = 500
                    ctype = "application/json"
                    body = json.dumps({"error": repr(e)}).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name=name)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)
