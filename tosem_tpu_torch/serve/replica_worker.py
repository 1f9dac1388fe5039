"""Serve replica process — one backend behind its own RPC server.

The reference's replicas are actor processes the router talks to
directly (``serve/backend_worker.py``); the cluster serving plane keeps
that shape: a node agent spawns this worker (one process per replica,
``cluster/node.py:start_replica``), it instantiates the backend named
by ``--backend module:qualname`` and serves ``call``/``call_batch``/
``warmup``/``load``/``stats`` over
:class:`~tosem_tpu_torch.cluster.rpc.RpcServer`.
The router tier holds a client per replica address — requests never
bounce through the agent.

Two wire details the router relies on:

- ``call`` returns ``{"value": ..., "load": n}`` — the replica's
  in-flight depth rides every response, so the router's queue-depth
  view refreshes for free instead of paying a scrape RPC per request
  (the bench-noise rule: no per-step remote scrapes).
- A backend exception travels as an ``RpcError`` (application error:
  never retried, counted against the breaker); a dead replica surfaces
  as ``ConnectionError`` (retried on a surviving replica).

Import discipline: this module must not import torch or numpy — cheap
backends (echo, bench synthetics) boot in well under a second, and a
model backend's torch import (and its CUDA context) happens in the
replica process, when ``--backend`` is resolved.

A copy of the JAX package's ``serve/replica_worker.py``. A replica that
fails to build or launch a kernel fails its backend's construction or
``warmup``, so the placing ``deploy`` fails with the replica's error.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# import-light on purpose (os + threading only) — the fencing watermark
# must be importable here without dragging in torch/numpy
from tosem_tpu_torch.cluster.fencing import Watermark


def resolve_backend(ref: str):
    """``"module:qualname"`` → class/factory (the trainable_ref idiom
    of the trial plane, reused so one addressing scheme names every
    code object that ships to another process)."""
    mod_name, _, qual = ref.partition(":")
    if not mod_name or not qual:
        raise ValueError(f"backend ref {ref!r} is not 'module:qualname'")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


class ReplicaHandlers:
    """RPC surface of one replica (the backend_worker role)."""

    def __init__(self, backend: Any):
        self._backend = backend
        self._lock = threading.Lock()
        self._inflight = 0
        self._served = 0
        self._errors = 0
        self._started = time.time()
        # epoch watermark: control-plane writes stamped with an older
        # head epoch than the highest this replica has seen are rejected
        # typed (StaleEpochError) — a superseded head cannot double-
        # adopt KV state or stop a replica the new head owns
        self._epoch = Watermark()
        # throttled prefix-digest snapshot piggybacked on responses
        # (routers learn which prefixes live here without extra RPCs)
        self._digest = None
        self._digest_ts = 0.0

    _DIGEST_TTL_S = 0.25

    def _prefix_digest(self):
        fn = getattr(self._backend, "prefix_digest", None)
        if not callable(fn):
            return None
        now = time.monotonic()
        if now - self._digest_ts > self._DIGEST_TTL_S:
            try:
                self._digest = fn()
            except Exception:
                self._digest = None
            self._digest_ts = now
        return self._digest

    def _enter(self) -> None:
        with self._lock:
            self._inflight += 1

    def _leave(self, ok: bool) -> int:
        with self._lock:
            self._inflight -= 1
            self._served += 1
            if not ok:
                self._errors += 1
            return self._inflight

    def call(self, request: Any) -> Dict[str, Any]:
        self._enter()
        ok = False
        try:
            value = self._backend.call(request)
            ok = True
        finally:
            depth = self._leave(ok)
        out = {"value": value, "load": depth}
        digest = self._prefix_digest()
        if digest:
            out["prefixes"] = digest
        return out

    def call_batch(self, requests: List[Any],
                   bucket: Optional[int] = None) -> Dict[str, Any]:
        self._enter()
        ok = False
        try:
            values = self._backend.call_batch(requests, bucket)
            ok = True
        finally:
            depth = self._leave(ok)
        return {"value": values, "load": depth}

    def warmup(self, shapes: List[Any]) -> Any:
        if hasattr(self._backend, "warmup"):
            return self._backend.warmup(shapes)
        return {"warmed": 0}

    def backend_call(self, method: str, *args: Any,
                     **kwargs: Any) -> Any:
        """Forward a control-plane call to a PUBLIC backend method —
        the decode-migration surface (``list_seqs`` /
        ``transport_address`` / ``send_seq`` / ``adopt_seq`` /
        ``export_seq`` / ``import_seq``) without widening the fixed
        data-plane RPC vocabulary. Only the tiny control messages ride
        this path; migrated page bytes stream replica→replica over
        :mod:`tosem_tpu_torch.cluster.transport` (no driver hop).

        The reserved ``_epoch`` kwarg (never forwarded to the backend)
        is the caller head's fencing epoch: a value below this
        replica's watermark raises
        :class:`~tosem_tpu_torch.cluster.fencing.StaleEpochError` instead of
        mutating state — the fence that makes a superseded head's
        ``adopt_seq`` a typed no-op rather than a double adoption."""
        epoch = kwargs.pop("_epoch", None)
        self._epoch.check(epoch, what=f"backend_call:{method}")
        if method.startswith("_"):
            raise ValueError(f"backend method {method!r} is private")
        fn = getattr(self._backend, method, None)
        if not callable(fn):
            raise KeyError(f"backend has no method {method!r}")
        return fn(*args, **kwargs)

    def fence(self, epoch: int) -> int:
        """Advance the replica's epoch watermark (a recovered head
        fences the replicas it re-adopts). Monotonic: fencing to an
        OLDER epoch raises — the new head cannot be fenced out by a
        delayed call from the superseded one."""
        self._epoch.check(int(epoch), what="fence")
        return self._epoch.epoch

    def load(self) -> int:
        with self._lock:
            return self._inflight

    def health(self) -> Dict[str, Any]:
        return {"ok": True, "pid": os.getpid(),
                "uptime_s": time.time() - self._started}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"pid": os.getpid(), "inflight": self._inflight,
                   "served": self._served, "errors": self._errors}
        if hasattr(self._backend, "stats"):
            try:
                backend_stats = self._backend.stats()
                if isinstance(backend_stats, dict):
                    out.update(backend_stats)
            except Exception:
                pass          # telemetry must never fail the data plane
        return out


def serve_replica(backend_ref: str, init_kwargs: Dict[str, Any],
                  port: int = 0, announce_fd: Optional[int] = None,
                  lifeline_fd: Optional[int] = None) -> None:
    """Run one replica until killed, or until the lifeline pipe hits
    EOF — the write end lives in the spawning agent, so the replica
    dies WITH its agent however the agent goes (SIGKILL included; a
    dead node must not leave orphan replicas answering on old ports —
    PDEATHSIG is not deliverable on every kernel this runs under)."""
    from tosem_tpu_torch.cluster.rpc import RpcServer
    backend = resolve_backend(backend_ref)(**init_kwargs)
    server = RpcServer(ReplicaHandlers(backend), port=port)
    line = f"{server.address}\n".encode()
    if announce_fd is not None:
        os.write(announce_fd, line)
        os.close(announce_fd)
    else:
        sys.stdout.write(line.decode())
        sys.stdout.flush()
    try:
        if lifeline_fd is not None:
            while os.read(lifeline_fd, 1):
                pass             # nothing is ever written; EOF = parent died
        else:
            while True:
                time.sleep(3600)
    except (KeyboardInterrupt, OSError):
        pass
    finally:
        server.shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    backend_ref, kwargs_json, port = "", "{}", 0
    announce_fd, lifeline_fd = None, None
    i = 0
    while i < len(args):
        if args[i] == "--backend":
            backend_ref = args[i + 1]; i += 2
        elif args[i] == "--init-kwargs":
            kwargs_json = args[i + 1]; i += 2
        elif args[i] == "--port":
            port = int(args[i + 1]); i += 2
        elif args[i] == "--announce-fd":
            announce_fd = int(args[i + 1]); i += 2
        elif args[i] == "--lifeline-fd":
            lifeline_fd = int(args[i + 1]); i += 2
        else:
            print(f"unknown arg {args[i]}", file=sys.stderr)
            return 2
    if not backend_ref:
        print("--backend module:qualname is required", file=sys.stderr)
        return 2
    serve_replica(backend_ref, json.loads(kwargs_json), port=port,
                  announce_fd=announce_fd, lifeline_fd=lifeline_fd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
