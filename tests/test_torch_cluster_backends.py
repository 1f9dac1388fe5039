"""Backends the port's cluster tests deploy by ``"module:qualname"``.

Kept apart from the test files because each replica is a fresh
interpreter that imports its backend by name: these import neither JAX
nor the JAX package (the reference's ``ControlLoadBackend`` lives in
``serve/bench_cluster.py``, which the port has not got yet, and its
``_WarmupBoom`` in a test module that imports JAX). No tests here.
"""
from __future__ import annotations

import threading
import time


class ControlLoadBackend:
    """Fixed-service-time backend with warm/cold accounting, a copy of
    the JAX package's ``serve/bench_cluster.py:ControlLoadBackend``.
    ``warmup()`` simulates the executable build (``compile_s``); a call
    served BEFORE warmup counts a ``cold_serve`` and pays the build
    inline. ``stats()`` rides the replica's stats RPC."""

    def __init__(self, delay_s: float = 0.02, compile_s: float = 0.25):
        self._delay_s = float(delay_s)
        self._compile_s = float(compile_s)
        self._warmed = False
        self._cold_serves = 0
        self._lock = threading.Lock()

    def warmup(self, shapes):
        time.sleep(self._compile_s)
        with self._lock:
            self._warmed = True
        return {"warmed": len(shapes)}

    def call(self, request):
        with self._lock:
            cold = not self._warmed
            if cold:
                self._cold_serves += 1
                self._warmed = True
        if cold:
            time.sleep(self._compile_s)
        time.sleep(self._delay_s)
        return {"x": request.get("x", 0)}

    def stats(self):
        with self._lock:
            return {"cold_serves": self._cold_serves,
                    "warmed": self._warmed}


class WarmupBoom:
    """Replica backend whose warmup raises — the scale-up containment
    fixture (placement must discard, not leak, the started process)."""

    def call(self, request):
        return {"ok": True}

    def warmup(self, shapes):
        raise RuntimeError("warmup exploded")


class NpzBertDecode:
    """The port's tiny ``BertDecodeBackend`` on the CPU with weights
    carried in an ``.npz`` (``init_kwargs`` travel as JSON, so a
    parameter tree cannot): the file holds the JAX package's parameters
    under ``/``-joined paths. The decoder is built at fp32, as the
    cross-package stream tests build both packages', so greedy streams
    are comparable token for token. One intra-op thread: several
    replicas share the host."""

    def __init__(self, params_npz: str, **kw):
        import dataclasses

        import numpy as np
        import torch

        import tosem_tpu_torch.models.bert as tbert
        from tosem_tpu_torch.serve.backends import BertDecodeBackend
        torch.set_num_threads(1)
        tree: dict = {}
        with np.load(params_npz) as z:
            for key in z.files:
                node = tree
                *path, leaf = key.split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]

        @dataclasses.dataclass(frozen=True)
        class Config32(tbert.BertConfig):
            dtype: str = "float32"
        tbert.BertConfig = Config32
        self._b = BertDecodeBackend(params=tree, **kw)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._b, name)
