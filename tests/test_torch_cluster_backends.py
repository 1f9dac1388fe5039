"""Backends the port's cluster tests deploy by ``"module:qualname"``.

Kept apart from the test files because each replica is a fresh
interpreter that imports its backend by name: these import neither JAX
nor the JAX package (the reference's ``_WarmupBoom`` lives in a test
module that imports JAX; ``ControlLoadBackend`` is the port's
``serve/bench_cluster.py``'s). No tests here.
"""
from __future__ import annotations


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
