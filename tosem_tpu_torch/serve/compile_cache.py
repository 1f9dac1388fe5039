"""Cache keys and a backend's own table of built step callables.

Counterpart of ``tosem_tpu/serve/compile_cache.py``. The JAX package
caches AOT-compiled XLA executables per ``(model, bucket shape, dtype)``
in one cache per process, with a budget, pins and model eviction for
multiplexing. The port runs eagerly, so a build costs nothing yet, and
what it keeps under the same keys are the step closures one backend
builds (prefill, decode step, suffix feed). Each backend owns its
:class:`StepCache`: a closure holds its backend's model, so two backends
never share one, and a dropped backend frees its model. The budget, pins
and eviction return with the multiplexing control plane; CUDA graphs of
the steps are later work.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Sequence, Tuple


def shape_key(model: str, shape: Sequence[int], dtype: str) -> Tuple:
    """Canonical cache key: ``(model, (dims…), dtype)`` — the
    (model, bucket shape, dtype) triple of the design."""
    return (model, tuple(int(d) for d in shape), str(dtype))


class StepCache:
    """One backend's built step callables, keyed by :func:`shape_key`."""

    def __init__(self):
        self._entries: Dict[Hashable, Any] = {}
        self._hits = 0
        self._misses = 0

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """The callable under ``key``, built on its first request."""
        if key in self._entries:
            self._hits += 1
        else:
            self._misses += 1
            self._entries[key] = build()
        return self._entries[key]

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self._hits,
                "misses": self._misses}
