"""Cache keys and the build-once cache of a backend's step callables.

Counterpart of ``tosem_tpu/serve/compile_cache.py``. The JAX package
keeps one :class:`CompileCache` a process, of AOT-compiled XLA
executables keyed by ``(model, bucket shape, dtype)``. The port runs
eagerly, so a build costs nothing yet, and what it keeps under the same
keys are the step closures one backend builds (prefill, decode step,
suffix feed). Each backend owns its cache: a closure holds its
backend's model, so two backends never share one, and a dropped backend
frees its model.

The class is the JAX package's, JIT aside:

- **Per-key build locks.** Two threads racing for one key build once;
  the loser waits on the winner's build.
- **Pinned-ledger LRU.** Under a ``budget`` of entries, an insert that
  goes over it evicts whole models, coldest first, and skips pinned
  ones and the inserting one: a fully pinned cache stays over budget
  rather than evict under a serving replica. A backend's own cache holds
  one model (its variants share one eviction group, see
  :func:`_model_of`), so it is built unbounded and never evicts; the
  budget and pins are for a cache that several models share, the
  replica-side mirror of ``control.multiplex.ModelLedger``.
- **Observable.** Hits, misses, build seconds and evictions surface
  through :meth:`CompileCache.stats` and the backend's ``stats()``.
"""
from __future__ import annotations

import threading
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)


def _model_of(key: Hashable) -> Hashable:
    """The model component of a cache key: :func:`shape_key` tuples
    lead with the model tag; scalar keys ARE the model. Program-variant
    suffixes the backends append after the tag's closing paren
    (``…);step``, ``…);mask=<sig>``, see ``model_tag``) are stripped, so
    every variant of one model forms ONE eviction group."""
    if isinstance(key, tuple) and key:
        key = key[0]
    if isinstance(key, str) and ");" in key:
        return key.split(");", 1)[0] + ")"
    return key


class CompileCache:
    """Thread-safe build-once cache.

    ``budget``: maximum cached entries before LRU model eviction kicks
    in (None = unbounded)."""

    def __init__(self, budget: Optional[int] = None):
        if budget is not None and budget < 1:
            raise ValueError("budget must be >= 1 (or None)")
        self.budget = budget
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Any] = {}
        self._building: Dict[Hashable, threading.Lock] = {}
        # model -> monotonically increasing last-use stamp (LRU order)
        self._model_used: Dict[Hashable, int] = {}
        self._use_clock = 0
        # model -> pin owners (serving replicas holding traffic)
        self._pins: Dict[Hashable, set] = {}
        self._hits = 0
        self._misses = 0
        self._build_s = 0.0
        self._evicted_entries = 0
        self._evicted_models = 0

    def _touch_locked(self, key: Hashable) -> None:
        self._use_clock += 1
        self._model_used[_model_of(key)] = self._use_clock

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """The value under ``key``, built (once, even under concurrency)
        on its first request."""
        with self._lock:
            if key in self._entries:
                self._hits += 1
                self._touch_locked(key)
                return self._entries[key]
            gate = self._building.setdefault(key, threading.Lock())
        with gate:
            # the winner of the race filled the entry while we waited
            with self._lock:
                if key in self._entries:
                    self._hits += 1
                    self._touch_locked(key)
                    return self._entries[key]
            t0 = time.perf_counter()
            value = build()
            dt = time.perf_counter() - t0
            with self._lock:
                self._entries[key] = value
                self._misses += 1
                self._build_s += dt
                self._touch_locked(key)
                self._building.pop(key, None)
                self._evict_over_budget_locked(protect=_model_of(key))
            return value

    # -- pinned-ledger model eviction ----------------------------------

    def pin(self, model: Hashable, owner: str = "replica") -> None:
        """``model`` is serving traffic for ``owner``: its entries are
        not eviction victims until every owner unpins."""
        with self._lock:
            self._pins.setdefault(model, set()).add(owner)

    def unpin(self, model: Hashable, owner: str = "replica") -> None:
        with self._lock:
            owners = self._pins.get(model)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    del self._pins[model]

    def pinned_models(self) -> List[Hashable]:
        with self._lock:
            return sorted(self._pins, key=repr)

    def _evict_model_locked(self, model: Hashable) -> int:
        victims = [k for k in self._entries if _model_of(k) == model]
        for k in victims:
            del self._entries[k]
        self._model_used.pop(model, None)
        if victims:
            self._evicted_entries += len(victims)
            self._evicted_models += 1
        return len(victims)

    def _evict_over_budget_locked(self,
                                  protect: Optional[Hashable] = None
                                  ) -> None:
        if self.budget is None:
            return
        while len(self._entries) > self.budget:
            cold = [m for m, _ in sorted(self._model_used.items(),
                                         key=lambda kv: kv[1])
                    if m != protect and not self._pins.get(m)]
            if not cold:
                return      # all pinned or the inserting model itself
            self._evict_model_locked(cold[0])

    def evict_model(self, model: Hashable) -> int:
        """Drop every entry of ``model`` (refused while pinned). Returns
        the entry count evicted."""
        with self._lock:
            if self._pins.get(model):
                return 0
            return self._evict_model_locked(model)

    # -- queries -------------------------------------------------------

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries), "hits": self._hits,
                    "misses": self._misses,
                    "build_s": round(self._build_s, 3),
                    "pinned_models": len(self._pins),
                    "evicted_entries": self._evicted_entries,
                    "evicted_models": self._evicted_models}


def shape_key(model: str, shape: Sequence[int], dtype: str) -> Tuple:
    """Canonical cache key: ``(model, (dims…), dtype)`` — the
    (model, bucket shape, dtype) triple of the design."""
    return (model, tuple(int(d) for d in shape), str(dtype))
