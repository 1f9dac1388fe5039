"""Multi-model multiplexing: resident-executable ledger + placement scoring.

"Millions of users" is never one model: many deployments pack onto the
same nodes, and two resources decide whether a placement is cheap or a
multi-second stall — the node's *compile cache* (has this model's
executable been built there before?) and its *KV/session affinity*
(does the consistent-hash ring already send this deployment's keys
there?). This module tracks the first and scores both:

- :class:`ModelLedger` — the pinned-ledger pattern from
  :mod:`tosem_tpu_torch.runtime.object_store`, applied to model executables:
  every node has an LRU ledger of resident (warmed) models with a
  memory budget; serving replicas PIN their model while placed, and
  eviction under pressure walks cold-first and SKIPS pinned entries —
  a model can never be evicted out from under a live replica, and a
  cold model's executable makes room for a hot one's.
- :class:`PlacementScorer` — node choice for one replica: free
  capacity, a warm-compile-cache bonus (the ledger), a co-residency
  bonus (the deployment already has replicas there: the router's hash
  ring concentrates its keys on that node), and a pressure penalty
  when placing would force evictions.

Both are pure control-plane state (deterministic, injectable-clock
testable); :class:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe` feeds
the ledger from its warmup path and consults the scorer on every
single-replica placement (scale-up, failover re-placement).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set


class ModelLedger:
    """Per-node LRU ledger of resident model executables with pins.

    ``cost`` is the model's footprint in budget units (defaults to 1 —
    executable counts); ``budget_per_node`` bounds the sum of resident
    costs. All mutators return/record deterministically so the ledger
    is exact in tests and honest in ``/-/stats``."""

    def __init__(self, budget_per_node: float = 8.0):
        if budget_per_node <= 0:
            raise ValueError("budget_per_node must be > 0")
        self.budget_per_node = budget_per_node
        self._lock = threading.Lock()
        # node -> model -> cost, in LRU order (dict preserves insertion;
        # a touch re-inserts at the tail = most recent)
        self._resident: Dict[str, Dict[str, float]] = {}
        # (node, model) -> set of pinning owners (replica ids)
        self._pins: Dict[tuple, Set[str]] = {}
        self._evictions = 0

    # -- residency -----------------------------------------------------

    def record_warm(self, node: str, model: str, cost: float = 1.0,
                    ) -> List[str]:
        """A model's executable became resident on ``node`` (the warmup
        path ran there). Returns the models evicted to fit it under the
        node's budget (cold-first, pinned skipped)."""
        with self._lock:
            models = self._resident.setdefault(node, {})
            models.pop(model, None)
            models[model] = float(cost)          # tail = most recent
            return self._evict_over_budget_locked(node, protect=model)

    def touch(self, node: str, model: str) -> None:
        """LRU touch: the model served a request on ``node``."""
        with self._lock:
            models = self._resident.get(node, {})
            if model in models:
                models[model] = models.pop(model)

    def pin(self, node: str, model: str, owner: str) -> None:
        """A serving replica (``owner``) depends on the model staying
        resident on ``node`` — eviction must skip it."""
        with self._lock:
            self._pins.setdefault((node, model), set()).add(owner)

    def unpin(self, node: str, model: str, owner: str) -> None:
        with self._lock:
            owners = self._pins.get((node, model))
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    del self._pins[(node, model)]

    def drop_node(self, node: str) -> None:
        """The node left the pool: its residency AND its pins go with
        it (a dead node's ledger row is exactly the stale-gauge bug —
        remove the series, don't zero it)."""
        with self._lock:
            self._resident.pop(node, None)
            for key in [k for k in self._pins if k[0] == node]:
                del self._pins[key]

    # -- eviction ------------------------------------------------------

    def _pinned_locked(self, node: str, model: str) -> bool:
        return bool(self._pins.get((node, model)))

    def _evict_over_budget_locked(self, node: str,
                                  protect: Optional[str] = None
                                  ) -> List[str]:
        models = self._resident.get(node, {})
        evicted: List[str] = []
        while sum(models.values()) > self.budget_per_node:
            victim = next(
                (m for m in models         # insertion order = LRU order
                 if m != protect and not self._pinned_locked(node, m)),
                None)
            if victim is None:
                break                      # everything left is pinned
            del models[victim]
            evicted.append(victim)
            self._evictions += 1
        return evicted

    def evict_under_pressure(self, node: str, need: float) -> List[str]:
        """Free at least ``need`` budget units on ``node`` by evicting
        cold models LRU-first; pinned models are never victims. Returns
        the evicted model names (may be short when pins block)."""
        with self._lock:
            models = self._resident.get(node, {})
            evicted: List[str] = []
            freed = 0.0
            for m in list(models):
                if freed >= need:
                    break
                if self._pinned_locked(node, m):
                    continue
                freed += models.pop(m)
                evicted.append(m)
                self._evictions += 1
            return evicted

    # -- queries -------------------------------------------------------

    def resident(self, node: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._resident.get(node, {}))

    def is_warm(self, node: str, model: str) -> bool:
        with self._lock:
            return model in self._resident.get(node, {})

    def used(self, node: str) -> float:
        with self._lock:
            return sum(self._resident.get(node, {}).values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_per_node": self.budget_per_node,
                "evictions": self._evictions,
                "nodes": {
                    n: {"resident": list(m),
                        "used": sum(m.values()),
                        "pinned": sorted(
                            model for (node, model) in self._pins
                            if node == n)}
                    for n, m in self._resident.items()},
            }


class PlacementScorer:
    """Affinity-aware node choice for ONE replica placement.

    ``score`` is higher-is-better over: free capacity (load spreading,
    the pre-scorer behavior preserved as the base term), a warm-
    compile-cache bonus when the ledger says the model is resident, a
    co-residency bonus when the deployment already has replicas there
    (KV/session keys hash to that node), and a pressure penalty when
    the node's ledger would have to evict to take another model."""

    def __init__(self, ledger: ModelLedger,
                 warm_bonus: float = 2.0, residency_bonus: float = 1.0,
                 pressure_penalty: float = 1.5):
        self.ledger = ledger
        self.warm_bonus = warm_bonus
        self.residency_bonus = residency_bonus
        self.pressure_penalty = pressure_penalty

    def score(self, node: str, model: str, free_capacity: int,
              co_resident_replicas: int = 0, cost: float = 1.0) -> float:
        s = float(free_capacity)
        warm = self.ledger.is_warm(node, model)
        if warm:
            s += self.warm_bonus
        if co_resident_replicas > 0:
            s += self.residency_bonus
        elif (not warm and self.ledger.used(node) + cost
                > self.ledger.budget_per_node):
            # placing a NEW model here forces an eviction; re-warming a
            # RESIDENT one evicts nothing, so warm nodes skip the
            # penalty however full their ledger is
            s -= self.pressure_penalty
        return s

    def pick(self, capacities: Dict[str, int], model: str,
             co_resident: Optional[Dict[str, int]] = None,
             cost: float = 1.0) -> Optional[str]:
        """Best node with capacity, deterministic tiebreak by name."""
        co = co_resident or {}
        candidates = [n for n, c in capacities.items() if c > 0]
        if not candidates:
            return None
        return max(sorted(candidates),
                   key=lambda n: self.score(n, model, capacities[n],
                                            co.get(n, 0), cost))
