"""Demand-based autoscaler for the runtime worker pool.

The reference's autoscaler (`python/ray/autoscaler/` — monitor reads
load metrics from the GCS, `resource_demand_scheduler` converts backlog
into node launches, idle nodes terminate after a timeout). Single-host
translation: the "nodes" are runtime worker processes, demand is the
scheduler's pending+inflight backlog from ``rt.stats()``, and scaling
calls ``rt.add_worker()`` / ``rt.remove_idle_worker()``. The scaling
*law* (backlog threshold, launch-ahead step-up, idle-tick hysteresis)
is the shared :class:`tosem_tpu_torch.control.policy.PolicyCore` in
``backlog`` mode — this module is the worker-pool adapter over it, with
semantics unchanged from the pre-dedup implementation. Deterministic
``tick()`` (no background thread by default) keeps tests exact; a
``run()`` loop provides the monitor-daemon behavior. A copy of the JAX
package's module over the port's runtime.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tosem_tpu_torch.control.policy import PolicyCore, ScalePolicy, ScalerLoop


@dataclass
class AutoscalerConfig:
    min_workers: int = 1
    max_workers: int = 8
    # scale up when backlog exceeds this many tasks per current worker
    backlog_per_worker: float = 2.0
    # consecutive idle ticks before a down-scale
    idle_ticks_before_downscale: int = 3
    max_scale_up_per_tick: int = 2

    def to_policy(self) -> ScalePolicy:
        """The shared-core translation (backlog mode: launch-ahead
        step-up, down-scale only on a completely idle backlog)."""
        return ScalePolicy(
            min_units=self.min_workers, max_units=self.max_workers,
            target_per_unit=self.backlog_per_worker,
            idle_ticks_before_downscale=self.idle_ticks_before_downscale,
            max_up_per_tick=self.max_scale_up_per_tick, mode="backlog")


class Autoscaler(ScalerLoop):
    thread_name = "tosem-autoscaler"

    def __init__(self, config: Optional[AutoscalerConfig] = None, *,
                 stats_fn: Optional[Callable[[], Dict[str, int]]] = None,
                 add_fn: Optional[Callable[[], int]] = None,
                 remove_fn: Optional[Callable[[], bool]] = None):
        import tosem_tpu_torch.runtime as rt
        super().__init__()
        self.cfg = config if config is not None else AutoscalerConfig()
        self._core = PolicyCore(self.cfg.to_policy())
        self._stats = stats_fn or rt.stats
        self._add = add_fn or rt.add_worker
        self._remove = remove_fn or rt.remove_idle_worker
        self.history: List[Dict[str, int]] = []

    def _on_tick_error(self, e: BaseException) -> None:
        pass  # a dead runtime must not crash (or spam) the monitor

    def tick(self) -> Dict[str, int]:
        """One monitor round: read demand, scale, record the decision.
        The policy is rebuilt when ``self.cfg`` changed — the pre-dedup
        tick read the config fields live every round."""
        policy = self.cfg.to_policy()
        if self._core.policy != policy:
            self._core = PolicyCore(policy)
        s = self._stats()
        workers = s["num_workers"]
        # dispatchable demand only — dep-blocked/actor-bound pending work
        # can't drain onto added task workers (falls back to raw pending
        # for stats sources that don't report readiness)
        backlog = s.get("pending_ready", s["pending"]) + s["inflight"]
        want = self._core.decide(workers, backlog)
        added = removed = 0
        if want > workers:
            for _ in range(want - workers):
                self._add()
                added += 1
        elif want < workers:
            if self._remove():
                removed = 1
        decision = {**s, "added": added, "removed": removed}
        self.history.append(decision)
        return decision
