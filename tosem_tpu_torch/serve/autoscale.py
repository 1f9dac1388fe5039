"""Deployment autoscaling (the Ray Serve autoscaler role).

Serve's controller scales replica counts from queue-length metrics
(`python/ray/serve/autoscaling_policy.py` — target in-flight requests
per replica with upper/lower bounds). Same policy here over
:meth:`Deployment.load` — since the control-plane PR the policy *law*
itself (target backlog, idle-tick hysteresis, bounded step-up) lives
once in :class:`tosem_tpu_torch.control.policy.PolicyCore`; this module is
the thin Serve adapter over it. Deterministic ``tick()`` for tests;
``run()`` for the controller-loop behavior — both unchanged in
semantics from the pre-dedup implementation.

With micro-batching enabled, ``load()`` counts LOGICAL requests —
queued-in-the-batch-queue plus in-flight, a 16-request batch weighing
16 — so the demand signal tracks users, never dispatches: a deployment
absorbing its whole queue into one batch per flush still scales on the
depth of that queue.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Deque, Dict, Optional

from tosem_tpu_torch.control.policy import PolicyCore, ScalePolicy, ScalerLoop
from tosem_tpu_torch.serve.core import Serve


@dataclass
class ServeScaleConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    target_inflight_per_replica: float = 2.0
    idle_ticks_before_downscale: int = 3
    max_up_per_tick: int = 2

    def to_policy(self) -> ScalePolicy:
        """The shared-core translation (proportional mode: trickle
        traffic below target still scales down toward desired)."""
        return ScalePolicy(
            min_units=self.min_replicas, max_units=self.max_replicas,
            target_per_unit=self.target_inflight_per_replica,
            idle_ticks_before_downscale=self.idle_ticks_before_downscale,
            max_up_per_tick=self.max_up_per_tick, mode="proportional")


class ServeAutoscaler(ScalerLoop):
    thread_name = "serve-autoscaler"

    def __init__(self, serve: Serve,
                 configs: Optional[Dict[str, ServeScaleConfig]] = None,
                 default: Optional[ServeScaleConfig] = None):
        super().__init__()
        self.serve = serve
        self.configs = dict(configs or {})
        self.default = default or ServeScaleConfig()
        self._cores: Dict[str, PolicyCore] = {}
        self.history: Deque[Dict[str, int]] = collections.deque(
            maxlen=1000)                    # bounded: run() is long-lived

    def _cfg(self, name: str) -> ServeScaleConfig:
        return self.configs.get(name, self.default)

    def _core(self, name: str) -> PolicyCore:
        """Rebuilt when the deployment's config changed — the pre-dedup
        tick() re-read configs every round, so a live edit of
        ``self.configs`` must keep taking effect (rebuilding resets the
        idle-tick hysteresis, which a changed policy invalidates)."""
        policy = self._cfg(name).to_policy()
        core = self._cores.get(name)
        if core is None or core.policy != policy:
            core = self._cores[name] = PolicyCore(policy)
        return core

    def tick(self) -> list:
        decisions = []
        for name, dep in self.serve.deployments().items():
            load = dep.load()
            n = dep.num_replicas
            want = self._core(name).decide(n, load)
            if want != n:
                dep.scale(want)
            d = {"deployment": name, "load": load, "replicas": n,
                 "new_replicas": want}
            decisions.append(d)
            self.history.append(d)
        return decisions
