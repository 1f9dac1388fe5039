"""The shared autoscaling policy core.

Before this module existed the repo had the same scaling law written
twice: :class:`~tosem_tpu_torch.serve.autoscale.ServeAutoscaler` (replica
counts from in-flight demand, the ``autoscaling_policy.py`` shape) and
:class:`~tosem_tpu_torch.cluster.autoscaler.Autoscaler` (worker counts from
scheduler backlog, the ``resource_demand_scheduler`` shape) — target
backlog per unit, consecutive-idle-tick hysteresis before a one-step
shrink, bounded step-up per tick. :class:`PolicyCore` is the single
copy of that law; both autoscalers and the cluster
:class:`~tosem_tpu_torch.control.plane.ControlPlane` drive it.

Two down-scale modes cover the historical semantics exactly:

- ``mode="proportional"`` (the Serve policy): desired =
  clamp(ceil(demand / target)); any sustained demand BELOW the current
  size shrinks toward desired — a trickle of traffic still scales down.
- ``mode="backlog"`` (the cluster policy): scale-up triggers when
  backlog exceeds ``target_per_unit × units`` and adds the full
  ``max_up_per_tick`` (launch-ahead, the node-launcher behavior);
  down-scale only on a COMPLETELY idle backlog — partial backlog
  resets the idle counter.

``decide()`` is pure state-machine (no clock, no threads), so policy
tests are exact; :class:`ScalerLoop` is the shared background-thread
shell the concrete autoscalers inherit.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional


@dataclass
class ScalePolicy:
    """Knobs of the shared scaling law (one vocabulary for replicas,
    workers, routers, and nodes — 'units')."""

    min_units: int = 1
    max_units: int = 8
    target_per_unit: float = 2.0
    idle_ticks_before_downscale: int = 3
    max_up_per_tick: int = 2
    mode: str = "proportional"          # or "backlog"

    def __post_init__(self) -> None:
        if self.mode not in ("proportional", "backlog"):
            raise ValueError(f"unknown scaling mode {self.mode!r}; "
                             "choose 'proportional' or 'backlog'")
        if self.min_units < 0 or self.max_units < self.min_units:
            raise ValueError("need 0 <= min_units <= max_units")
        if self.target_per_unit <= 0:
            raise ValueError("target_per_unit must be > 0")
        if self.idle_ticks_before_downscale < 1 or self.max_up_per_tick < 1:
            raise ValueError("idle_ticks_before_downscale and "
                             "max_up_per_tick must be >= 1")


class PolicyCore:
    """Deterministic (current size, demand) → wanted size, with the
    idle-tick hysteresis held as the only state. One core per scaled
    thing (per deployment, per pool, per router tier)."""

    def __init__(self, policy: Optional[ScalePolicy] = None):
        self.policy = policy or ScalePolicy()
        self._idle = 0

    @property
    def idle_ticks(self) -> int:
        return self._idle

    def decide(self, current: int, demand: float) -> int:
        p = self.policy
        if p.mode == "backlog":
            if demand > p.target_per_unit * current:
                self._idle = 0
                # launch-ahead: full step-up toward max, like the node
                # launcher converting backlog into launches
                return max(current,
                           min(current + p.max_up_per_tick, p.max_units))
            if demand == 0 and current > p.min_units:
                self._idle += 1
                if self._idle >= p.idle_ticks_before_downscale:
                    self._idle = 0
                    return current - 1
                return current
            self._idle = 0
            return current
        # proportional: enough units for target_per_unit demand each
        desired = max(p.min_units,
                      min(p.max_units,
                          math.ceil(demand / p.target_per_unit)))
        if desired > current:
            self._idle = 0
            return min(current + p.max_up_per_tick, desired)
        if desired < current:
            # hysteresis: shrink one step only after demand stayed
            # below the current size for consecutive ticks
            self._idle += 1
            if self._idle >= p.idle_ticks_before_downscale:
                self._idle = 0
                return current - 1
            return current
        self._idle = 0
        return current


class ScalerLoop:
    """Background tick loop shared by every autoscaler: deterministic
    ``tick()`` for tests, ``run(interval)`` for the monitor-daemon
    behavior, ``stop()`` to join. Subclasses implement ``tick()`` and
    may override ``_on_tick_error`` (default: warn once per error type
    on stderr — silently-disabled autoscaling is invisible)."""

    thread_name = "scaler"

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned: set = set()

    def tick(self):                      # pragma: no cover - interface
        raise NotImplementedError

    def _on_tick_error(self, e: BaseException) -> None:
        import sys
        key = type(e).__name__
        if key not in self._warned:
            self._warned.add(key)
            print(f"[{self.thread_name}] tick failed: {e!r}",
                  file=sys.stderr)

    def run(self, interval: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception as e:
                    # keep the controller alive through teardown races
                    self._on_tick_error(e)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=self.thread_name)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
