"""The chaos controller: turns plan triggers into injected actions.

Each fault keeps its own 1-based counter of *matching* events (same
site, same target filter), so ``Fault(site="tune.step", at=5,
target="t0001")`` means "the 5th step result of trial t0001" no matter
what other trials are doing. One event triggers at most one action
(first matching fault in plan order wins); every injection is appended
to :attr:`ChaosController.log` so a survival report — or an asserting
test — can check exactly what was injected and where.

The controller never calls back into the layer that fired the event
(injection sites run under framework locks); actions are either applied
by the call site from the returned action dict, or via the
process-level helper :func:`crash_actor_process` which only SIGKILLs.
The port's copy of ``tosem_tpu/chaos/injector.py``.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.chaos import hooks
from tosem_tpu_torch.chaos.plan import Fault, FaultPlan


class ChaosController:
    """Deterministic fault injector for one chaos run.

    Usable as a context manager: ``with ChaosController(plan):`` installs
    it process-wide on entry and uninstalls on exit (re-raising nothing —
    chaos must never mask the workload's own outcome).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        # per-fault counters of matching events (index-aligned with
        # plan.faults); independent counters make target-filtered
        # triggers local to their target's event stream
        self._counts: List[int] = [0] * len(plan.faults)
        self._seq = 0
        self.log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- decide

    def on(self, site: str, target: Optional[str] = None,
           **ctx: Any) -> Optional[Dict[str, Any]]:
        """One event at ``site``; returns the action to apply or None."""
        with self._lock:
            self._seq += 1
            chosen: Optional[Fault] = None
            for i, f in enumerate(self.plan.faults):
                if f.site != site:
                    continue
                if f.target is not None and f.target != target:
                    continue
                self._counts[i] += 1
                if chosen is None and self._counts[i] in f.window():
                    chosen = f
            if chosen is None:
                return None
            action = {"action": chosen.action, "delay_s": chosen.delay_s,
                      "fault": chosen}
            self.log.append({"seq": self._seq, "site": site,
                             "target": target, "action": chosen.action,
                             **{k: v for k, v in ctx.items()
                                if isinstance(v, (str, int, float, bool))}})
            return action

    def injections(self, site: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.log
                    if site is None or e["site"] == site]

    # ------------------------------------------------------------ install

    def __enter__(self) -> "ChaosController":
        hooks.install(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        if hooks.get_controller() is self:
            hooks.uninstall()


def crash_actor_process(actor_id: bytes) -> bool:
    """SIGKILL the process currently hosting ``actor_id`` (a *crash*,
    not a ``kill_actor``: the runtime's ``max_restarts`` policy applies,
    so a restartable actor comes back with its init replayed). Returns
    False when there is no live runtime or actor — chaos on a dead
    target is a no-op, never an error."""
    from tosem_tpu_torch.runtime import api
    rt = api._runtime
    if rt is None:
        return False
    with rt.lock:
        rec = rt.actors.get(actor_id)
        if rec is None or rec.dead:
            return False
        rec.worker.kill()
    return True
