"""The cluster control plane: demand in, placement actions out.

:class:`ControlPlane` closes the serving loop. The
cluster serving tier already *exports* demand — every router's cached
per-replica queue depths roll up through
:meth:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe.stats` — but nothing
*acted* on it: replica counts and the router tier were frozen at deploy
time. Each ``tick()``:

1. reads one ``stats()`` snapshot (the same rollup ``/-/stats`` serves),
2. folds it into per-deployment demand — per-replica depth is the MAX
   across routers (each router caches its own view of the same
   requests), admission queue lengths SUM (each router queues distinct
   requests),
3. drives one :class:`~tosem_tpu_torch.control.policy.PolicyCore` per
   deployment plus one for the router tier, and
4. applies the decisions through
   :meth:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe.scale` /
   :meth:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe.scale_routers` —
   which warm compile caches BEFORE a fresh replica enters the routing
   table and drain (live KV migration included) before a victim leaves.

Only replicas on LIVE nodes count toward current capacity: the
controller reads ``dep.replicas``, which the pool's death listener
prunes synchronously — a node dying mid-scale-up takes its warming
replica out of the count, so the next tick re-places instead of
believing in a corpse (the ``scale-under-kill`` chaos plan pins this).

Deterministic ``tick()`` for tests; ``run()`` (from
:class:`~tosem_tpu_torch.control.policy.ScalerLoop`) for the controller-loop
behavior.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, List, Optional

from tosem_tpu_torch.control.policy import PolicyCore, ScalePolicy, ScalerLoop


class ControlPlane(ScalerLoop):
    thread_name = "control-plane"

    def __init__(self, cs: Any,
                 deployments: Optional[Dict[str, ScalePolicy]] = None,
                 default: Optional[ScalePolicy] = None,
                 router_policy: Optional[ScalePolicy] = None):
        """``cs`` is the :class:`ClusterServe` controller. ``deployments``
        maps deployment names to per-deployment scale policies
        (``default`` covers the rest); ``router_policy`` (optional)
        additionally scales the router TIER from the summed node queue
        depth — ``None`` leaves the tier static."""
        super().__init__()
        self.cs = cs
        self.configs = dict(deployments or {})
        self.default = default or ScalePolicy()
        self.router_policy = router_policy
        self._lock = threading.Lock()
        self._cores: Dict[str, PolicyCore] = {}
        self._exported_demand: set = set()
        self._router_core = (PolicyCore(router_policy)
                             if router_policy is not None else None)
        self.history: Deque[Dict[str, Any]] = collections.deque(
            maxlen=1000)
        self._metrics = None

    def _core(self, name: str) -> PolicyCore:
        """Per-deployment core, rebuilt when the operator swapped the
        policy (a live config change must take effect on the next
        tick, like the pre-dedup per-tick config read; rebuilding
        resets the idle-tick hysteresis, which a changed policy
        invalidates anyway)."""
        policy = self.configs.get(name, self.default)
        with self._lock:
            core = self._cores.get(name)
            if core is None or core.policy != policy:
                core = self._cores[name] = PolicyCore(policy)
            return core

    def _metrics_dict(self):
        if self._metrics is None:
            from tosem_tpu_torch.obs.metrics import control_plane_metrics
            self._metrics = control_plane_metrics()
        return self._metrics

    @staticmethod
    def demand_from_stats(st: Dict[str, Any]) -> Dict[str, float]:
        """Per-deployment demand out of one ``ClusterServe.stats()``
        snapshot: Σ over replicas of (max across routers of that
        replica's cached depth) + Σ over routers of the deployment's
        admission queue length."""
        depth: Dict[str, Dict[str, int]] = {}
        waiting: Dict[str, int] = {}
        for rs in st.get("routers", ()):
            for rid, info in rs.get("replicas", {}).items():
                dep = info.get("deployment", "?")
                cur = depth.setdefault(dep, {})
                cur[rid] = max(cur.get(rid, 0), int(info.get("depth", 0)))
            for dep, adm in rs.get("admission", {}).items():
                waiting[dep] = waiting.get(dep, 0) + int(
                    adm.get("waiting", 0))
        out: Dict[str, float] = {}
        for dep in set(depth) | set(waiting):
            out[dep] = (sum(depth.get(dep, {}).values())
                        + waiting.get(dep, 0))
        return out

    def tick(self) -> List[Dict[str, Any]]:
        st = self.cs.stats()
        demand = self.demand_from_stats(st)
        m = self._metrics_dict()
        decisions: List[Dict[str, Any]] = []
        names = self.cs.list_deployments()
        # departed-label discipline: a deleted deployment's demand
        # series is REMOVED, not left at its last value
        for gone in self._exported_demand - set(names):
            m["demand"].remove((gone,))
            with self._lock:
                self._cores.pop(gone, None)
        self._exported_demand = set(names)
        for name in names:
            dep = self.cs.get_deployment(name)
            if dep is None:
                continue
            current = len(dep.replicas)
            d = float(demand.get(name, 0.0))
            # the serving actuators floor at one replica/router (scale
            # to zero is delete, an operator decision) — clamp a
            # min_units=0 policy rather than erroring every tick
            want = max(1, self._core(name).decide(current, d))
            m["demand"].set(d, (name,))
            applied = current
            if want != current:
                try:
                    self.cs.scale(name, want)
                except Exception as e:
                    # placement can fail mid-decision (a node died, no
                    # capacity): record it, keep the loop alive — the
                    # next tick sees the pruned replica list and retries
                    decisions.append({"deployment": name, "demand": d,
                                      "replicas": current,
                                      "new_replicas": current,
                                      "error": repr(e)})
                    self.history.append(decisions[-1])
                    continue
                # count what HAPPENED, not what was wanted: a scale-up
                # against exhausted capacity places nothing and must
                # not emit a phantom event every tick
                applied = len(dep.replicas)
                if applied != current:
                    m["scale_events"].inc(1.0, (
                        "deployment", name,
                        "up" if applied > current else "down"))
            rec = {"deployment": name, "demand": d, "replicas": current,
                   "new_replicas": applied}
            if applied != want:
                rec["wanted"] = want
            decisions.append(rec)
            self.history.append(rec)
        if self._router_core is not None:
            total = float(sum(n.get("queue_depth", 0)
                              for n in st.get("nodes", {}).values()))
            routers = len(st.get("routers", ()))
            want = max(1, self._router_core.decide(routers, total))
            applied = routers
            if want != routers:
                # same containment + count-what-happened discipline as
                # the deployment axis: a failed router spawn must not
                # abort the tick, and a no-op (closed controller) must
                # not emit a phantom scale event
                try:
                    applied = int(self.cs.scale_routers(want))
                except Exception as e:
                    rec = {"deployment": "<routers>", "demand": total,
                           "replicas": routers, "new_replicas": routers,
                           "error": repr(e)}
                    decisions.append(rec)
                    self.history.append(rec)
                    return decisions
                if applied != routers:
                    m["scale_events"].inc(1.0, (
                        "router", "router-tier",
                        "up" if applied > routers else "down"))
            rec = {"deployment": "<routers>", "demand": total,
                   "replicas": routers, "new_replicas": applied}
            if applied != want:
                rec["wanted"] = want
            decisions.append(rec)
            self.history.append(rec)
        return decisions
