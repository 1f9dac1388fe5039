"""Traffic-scale control plane (L7): the closed loop over the cluster.

The reference pairs a serve controller that scales replica counts from
queue metrics (``python/ray/serve/autoscaling_policy.py``) with a
cluster autoscaler that converts backlog into node launches
(``python/ray/autoscaler/``). This package is that composition for OUR
substrate, closing the loop from the per-node queue-depth rollup
:class:`~tosem_tpu_torch.serve.cluster_serve.ClusterServe` exports to
placement actions:

- :mod:`tosem_tpu_torch.control.policy` — ONE deterministic scaling policy
  core (target-backlog, idle-tick hysteresis, bounded step-up) behind
  both of the previously-duplicated autoscalers
  (:mod:`tosem_tpu_torch.serve.autoscale`,
  :mod:`tosem_tpu_torch.cluster.autoscaler` are thin aliases now) and the cluster controller.
- :mod:`tosem_tpu_torch.control.admission` — SLO-aware admission: per-
  deployment latency budgets, an estimated-wait check that rejects with
  a typed :class:`Overloaded` (``retry_after``) instead of queueing
  into a breaker trip, and priority classes (decode preempts bulk
  encode) with aging so equal-priority arrival order is preserved and
  nothing starves.
- :mod:`tosem_tpu_torch.control.multiplex` — multi-model multiplexing: a
  pinned-ledger LRU of resident model executables per node (serving
  replicas pin; eviction under pressure skips pinned — the
  object-store pattern applied to executables) plus compile-cache- and
  KV-affinity-aware placement scoring.
- :mod:`tosem_tpu_torch.control.plane` — :class:`ControlPlane`, the closed
  loop itself: per-deployment replica counts AND the router tier follow
  demand; scale-up warms compile caches before a replica takes traffic,
  scale-down drains through live KV migration.
"""
from tosem_tpu_torch.control.admission import (AdmissionController, Overloaded,
                                         PriorityGate, SLOConfig)
from tosem_tpu_torch.control.multiplex import ModelLedger, PlacementScorer
from tosem_tpu_torch.control.plane import ControlPlane
from tosem_tpu_torch.control.policy import PolicyCore, ScalePolicy, ScalerLoop

__all__ = [
    "ScalePolicy", "PolicyCore", "ScalerLoop",
    "SLOConfig", "AdmissionController", "PriorityGate", "Overloaded",
    "ModelLedger", "PlacementScorer",
    "ControlPlane",
]
