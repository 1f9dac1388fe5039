"""Injection seam between the framework and a chaos controller.

The port's own copy of ``tosem_tpu/chaos/hooks.py``. Import-light on
purpose: code on a hot path calls :func:`fire` at its injection site,
which costs one attribute load and a None check when no controller is
installed.

Sites and the actions they honor:

==================  =====================================  =============
site                fired                                   actions
==================  =====================================  =============
runtime.dispatch    task/actor-call written to a worker     kill_worker
runtime.result      "done" message drained from a worker    drop_result,
                                                            delay_result
runtime.store       large result sealed into the store      evict_object
serve.dispatch      request routed to a replica             crash_replica,
                                                            slow_replica
serve.decode_step   one decode scheduler iteration          evict_pages,
                                                            slow_step,
                                                            drain_replica,
                                                            crash_prefill
serve.route         request routed via a ClusterHandle      kill_router,
                                                            kill_node,
                                                            slow_node
tune.step           trial step result processed             crash_trial
cluster.submit      NodePool routes work to a node agent    kill_node
cluster.probe       failure-detector sweep reaches a node   partition,
                                                            heal,
                                                            slow_node
transport.send      tensor stream about to leave a sender   drop, delay,
                                                            dup_stream
train.step          trainer ``fit()`` finished one step     preempt
train.dist_step     a data-parallel step about to dispatch  kill_node,
                                                            slow_node
control.scale       scale-up placement target chosen        kill_node
==================  =====================================  =============

A controller is any object with ``on(site, **ctx)`` returning an action
dict (``{"action": "preempt"}``) or None; :class:`~tosem_tpu_torch.chaos.
injector.ChaosController` runs a seeded :class:`~tosem_tpu_torch.chaos.
plan.FaultPlan`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

_controller: Optional[Any] = None


def install(controller: Any) -> Any:
    """Install ``controller`` as the process-wide chaos controller.
    Returns it (convenience for ``chaos = install(MyController())``)."""
    global _controller
    _controller = controller
    return controller


def uninstall() -> None:
    global _controller
    _controller = None


def get_controller() -> Optional[Any]:
    return _controller


def fire(site: str, **ctx: Any) -> Optional[Dict[str, Any]]:
    """Report one event at ``site``; returns the action dict the
    installed controller wants applied there, or None (no chaos)."""
    c = _controller
    if c is None:
        return None
    return c.on(site, **ctx)
