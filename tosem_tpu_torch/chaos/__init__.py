"""Deterministic chaos layer: seeded fault injection for the runtime,
serve and training layers.

The port's copy of ``tosem_tpu/chaos``: a :class:`FaultPlan` is a seed
plus a schedule of typed faults, a :class:`ChaosController` installed
via :func:`install` makes the framework's injection sites fire them, and
every decision is a pure function of ``(seed, plan, event counts)`` — so
a chaos run replays exactly and chaos tests are ordinary deterministic
pytest cases.

    from tosem_tpu_torch.chaos import FaultPlan, Fault, ChaosController

    plan = FaultPlan(seed=7, faults=[
        Fault(site="serve.dispatch", action="crash_replica", at=1)])
    with ChaosController(plan) as chaos:
        ...  # run the workload; chaos.log records every injection

The survival runner and its ``chaos`` CLI wait for ROADMAP.md A14.
"""
from tosem_tpu_torch.chaos.hooks import fire, get_controller, install, uninstall
from tosem_tpu_torch.chaos.injector import ChaosController
from tosem_tpu_torch.chaos.plan import CANNED_PLANS, Fault, FaultPlan

__all__ = [
    "Fault", "FaultPlan", "CANNED_PLANS", "ChaosController",
    "install", "uninstall", "get_controller", "fire",
]
