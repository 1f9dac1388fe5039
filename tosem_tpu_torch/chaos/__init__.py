"""Deterministic chaos layer: seeded fault injection for the runtime,
serve, tune, cluster and training layers.

The port's copy of ``tosem_tpu/chaos``. The TOSEM-2021 study found
failure-handling paths chronically under-tested in distributed ML stacks
(Ray, NNI, DeepSpeech); this package turns them into tested surface: a
:class:`FaultPlan` is a seed plus a schedule of typed faults, a
:class:`ChaosController` installed via :func:`install` makes the
framework's injection sites fire them, and every decision is a pure
function of ``(seed, plan, event counts)`` — so a chaos run replays
exactly and chaos tests are ordinary deterministic pytest cases.

    from tosem_tpu_torch.chaos import FaultPlan, Fault, ChaosController

    plan = FaultPlan(seed=7, faults=[
        Fault(site="serve.dispatch", action="crash_replica", at=1)])
    with ChaosController(plan) as chaos:
        ...  # run the workload; chaos.log records every injection

Canned plans live in :data:`CANNED_PLANS`; each pairs with a workload of
the same name in :mod:`tosem_tpu_torch.chaos.runner`, and ``python -m
tosem_tpu_torch.cli chaos --plan <name> [--device=cpu]``
(:mod:`tosem_tpu_torch.chaos.cli`) runs one and prints a survival
report.
"""
from tosem_tpu_torch.chaos.hooks import fire, get_controller, install, uninstall
from tosem_tpu_torch.chaos.injector import ChaosController
from tosem_tpu_torch.chaos.plan import CANNED_PLANS, Fault, FaultPlan

__all__ = [
    "Fault", "FaultPlan", "CANNED_PLANS", "ChaosController",
    "install", "uninstall", "get_controller", "fire",
]
