"""Chaos seam: the injection point between the framework and a fault
controller. ``FaultPlan``/``ChaosController`` are not ported yet; a test
installs any object with ``on(site, **ctx)``."""
from tosem_tpu_torch.chaos.hooks import fire, get_controller, install, uninstall

__all__ = ["fire", "get_controller", "install", "uninstall"]
