"""Observability: metric registry, Prometheus export, memory monitor.

The port's copy of the part of ``tosem_tpu/obs`` that the runtime and the
serving control plane import: the metric registry and its exporter
(:mod:`~tosem_tpu_torch.obs.metrics`), the shared HTTP scaffold
(:mod:`~tosem_tpu_torch.obs.httpd`) and the memory watchdog
(:mod:`~tosem_tpu_torch.obs.memory_monitor`). The dashboard, log monitor,
sysmo and drive view wait for ROADMAP.md A14.
"""
from tosem_tpu_torch.obs import metrics
from tosem_tpu_torch.obs.memory_monitor import MemoryMonitor
from tosem_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                         MetricsServer, Registry, counter,
                                         gauge, histogram, prometheus_text)

__all__ = [
    "metrics", "Counter", "Gauge", "Histogram", "Registry", "MetricsServer",
    "counter", "gauge", "histogram", "prometheus_text", "MemoryMonitor",
]
