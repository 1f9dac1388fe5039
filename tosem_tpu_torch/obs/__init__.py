"""Observability: metric registry, Prometheus export, memory/log monitors,
the dashboard, sysmo and the drive view.

The port's copy of ``tosem_tpu/obs``: the metric registry and its exporter
(:mod:`~tosem_tpu_torch.obs.metrics`), the shared HTTP scaffold
(:mod:`~tosem_tpu_torch.obs.httpd`), the memory watchdog
(:mod:`~tosem_tpu_torch.obs.memory_monitor`), the log tailer
(:mod:`~tosem_tpu_torch.obs.log_monitor`), the process health checker
(:mod:`~tosem_tpu_torch.obs.sysmo`), the dashboard
(:mod:`~tosem_tpu_torch.obs.dashboard`) and the drive view
(:mod:`~tosem_tpu_torch.obs.driveview`). None of them loads torch.
"""
from tosem_tpu_torch.obs import metrics
from tosem_tpu_torch.obs.dashboard import (DashboardServer, render_html,
                                           render_text, snapshot)
from tosem_tpu_torch.obs.driveview import DriveViewRecorder, render_scene_svg
from tosem_tpu_torch.obs.log_monitor import LogMonitor
from tosem_tpu_torch.obs.memory_monitor import MemoryMonitor
from tosem_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                         MetricsServer, Registry, counter,
                                         gauge, histogram, prometheus_text)
from tosem_tpu_torch.obs.sysmo import SysMo

__all__ = [
    "metrics", "Counter", "Gauge", "Histogram", "Registry", "MetricsServer",
    "counter", "gauge", "histogram", "prometheus_text", "MemoryMonitor",
    "LogMonitor", "DashboardServer", "snapshot", "render_text",
    "render_html", "SysMo", "DriveViewRecorder", "render_scene_svg",
]
