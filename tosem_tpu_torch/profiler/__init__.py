"""Tracing and profiling: the counterpart of ``tosem_tpu/profiler/``.

- :mod:`tosem_tpu_torch.profiler.spans` — host-side spans and their
  Chrome-tracing dump (a copy of the JAX package's).
- :mod:`tosem_tpu_torch.profiler.trace` — capture by ``torch.profiler``
  and the nvprof-style kernel summary CSV in the JAX package's columns.
"""
from tosem_tpu_torch.profiler.spans import (SpanRecorder, chrome_trace_dump,
                                            get_recorder, span)
from tosem_tpu_torch.profiler.trace import (KERNEL_CSV_COLUMNS, KernelStat,
                                            capture_trace, kernel_summary,
                                            kernel_summary_csv, parse_trace)

__all__ = [
    "SpanRecorder", "chrome_trace_dump", "get_recorder", "span",
    "KERNEL_CSV_COLUMNS", "KernelStat", "capture_trace", "kernel_summary",
    "kernel_summary_csv", "parse_trace",
]
