"""Trace capture and the nvprof-style kernel summary.

Counterpart of ``tosem_tpu/profiler/trace.py``. The JAX package captures
with ``jax.profiler`` and parses the ``.xplane.pb``; here
:func:`capture_trace` runs ``torch.profiler`` (CPU and, with a card,
CUDA activities) and writes its Chrome trace into ``log_dir``, and
:func:`parse_trace` reads that JSON. :func:`kernel_summary` aggregates
with nvprof ``--print-gpu-summary`` semantics (calls, total, mean, min,
max and share a name) and :func:`kernel_summary_csv` writes the JAX
package's columns (:data:`KERNEL_CSV_COLUMNS`), so both packages' CSVs
read alike.

Device events (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) are
on plane ``/device:GPU:<id>``, their stream as the line. A capture with
no device events (a CPU run) falls back to the host's ``cpu_op`` events
(plane ``/host:CPU``, the thread as the line), as the JAX package falls
back to its host lines; nested ops then count in their parents too.
"""
from __future__ import annotations

import contextlib
import csv
import glob
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

KERNEL_CSV_COLUMNS = [
    "name", "plane", "calls", "total_us", "mean_us", "min_us", "max_us",
    "pct",
]

_DEVICE_PLANE = re.compile(r"/device:(TPU|GPU)", re.I)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRACE_SUFFIX = ".pt.trace.json"


@dataclass
class KernelStat:
    name: str
    plane: str
    calls: int = 0
    total_us: float = 0.0
    min_us: float = float("inf")
    max_us: float = 0.0

    @property
    def mean_us(self) -> float:
        return self.total_us / self.calls if self.calls else 0.0

    def add(self, dur_us: float) -> None:
        self.calls += 1
        self.total_us += dur_us
        self.min_us = min(self.min_us, dur_us)
        self.max_us = max(self.max_us, dur_us)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace to ``log_dir/trace_<ns>.pt.trace.json``; yields the dir. On the
    card, sync before leaving the block so its kernels are in the
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}{_TRACE_SUFFIX}"))


def latest_trace(log_dir: str) -> str:
    found = glob.glob(os.path.join(log_dir, "**", f"*{_TRACE_SUFFIX}"),
                      recursive=True)
    if not found:
        raise FileNotFoundError(f"no *{_TRACE_SUFFIX} under {log_dir}")
    return max(found, key=os.path.getmtime)


def parse_trace(path_or_dir: str) -> Iterator[Tuple[str, str, str, float]]:
    """Yield (plane, line, event name, duration in us) for every device
    event of a torch Chrome trace, and every ``cpu_op`` event."""
    path = (latest_trace(path_or_dir) if os.path.isdir(path_or_dir)
            else path_or_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat"), ev.get("args") or {}
        if cat in _DEVICE_CATS:
            yield (f"/device:GPU:{args.get('device', 0)}",
                   f"stream {args.get('stream', 0)}", ev["name"],
                   float(ev.get("dur", 0.0)))
        elif cat == "cpu_op":
            yield ("/host:CPU", f"thread {ev.get('tid', 0)}", ev["name"],
                   float(ev.get("dur", 0.0)))


def kernel_summary(path_or_dir: str, *, device_only: bool = True,
                   name_filter: Optional[str] = None) -> List[KernelStat]:
    """nvprof ``--print-gpu-summary`` over a capture, sorted by total
    time. ``device_only`` keeps the device planes' events; a capture with
    no device plane falls back to the host's ops."""
    pat = re.compile(name_filter) if name_filter else None
    stats: Dict[Tuple[str, str], KernelStat] = {}
    rows = list(parse_trace(path_or_dir))
    planes = {p for p, _, _, _ in rows}
    device_planes = {p for p in planes if _DEVICE_PLANE.search(p)}
    use_planes = device_planes if (device_only and device_planes) else planes
    for plane, _, name, dur_us in rows:
        if plane not in use_planes:
            continue
        if pat and not pat.search(name):
            continue
        key = (plane, name)
        if key not in stats:
            stats[key] = KernelStat(name=name, plane=plane)
        stats[key].add(dur_us)
    return sorted(stats.values(), key=lambda s: -s.total_us)


def kernel_summary_csv(path_or_dir: str, csv_path: str,
                       **kw) -> List[KernelStat]:
    """Write the kernel summary in :data:`KERNEL_CSV_COLUMNS`; returns
    it."""
    stats = kernel_summary(path_or_dir, **kw)
    grand = sum(s.total_us for s in stats) or 1.0
    parent = os.path.dirname(os.path.abspath(csv_path))
    os.makedirs(parent, exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(KERNEL_CSV_COLUMNS)
        for s in stats:
            w.writerow([s.name, s.plane, s.calls,
                        f"{s.total_us:.3f}", f"{s.mean_us:.3f}",
                        f"{s.min_us:.3f}", f"{s.max_us:.3f}",
                        f"{100.0 * s.total_us / grand:.2f}"])
    return stats
