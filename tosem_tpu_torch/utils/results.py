"""CSV result writer with the study-compatible schema.

A copy of ``tosem_tpu/utils/results.py`` (the port imports nothing of
the JAX package): the same ``SCHEMA`` columns, ``ResultRow`` fields and
CSV encoding, so the two packages' result files join on ``bench_id`` and
read back through either package's :func:`read_results`. The one change:
a row's ``device`` defaults to ``"gpu"``.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, asdict, field
from typing import Any, Dict, Iterable, List, Optional

SCHEMA = [
    "timestamp",     # unix seconds
    "project",       # which subsystem produced the row (ops, parallel, models…)
    "config",        # experiment config name (gemm, conv_sweep, allreduce…)
    "bench_id",      # unique id of the individual measurement
    "metric",        # metric name (gflops, bus_bw_gbps, step_time_ms…)
    "value",         # float value
    "unit",          # unit string
    "device",        # tpu | cpu | gpu
    "n_devices",     # number of participating devices
    "extra",         # JSON blob for shapes/dtypes/anything else
]


@dataclass
class ResultRow:
    project: str
    config: str
    bench_id: str
    metric: str
    value: float
    unit: str
    device: str = "gpu"
    n_devices: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = 0.0

    def to_csv_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["timestamp"] = self.timestamp or time.time()
        d["extra"] = json.dumps(self.extra, sort_keys=True)
        return {k: d[k] for k in SCHEMA}


class ResultWriter:
    """Appends :class:`ResultRow`\\ s to a CSV file, creating the header once."""

    def __init__(self, path: str):
        self.path = path
        self._rows: List[ResultRow] = []

    def add(self, row: ResultRow) -> None:
        self._rows.append(row)

    def add_many(self, rows: Iterable[ResultRow]) -> None:
        self._rows.extend(rows)

    def flush(self) -> None:
        if not self._rows:
            return
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        write_header = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=SCHEMA)
            if write_header:
                w.writeheader()
            for r in self._rows:
                w.writerow(r.to_csv_dict())
        self._rows.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


def read_results(path: str) -> List[Dict[str, Any]]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["value"] = float(r["value"])
        r["n_devices"] = int(r["n_devices"])
        r["extra"] = json.loads(r["extra"]) if r.get("extra") else {}
    return rows
