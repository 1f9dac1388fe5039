"""Shared harness for the serving microbench suites.

The serve, decode, and cluster benches all follow the bench-noise
protocol for the bimodal shared CI hosts: interleaved A/B rounds (both
arms of a round see the same host phase), per-round rates recorded so
``--save`` can floor the baseline at the min across rounds, and the
speedup ratio computed in-round (phase-immune). The closed-loop client
fleet and the row/release-line emission were copy-pasted between
``bench_serve.py`` and ``bench_decode.py``; this module is the single
copy both (and ``bench_cluster.py``) now ride.

A copy of the JAX package's ``serve/bench_common.py``; it carries its
own row emitter (the reference's comes from ``runtime/bench_runtime.py``,
which the port has not got yet).
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import Any, Callable, List, Optional

from tosem_tpu_torch.utils.results import ResultRow


def closed_loop(call: Callable[..., Any], n_clients: int, min_s: float,
                make_request: Callable[[int, int], Any],
                count_of: Optional[Callable[[Any], float]] = None,
                timeout: float = 120.0,
                samples: Optional[List[tuple]] = None) -> float:
    """``n_clients`` threads calling ``call(request, timeout=...)`` in a
    loop for >= ``min_s`` → completed units per second.

    ``make_request(client_idx, iteration)`` builds each call's payload
    (fixed-per-client fleets ignore ``iteration``; the decode fleet
    cycles prompts with it). ``count_of(response)`` weighs a completed
    call (default 1.0; the token fleets count generated tokens). The
    first client error aborts the measurement and is re-raised — a
    bench must never average over silent failures. ``samples``, when
    given, collects one ``(latency_s, units)`` tuple per completed call
    — the raw material for per-unit latency percentiles (p50/p99
    per-token rows)."""
    stop = time.perf_counter() + min_s
    counts = [0.0] * n_clients
    errors: List[BaseException] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        k = 0
        try:
            while time.perf_counter() < stop:
                c0 = time.perf_counter()
                out = call(make_request(i, k), timeout=timeout)
                dt = time.perf_counter() - c0
                units = count_of(out) if count_of is not None else 1.0
                counts[i] += units
                if samples is not None:
                    with lock:
                        samples.append((dt, units))
                k += 1
        except BaseException as e:   # pragma: no cover - surfaced below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return sum(counts) / (time.perf_counter() - t0)


def per_unit_percentiles(samples: List[tuple],
                         pcts=(50, 99)) -> List[float]:
    """Per-unit latencies (call latency / units completed by that call)
    → the requested percentiles, in ms. A decode call that generated 32
    tokens contributes ONE sample of its per-token cost — the caller-
    visible amortized latency, not a fabricated per-token timeline."""
    per_unit = sorted(dt / max(u, 1.0) for dt, u in samples)
    if not per_unit:
        return [float("nan")] * len(pcts)
    out = []
    for p in pcts:
        idx = min(int(len(per_unit) * p / 100.0), len(per_unit) - 1)
        out.append(per_unit[idx] * 1e3)
    return out


def paired_loop(call_a: Callable[..., Any], call_b: Callable[..., Any],
                n_each: int, min_s: float,
                make_request: Callable[[int, int], Any],
                timeout: float = 120.0) -> "tuple[float, float]":
    """Two closed-loop fleets run CONCURRENTLY over the same wall-clock
    window → (rate_a, rate_b). The strongest phase control this host
    allows: both arms see the same milliseconds, so a host-phase flip
    or GIL convoy hits them together — the ratio is a relative-capacity
    measurement, not a which-window-was-slow lottery. (Sequential A/B
    windows measure the phase; see the failover leg's history.)"""
    stop = time.perf_counter() + min_s
    counts = [0.0, 0.0]
    lock = threading.Lock()
    errors: List[BaseException] = []

    def client(arm: int, call, i: int) -> None:
        c, k = 0, 0
        try:
            while time.perf_counter() < stop:
                call(make_request(i, k), timeout=timeout)
                c += 1
                k += 1
        except BaseException as e:   # pragma: no cover - surfaced below
            errors.append(e)
        with lock:
            counts[arm] += c

    threads = ([threading.Thread(target=client, args=(0, call_a, i))
                for i in range(n_each)]
               + [threading.Thread(target=client, args=(1, call_b, i))
                  for i in range(n_each)])
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    dt = time.perf_counter() - t0
    return counts[0] / dt, counts[1] / dt


class SuiteEmitter:
    """Row/release-line emission for one bench suite: the ``want``
    subset filter, the mean±sd row with per-round minima in ``extra``
    (what ``--save`` floors baselines at), and the quiet-mode line
    buffer."""

    def __init__(self, suite: str, only: Optional[set] = None):
        self.suite = suite
        self.only = only
        self.rows: List[ResultRow] = []
        self.lines: List[str] = []

    def want(self, bench_id: str) -> bool:
        return self.only is None or bench_id in self.only

    def record(self, bench_id: str, name: str, mean: float, sd: float,
               unit: str = "ops/s") -> ResultRow:
        """One row in the study's schema plus its release line
        (``<name> per second <mean> +- <sd>``). The serving benches run
        on the host, so the row's device is ``cpu``."""
        self.lines.append(f"{name} per second {mean:.2f} +- {sd:.2f}")
        row = ResultRow(project="runtime", config="microbenchmark",
                        bench_id=bench_id, metric=name.replace(" ", "_"),
                        value=mean, unit=unit, device="cpu", n_devices=1,
                        extra={"stddev": sd, "suite": self.suite})
        self.rows.append(row)
        return row

    def emit(self, bench_id: str, name: str, vals: List[float],
             unit: str = "ops/s",
             lower_is_better: bool = False) -> Optional[ResultRow]:
        """Per-round values → one row carrying mean, sd, rounds, and
        the conservative floor (min of rounds for throughput rows, MAX
        for ``lower_is_better`` latency rows — ``--save`` reads
        ``extra["min"]`` as the baseline value either way, and the gate
        inverts its direction off ``extra["lower_is_better"]``).
        Skipped (None) when filtered out or empty."""
        if not self.want(bench_id) or not vals:
            return None
        m = statistics.mean(vals)
        sd = statistics.stdev(vals) if len(vals) > 1 else 0.0
        row = self.record(bench_id, name, m, sd, unit=unit)
        row.extra["rounds"] = [round(v, 4) for v in vals]
        floor = max(vals) if lower_is_better else min(vals)
        row.extra["min"] = round(floor, 4)
        if lower_is_better:
            row.extra["lower_is_better"] = True
        return row

    def emit_floored(self, bench_id: str, name: str, vals: List[float],
                     floor: float, unit: str = "x") -> Optional[ResultRow]:
        """:meth:`emit` for a ratio the JAX package holds to a speed
        floor set on its own hosts: the row carries ``reference_floor``
        and ``floor_met`` (the best round against it), and nothing
        raises — no speed target carries over to the port."""
        row = self.emit(bench_id, name, vals, unit=unit)
        if row is not None:
            row.extra["reference_floor"] = floor
            row.extra["floor_met"] = max(vals) >= floor
        return row

    def flush(self, quiet: bool) -> List[ResultRow]:
        if not quiet:
            for ln in self.lines:
                print(ln)
        return self.rows
