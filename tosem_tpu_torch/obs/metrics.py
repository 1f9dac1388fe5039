"""Metric registry + Prometheus text exporter.

The reference defines its runtime metrics centrally
(``src/ray/stats/metric_defs.h``) and exports them to Prometheus via an
agent (``python/ray/metrics_agent.py``, ``prometheus_exporter.py``). Same
shape here: typed metric objects registered in a (default-global) registry,
rendered in the Prometheus text exposition format, optionally served over
HTTP. The runtime increments task/actor/store counters through this module.

The port's copy of ``tosem_tpu/obs/metrics.py``: the same metric names,
types and labels, so one scrape config reads either package. The
instrument sets of planes not ported yet (cluster serving, the control
plane, distributed training) are defined here all the same.

Thread-safe; label sets are materialized lazily per label-values tuple.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    50.0, float("inf"))


def _escape(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(names: Sequence[str], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], float] = {}

    def _key(self, label_values) -> Tuple[str, ...]:
        vals = tuple(str(v) for v in label_values)
        if len(vals) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {vals}")
        return vals

    def remove(self, labels: Sequence[str] = ()) -> bool:
        """Drop one label series entirely (True if it existed). The
        departed-label discipline: a gauge row for a node/replica that
        left the pool must DISAPPEAR from the exposition — a permanent
        zero row reads as a live-but-idle label set forever."""
        k = self._key(labels)
        with self._lock:
            return self._series.pop(k, None) is not None

    def labelsets(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return sorted(self._series)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            series = dict(self._series)
        for vals, v in sorted(series.items()):
            out.append(f"{self.name}"
                       f"{_fmt_labels(self.label_names, vals)} {v}")
        return out


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, labels: Sequence[str] = ()) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, labels: Sequence[str] = ()) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, description, labels)
        self.buckets = tuple(sorted(set(buckets) | {float("inf")}))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, labels: Sequence[str] = ()) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[k] = self._sums.get(k, 0.0) + value

    def remove(self, labels: Sequence[str] = ()) -> bool:
        k = self._key(labels)
        with self._lock:
            existed = self._counts.pop(k, None) is not None
            self._sums.pop(k, None)
            self._series.pop(k, None)
            return existed

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.description}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = [(k, list(c), self._sums.get(k, 0.0))
                     for k, c in self._counts.items()]
        for vals, counts, total in sorted(items):
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = "+Inf" if b == float("inf") else repr(b)
                lbls = _fmt_labels(self.label_names + ("le",),
                                   vals + (le,))
                out.append(f"{self.name}_bucket{lbls} {cum}")
            base = _fmt_labels(self.label_names, vals)
            out.append(f"{self.name}_sum{base} {total}")
            out.append(f"{self.name}_count{base} {cum}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is not None:
                if type(cur) is not type(metric):
                    raise ValueError(f"metric {metric.name!r} already "
                                     "registered with a different type")
                return cur
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, description="", labels=()) -> Counter:
        return self.register(Counter(name, description, labels))

    def gauge(self, name, description="", labels=()) -> Gauge:
        return self.register(Gauge(name, description, labels))

    def histogram(self, name, description="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, description, labels, buckets))

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def prometheus_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


DEFAULT = Registry()


def counter(name, description="", labels=()):
    return DEFAULT.counter(name, description, labels)


def gauge(name, description="", labels=()):
    return DEFAULT.gauge(name, description, labels)


def histogram(name, description="", labels=(), buckets=_DEFAULT_BUCKETS):
    return DEFAULT.histogram(name, description, labels, buckets)


def prometheus_text() -> str:
    return DEFAULT.prometheus_text()


# Serving data-plane buckets: micro-batch waits are bounded by
# batch_wait_ms (single-digit ms), so the default 1ms-to-50s histogram
# would collapse every observation into two buckets.
_BATCH_WAIT_BUCKETS = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
                       float("inf"))

# Decode-step occupancy is an integer row count bounded by the backend's
# max_batch (small powers of two), not a latency.
_OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                      float("inf"))


def serve_metrics(registry: Optional[Registry] = None) -> Dict[str, Metric]:
    """The serving data plane's instruments, defined in ONE place so
    :mod:`tosem_tpu_torch.serve.batching`, the dashboard, and the tests share
    metric names (the metric_defs.h discipline). All are labelled by
    deployment:

    - ``serve_queue_depth`` (gauge): logical requests waiting in the
      micro-batch queue — the autoscaler-facing demand signal.
    - ``serve_batch_size`` (gauge): size of the most recently flushed
      micro-batch.
    - ``serve_batch_wait_ms`` (histogram): per-request queue wait from
      enqueue to dispatch.
    - ``serve_requests_total`` (counter, labels deployment/outcome):
      logical request outcomes (``ok`` / ``error``) — requests, never
      dispatches, so a 16-request batch counts 16.

    Decode (continuous-batching) instruments, fed by
    :class:`~tosem_tpu_torch.serve.batching.DecodeQueue`:

    - ``serve_decode_active_sequences`` (gauge): sequences currently
      packed into the decode batch.
    - ``serve_decode_batch_occupancy`` (histogram): live rows per decode
      step — low occupancy with a deep queue means page pressure, not
      lack of demand.
    - ``serve_kv_pages`` (gauge, labels deployment/state): KV-cache
      pages ``used`` / ``free`` / ``spilled``.
    - ``serve_kv_pages_evicted_total`` (gauge mirroring a replica-side
      monotonic counter): pages released by sliding-window eviction —
      rising means bounded-memory long-context decode is actually
      evicting, flat with a long window means the window never filled.
    - ``serve_spec_acceptance_rate`` (gauge): accepted / proposed draft
      tokens of speculative decode — the knob that decides whether
      ``spec_k`` pays for itself (commit rate ~ 1 + rate * (k - 1)).

    Live-KV-migration instruments (cluster-scale decode — node drain
    and prefill/decode disaggregation both ride them):

    - ``serve_kv_migrations_total`` (counter, labels deployment/
      outcome): sequence migrations by outcome — ``ok`` (continued
      from the current step on the destination) vs ``fallback``
      (migration failed; the sequence re-admitted from step 0, the
      recompute path).
    - ``serve_kv_migration_ms`` (histogram): wall time of one
      successful export→import migration, per deployment.
    """
    reg = registry or DEFAULT
    return {
        "queue_depth": reg.gauge(
            "serve_queue_depth",
            "logical requests waiting in the micro-batch queue",
            labels=("deployment",)),
        "batch_size": reg.gauge(
            "serve_batch_size",
            "size of the most recently dispatched micro-batch",
            labels=("deployment",)),
        "batch_wait_ms": reg.histogram(
            "serve_batch_wait_ms",
            "per-request wait from enqueue to micro-batch dispatch",
            labels=("deployment",), buckets=_BATCH_WAIT_BUCKETS),
        "requests": reg.counter(
            "serve_requests_total",
            "logical request outcomes (per request, not per dispatch)",
            labels=("deployment", "outcome")),
        "decode_active": reg.gauge(
            "serve_decode_active_sequences",
            "sequences currently packed into the decode batch",
            labels=("deployment",)),
        "decode_occupancy": reg.histogram(
            "serve_decode_batch_occupancy",
            "live rows per decode step",
            labels=("deployment",), buckets=_OCCUPANCY_BUCKETS),
        "kv_pages": reg.gauge(
            "serve_kv_pages",
            "KV-cache pages by state (used/free/spilled)",
            labels=("deployment", "state")),
        "kv_evicted": reg.gauge(
            "serve_kv_pages_evicted_total",
            "KV pages released by sliding-window eviction (lifetime)",
            labels=("deployment",)),
        "spec_acceptance": reg.gauge(
            "serve_spec_acceptance_rate",
            "speculative decode accepted/proposed draft-token ratio",
            labels=("deployment",)),
        "kv_migrations": reg.counter(
            "serve_kv_migrations_total",
            "live KV-cache sequence migrations by outcome "
            "(ok = continued from current step, fallback = re-admitted "
            "from step 0)",
            labels=("deployment", "outcome")),
        "kv_migration_ms": reg.histogram(
            "serve_kv_migration_ms",
            "wall time of one successful sequence migration "
            "(export + import)",
            labels=("deployment",), buckets=_BATCH_WAIT_BUCKETS),
        "kv_pages_shared": reg.gauge(
            "serve_kv_pages_shared",
            "physical KV pages COW-shared by more than one sequence "
            "(each page counts once in serve_kv_pages used)",
            labels=("deployment",)),
        "prefix_hit_rate": reg.gauge(
            "serve_prefix_hit_rate",
            "prefix-cache admit hit ratio (hits / (hits + misses))",
            labels=("deployment",)),
        "prefix_pages": reg.gauge(
            "serve_prefix_pages",
            "KV pages at admit by path (reused = COW-forked from a "
            "cached prefix, prefilled = computed)",
            labels=("deployment", "path")),
        "prefix_suffix_fraction": reg.gauge(
            "serve_prefix_suffix_token_fraction",
            "fraction of admitted prompt tokens actually prefilled "
            "(1.0 = all cold, lower = prefix/session reuse working)",
            labels=("deployment",)),
        "prefix_remote_hits": reg.gauge(
            "serve_prefix_remote_hits_total",
            "prefixes adopted over worker-to-worker transport "
            "(cluster-wide prefix-cache hits on another node)",
            labels=("deployment",)),
    }


def cluster_serve_metrics(registry: Optional[Registry] = None
                          ) -> Dict[str, Metric]:
    """The cluster serving plane's instruments — the node/replica-
    labelled tier above :func:`serve_metrics`' per-deployment gauges.
    Fed by the router tier (``serve/router.py`` ``RouterCore``: each
    router feeds its OWN process registry) and rolled up driver-side by
    ``ClusterServe.stats()``, which mirrors router-process counters
    into the driver registry for one ``/metrics`` scrape surface:

    - ``serve_router_requests_total`` (counter, labels deployment/
      router/path): logical requests by routing path — ``routed``
      (affinity or least-loaded pick honored) vs ``spilled``
      (consistent-hash affinity overridden by queue depth).
    - ``serve_replica_queue_depth`` (gauge, labels deployment/node/
      replica): per-replica in-flight depth as last seen by a router.
    - ``serve_node_queue_depth`` (gauge, labels node): per-node rollup
      of replica queue depths — the signal node-level autoscaling and
      the dashboard's hot-node view read.
    - ``serve_replicas_placed`` (gauge, labels deployment/node):
      replicas currently placed per (deployment, node) — failover
      visibly moves this mass off a dead node.
    - ``serve_admission_shed_total`` (counter, labels deployment/
      class/reason): requests rejected typed (``Overloaded``) by the
      SLO admission check — per priority class, split by shed reason
      (``est_wait`` = estimated wait over budget at arrival,
      ``slot_timeout`` = no dispatch slot freed within the budget).
    - ``serve_router_hedges_total`` (counter, labels deployment/
      outcome): hedged dispatches — ``fired`` counts second attempts
      launched after the quantile-derived delay, ``won`` the subset
      whose result beat the primary (tail absorbed).
    - ``serve_suspect_nodes`` (gauge, labels node): 1 for each node
      currently in the failure detector's SUSPECT state (routers
      de-preference its replicas); the row disappears on clear/death.

    Departed label sets are REMOVED from the gauges (``Metric.remove``),
    never pinned at zero: a dead node's queue-depth row disappearing is
    the honest signal; a permanent zero row is indistinguishable from a
    live idle node.
    """
    reg = registry or DEFAULT
    return {
        "router_requests": reg.counter(
            "serve_router_requests_total",
            "logical requests by routing path (routed vs spilled)",
            labels=("deployment", "router", "path")),
        "replica_queue_depth": reg.gauge(
            "serve_replica_queue_depth",
            "per-replica in-flight request depth (router view)",
            labels=("deployment", "node", "replica")),
        "node_queue_depth": reg.gauge(
            "serve_node_queue_depth",
            "summed replica queue depth per node (router rollup)",
            labels=("node",)),
        "replicas_placed": reg.gauge(
            "serve_replicas_placed",
            "replicas currently placed per deployment and node",
            labels=("deployment", "node")),
        "admission_shed": reg.counter(
            "serve_admission_shed_total",
            "requests shed typed (Overloaded) by SLO admission, "
            "per priority class and shed reason",
            labels=("deployment", "class", "reason")),
        "router_hedges": reg.counter(
            "serve_router_hedges_total",
            "hedged dispatches by outcome (fired / won)",
            labels=("deployment", "outcome")),
        "suspect_nodes": reg.gauge(
            "serve_suspect_nodes",
            "nodes currently SUSPECT in the failure detector",
            labels=("node",)),
    }


def control_plane_metrics(registry: Optional[Registry] = None
                          ) -> Dict[str, Metric]:
    """The closed-loop controller's instruments, fed by
    the control plane (``control/plane.py`` ``ControlPlane``):

    - ``control_demand`` (gauge, labels deployment): the folded demand
      signal (router depth rollup + admission queues) each tick decided
      on — graphing this against ``serve_replicas_placed`` shows the
      loop actually closing.
    - ``control_scale_events_total`` (counter, labels kind/name/
      direction): applied scale decisions (``deployment`` replicas or
      the ``router`` tier, ``up``/``down``).
    - ``control_model_evictions_total`` (counter): cold model
      executables evicted from node ledgers under memory pressure.
    """
    reg = registry or DEFAULT
    return {
        "demand": reg.gauge(
            "control_demand",
            "per-deployment demand signal the control loop decided on",
            labels=("deployment",)),
        "scale_events": reg.counter(
            "control_scale_events_total",
            "applied autoscale decisions by kind and direction",
            labels=("kind", "name", "direction")),
        "model_evictions": reg.counter(
            "control_model_evictions_total",
            "cold model executables evicted under memory pressure"),
    }


def train_metrics(registry: Optional[Registry] = None) -> Dict[str, Metric]:
    """The distributed-training plane's instruments, defined once (the
    metric_defs.h discipline) and fed driver-side by
    the distributed trainer (``DistributedTrainer``, ROADMAP.md A9; workers
    report per-bucket reduce stats in their step results — the router-
    rollup pattern, so multi-process workers need no scrape). All are
    labelled by job:

    - ``train_steps_total`` (counter): global optimizer steps applied.
    - ``train_examples_per_s`` (gauge): global-batch examples per
      second of the most recent step — the throughput the overlap
      engine is supposed to raise.
    - ``train_allreduce_bytes_total`` (counter, labels job/bucket):
      gradient payload bytes moved per all-reduce bucket (chain
      forwards + broadcast legs).
    - ``train_allreduce_ms`` (histogram, labels job/bucket): wall time
      of one bucket's chain reduce — under overlap this hides behind
      backward, but the histogram still shows what WOULD serialize.
    - ``train_dp_size`` (gauge): current worker count of the dp axis —
      elasticity (shrink on node death, grow on rejoin) moves this.
    """
    reg = registry or DEFAULT
    return {
        "steps": reg.counter(
            "train_steps_total",
            "global optimizer steps applied", labels=("job",)),
        "examples_per_s": reg.gauge(
            "train_examples_per_s",
            "global-batch examples per second (latest step)",
            labels=("job",)),
        "allreduce_bytes": reg.counter(
            "train_allreduce_bytes_total",
            "gradient all-reduce payload bytes by bucket",
            labels=("job", "bucket")),
        "allreduce_ms": reg.histogram(
            "train_allreduce_ms",
            "wall time of one bucket's gradient all-reduce",
            labels=("job", "bucket"), buckets=_BATCH_WAIT_BUCKETS),
        "dp_size": reg.gauge(
            "train_dp_size",
            "current data-parallel worker count", labels=("job",)),
    }


class MetricsServer:
    """Tiny /metrics HTTP endpoint (prometheus_exporter.py role)."""

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        from tosem_tpu_torch.obs.httpd import RouteServer
        reg = registry or DEFAULT

        def route(path):
            if path.split("?", 1)[0] not in ("/", "/metrics"):
                return (404, "text/plain", b"not found\n")
            return (200, "text/plain; version=0.0.4",
                    reg.prometheus_text().encode())

        self._server = RouteServer(route, host, port, name="metrics-http")
        self.host, self.port = self._server.host, self._server.port

    @property
    def url(self) -> str:
        return f"{self._server.url}/metrics"

    def shutdown(self) -> None:
        self._server.shutdown()
