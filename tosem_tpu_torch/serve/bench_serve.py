"""Serving data-plane microbenchmarks (the serve analog of
``runtime/bench_runtime.py``).

Measures the micro-batching fast path end to end: closed-loop client
fleets against the SAME backend deployed unbatched vs batched —
interleaved A/B rounds in one process per the bench-noise protocol
(single runs are meaningless on shared 2-CPU CI hosts; alternating
rounds see the same machine phases) — plus an open-loop arrival leg and
a warm-vs-cold first-request probe of the deploy-time compile cache.

``python -m tosem_tpu_torch.cli --config=serve_bench`` runs it. A copy of
the JAX package's ``serve/bench_serve.py``; the BERT legs serve the
port's ``BertEncodeBackend`` on ``device`` (the card unless the caller
asks for the CPU). The baseline gate of the reference's ``microbench
--check`` is not ported.
"""
from __future__ import annotations

import time
from typing import List, Optional

from tosem_tpu_torch.serve.bench_common import SuiteEmitter, closed_loop
from tosem_tpu_torch.utils.results import ResultRow

# the JAX package's perf-gated rows of this suite (the port keeps the
# tuple for ``runtime/bench_runtime.py``'s ``--serve --check``)
GATED_SERVE_BENCHES = (
    "serve_single_closed_loop", "serve_unbatched_c16", "serve_batched_c16",
    "serve_batch_speedup",
)


class VectorWorkBackend:
    """Synthetic inference backend: a few chained matvecs per request,
    one chained matmul per batch — realistic per-item device work whose
    vectorized batch path amortizes both the actor round trip and the
    per-call overhead, without model-framework noise."""

    ITERS = 4

    def __init__(self, n: int = 256):
        import numpy as np
        self._w = (np.random.default_rng(0)
                   .normal(size=(n, n)).astype(np.float32) / n)

    def call(self, request):
        import numpy as np
        x = np.full((self._w.shape[0],), float(request["x"]), np.float32)
        for _ in range(self.ITERS):
            x = self._w @ x
        return float(x[0])

    def call_batch(self, requests, pad_to=None):
        import numpy as np
        X = np.stack([np.full((self._w.shape[0],), float(r["x"]),
                              np.float32) for r in requests], axis=1)
        for _ in range(self.ITERS):
            X = self._w @ X
        return [float(v) for v in X[0]]


def _closed_loop(handle, n_clients: int, min_s: float,
                 make_request=None) -> float:
    """``n_clients`` threads in a call loop for >= min_s → ops/s.
    ``make_request(client_idx)`` builds each client's (fixed) payload;
    defaults to the synthetic backend's ``{"x": i}``. (Thin wrapper
    over the shared fleet in :mod:`tosem_tpu_torch.serve.bench_common`.)"""
    mk = make_request or (lambda i: {"x": i})
    return closed_loop(handle.call, n_clients, min_s,
                       lambda i, k: mk(i), timeout=60.0)


def _open_loop(handle, rate: float, duration_s: float) -> float:
    """Open-loop arrivals at ``rate``/s (requests fired on a clock, not
    on completion — the arrival model real traffic follows); returns
    completed/s. A data plane that keeps up completes ≈ rate."""
    futs = []
    t0 = time.perf_counter()
    n = max(1, int(rate * duration_s))
    for i in range(n):
        target = t0 + i / rate
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        futs.append(handle.remote({"x": i}))
    for f in futs:
        f.result(timeout=60.0)
    return n / (time.perf_counter() - t0)


def run_serve_benchmarks(trials: int = 3, min_s: float = 0.5,
                         quiet: bool = False,
                         only: Optional[set] = None,
                         skip_warm: bool = False,
                         device: str = "cuda") -> List[ResultRow]:
    """Interleaved A/B serve benches; ``only`` restricts bench_ids.
    ``device`` is where the BERT legs' replicas run."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.core import Serve

    em = SuiteEmitter("serve", only)
    want, record, emit = em.want, em.record, em.emit

    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_workers=2, memory_monitor=False)

    serve = Serve()
    un = serve.deploy("bench-unbatched", VectorWorkBackend,
                      num_replicas=1, max_retries=1)
    ba = serve.deploy("bench-batched", VectorWorkBackend,
                      num_replicas=1, max_retries=1,
                      max_batch_size=16, batch_wait_ms=3.0)
    h_un, h_ba = serve.get_handle("bench-unbatched"), \
        serve.get_handle("bench-batched")
    h_un.call({"x": 0}, timeout=120.0)     # cold-boot both replicas
    h_ba.call({"x": 0}, timeout=120.0)

    throughput_ids = {"serve_single_closed_loop", "serve_single_unbatched",
                      "serve_single_latency_ratio", "serve_unbatched_c16",
                      "serve_batched_c16", "serve_batch_speedup",
                      "serve_open_loop_c16"}
    if only is None or throughput_ids & only:
        single, single_un, lat_ratio = [], [], []
        unb, bat, ratios, open_tp = [], [], [], []
        for _ in range(max(trials, 1)):
            # one A/B round: every leg sees the same host phase
            s_b = _closed_loop(h_ba, 1, min_s)
            s_u = _closed_loop(h_un, 1, min_s)
            single.append(s_b)
            single_un.append(s_u)
            # single-client closed-loop throughput == 1/latency, so this
            # ratio >= 1/1.2 is the "batching costs an idle client <=
            # 1.2x p50" acceptance criterion, phase-immune in-round
            lat_ratio.append(s_b / s_u if s_u else float("inf"))
            a = _closed_loop(h_un, 16, min_s)
            b = _closed_loop(h_ba, 16, min_s)
            unb.append(a)
            bat.append(b)
            ratios.append(b / a if a else float("inf"))
            if want("serve_open_loop_c16"):
                open_tp.append(_open_loop(h_ba, rate=1.5 * a,
                                          duration_s=min_s))

        emit("serve_single_closed_loop",
             "serve single client closed loop", single)
        emit("serve_single_unbatched",
             "serve single client unbatched", single_un)
        emit("serve_single_latency_ratio",
             "serve single client batched vs unbatched", lat_ratio,
             unit="x")
        emit("serve_unbatched_c16", "serve 16 clients unbatched", unb)
        emit("serve_batched_c16", "serve 16 clients batched", bat)
        emit("serve_batch_speedup", "serve batched vs unbatched speedup",
             ratios, unit="x")
        emit("serve_open_loop_c16", "serve open loop arrivals", open_tp)

    serve.delete("bench-unbatched")
    serve.delete("bench-batched")

    # north-star-shaped leg: tiny-topology BERT at the b8_t512 bucket,
    # padded variable-length requests on the flash kernels. Unbatched
    # serves each request through the SAME max_batch-padded program
    # (bit-exact contract), so the A/B isolates exactly what batching
    # buys: 8 requests per program call instead of 1. Both deployments
    # pre-warm the bucket so compile time stays out of the loops.
    bert_ids = {"serve_bert_unbatched_c16", "serve_bert_batched_c16",
                "serve_bert_batch_speedup"}
    if only is None or bert_ids & only:
        from tosem_tpu_torch.serve.backends import BertEncodeBackend
        kw = dict(num_replicas=1, max_retries=1,
                  init_kwargs={"max_len": 512, "max_batch": 8,
                               "device": device})
        # the unbatched arm pads per request (128/256/384/512 for the
        # 65..504 client lengths): warm ALL of them so no cold compile
        # lands inside its timed loop and inflates the A/B ratio —
        # the batched arm only ever runs the 512 bucket
        serve.deploy("bench-bert-un", BertEncodeBackend,
                     warmup_shapes=[128, 256, 384, 512], **kw)
        ba_dep = serve.deploy("bench-bert-ba", BertEncodeBackend,
                              max_batch_size=8, batch_wait_ms=10.0,
                              buckets=[512],
                              length_of=BertEncodeBackend.length_of,
                              warmup_shapes=[512], **kw)
        hb_un = serve.get_handle("bench-bert-un")
        hb_ba = serve.get_handle("bench-bert-ba")
        # fixed per-client variable lengths: every batch mixes lengths,
        # so the padding-bucket router and key-padding masks do real work
        # variable lengths (65..504), ids wrapped into the tiny vocab
        mk = lambda i: {"ids": [1 + (j % 126)
                                for j in range(1 + 64 + (i * 53) % 440)]}
        hb_un.call(mk(0), timeout=300.0)
        hb_ba.call(mk(0), timeout=300.0)
        bmin_s = max(min_s, 2.0)     # ~240ms/program on slow hosts
        b_unb, b_bat, b_ratio = [], [], []
        for _ in range(max(trials, 1)):
            a = _closed_loop(hb_un, 16, bmin_s, make_request=mk)
            b = _closed_loop(hb_ba, 16, bmin_s, make_request=mk)
            b_unb.append(a)
            b_bat.append(b)
            b_ratio.append(b / a if a else float("inf"))
        emit("serve_bert_unbatched_c16",
             "serve bert b8_t512 16 clients unbatched", b_unb)
        emit("serve_bert_batched_c16",
             "serve bert b8_t512 16 clients batched", b_bat)
        row = emit("serve_bert_batch_speedup",
                   "serve bert b8_t512 batch speedup", b_ratio, unit="x")
        # the flash-path proof: the replica's dispatch tally must show
        # only flash calls (padded batches that fell off the fused path
        # would count under "dense")
        disp = rt.get(ba_dep._replicas[0].stats.remote(),
                      timeout=60.0)["flash_dispatch"]
        if disp.get("dense", 0) or not disp.get("flash", 0):
            raise RuntimeError(
                f"bert serve batches not on the flash path: {disp}")
        if row is not None:
            row.extra["flash_dispatch"] = dict(disp)
        serve.delete("bench-bert-un")
        serve.delete("bench-bert-ba")

    # warm-vs-cold first request: the compile-cache acceptance probe.
    # Not gated (absolute compile seconds swing with host phase); the
    # RATIO is the criterion — a pre-warmed deployment's first request
    # must not pay the JIT.
    if not skip_warm and want("serve_warm_first_request"):
        from tosem_tpu_torch.serve.backends import BertEncodeBackend
        cold = serve.deploy("bench-cold", BertEncodeBackend,
                            num_replicas=1, max_batch_size=8,
                            buckets=[128],
                            length_of=BertEncodeBackend.length_of,
                            init_kwargs={"device": device})
        t0 = time.perf_counter()
        serve.get_handle("bench-cold").call({"ids": [1, 2, 3]},
                                            timeout=300.0)
        cold_ms = (time.perf_counter() - t0) * 1e3
        serve.delete("bench-cold")
        warm = serve.deploy("bench-warm", BertEncodeBackend,
                            num_replicas=1, max_batch_size=8,
                            buckets=[128],
                            length_of=BertEncodeBackend.length_of,
                            init_kwargs={"device": device},
                            warmup_shapes=[128])
        t0 = time.perf_counter()
        serve.get_handle("bench-warm").call({"ids": [1, 2, 3]},
                                            timeout=300.0)
        warm_ms = (time.perf_counter() - t0) * 1e3
        serve.delete("bench-warm")
        row = record("serve_warm_first_request",
                     "serve warm vs cold first request",
                     cold_ms / warm_ms, 0.0, unit="x")
        row.extra.update({"cold_ms": round(cold_ms, 1),
                          "warm_ms": round(warm_ms, 1)})

    if own_runtime:
        rt.shutdown()
    return em.flush(quiet)
