"""Runtime microbenchmarks — the ``ray microbenchmark`` analog.

Mirrors the harness at ``python/ray/ray_perf.py:74-233`` and emits the same
release-log line format as ``release/release_logs/1.0.1/microbenchmark.txt``
(``"<name> per second NNNN.NN +- SS.S"``), so the rebuild's numbers sit next
to the reference anchors in SURVEY §6 (single-client get 30,921/s, put
26,507/s, tasks sync 1,045/s, tasks async 14,319/s, 1:1 actor sync 1,546/s…).
Also funnels rows through the study-schema CSV writer.

A copy of the JAX package's ``runtime/bench_runtime.py`` over the port's
runtime and cluster planes. ``python -m tosem_tpu_torch.runtime.bench_runtime``
runs :func:`main`, as does ``python -m tosem_tpu_torch.cli microbench``.
``--save`` and ``--check`` take the baseline's path and have no default:
the port never reads or writes the JAX package's ``results/bench_*.json``.
``--kernels`` and ``--sparse`` run ``ops/bench_kernels.py`` and
``ops/bench_sparse.py`` on ``--device``; the sparse suite runs at
t8192 on the card and t256 on the CPU.
"""
from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, List, Optional, Tuple

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.utils.results import ResultRow

# Benches the ci.sh perf_smoke tier gates on (the latency-critical task
# hot path). Throughput-style rows only — every one is higher-is-better,
# so "regression" is simply current < baseline * (1 - threshold).
GATED_BENCHES = (
    "single_client_get", "single_client_put", "tasks_sync", "tasks_async",
    "small_result_async", "large_object_roundtrip", "wait_fanout",
    "actor_calls_sync", "actor_calls_async",
    # zero-copy object plane (mapped-in-place reads): absolute rates for
    # both arms plus the mapped/copy ratio — the ratio is what the
    # acceptance pins (>= 3x on an 8 MB ndarray), and it is robust to
    # the bimodal hosts because both arms ride the same phase
    "large_get_mapped", "large_get_mapped_speedup",
    "serve_handoff_mapped", "serve_handoff_mapped_speedup",
)


def _timeit_ab(fn_a: Callable[[], int], fn_b: Callable[[], int],
               trials: int = 3, min_s: float = 0.5
               ) -> Tuple[List[float], List[float]]:
    """Finely interleaved A/B rates: within every round the two arms
    alternate op-batch by op-batch until the round has run >= 2*min_s,
    and each arm's rate is its ops over ITS accumulated time. The
    alternation keeps both arms inside the same host phase (the 2-CPU
    bench hosts are bimodal — coarse per-arm rounds measure the phase,
    not the code), so per-round A/B ratios are phase-cancelled and the
    min-of-rounds floor is meaningful."""
    fn_a()
    fn_b()  # untimed warmup for both arms
    rates_a: List[float] = []
    rates_b: List[float] = []
    for _ in range(trials):
        ops_a = ops_b = 0
        t_a = t_b = 0.0
        while t_a + t_b < 2 * min_s:
            t0 = time.perf_counter()
            ops_a += fn_a()
            t1 = time.perf_counter()
            ops_b += fn_b()
            t2 = time.perf_counter()
            t_a += t1 - t0
            t_b += t2 - t1
        rates_a.append(ops_a / t_a)
        rates_b.append(ops_b / t_b)
    return rates_a, rates_b


def _timeit(name: str, fn: Callable[[], int], trials: int = 3,
            min_s: float = 0.5) -> Tuple[float, float]:
    """Run ``fn`` (returns #ops) repeatedly for >= min_s per trial."""
    fn()  # untimed warmup: shm page faults, pipe setup, fn registration
    rates = []
    for _ in range(trials):
        ops = 0
        t0 = time.perf_counter()
        while True:
            ops += fn()
            dt = time.perf_counter() - t0
            if dt >= min_s:
                break
        rates.append(ops / dt)
    mean = statistics.mean(rates)
    sd = statistics.stdev(rates) if len(rates) > 1 else 0.0
    return mean, sd


def _record(rows: List[ResultRow], lines: List[str], bench_id: str,
            name: str, mean: float, sd: float,
            unit: str = "ops/s", extra: Optional[dict] = None) -> None:
    """Shared row/release-line emitter for every microbench runner —
    one place for the schema (project/config/metric/stddev) so the two
    harnesses cannot diverge. ``extra`` merges into the row's extra dict
    (A/B rows carry their min-of-rounds floor there)."""
    lines.append(_release_line(name, mean, sd))
    row_extra = {"stddev": sd}
    if extra:
        row_extra.update(extra)
    rows.append(ResultRow(project="runtime", config="microbenchmark",
                          bench_id=bench_id,
                          metric=name.replace(" ", "_"),
                          value=mean, unit=unit, device="cpu",
                          n_devices=1, extra=row_extra))


def _release_line(name: str, mean: float, sd: float) -> str:
    return f"{name} per second {mean:.2f} +- {sd:.2f}"


def run_microbenchmarks(num_workers: int = 4, trials: int = 3,
                        min_s: float = 0.5, quiet: bool = False,
                        only: Optional[set] = None) -> List[ResultRow]:
    """Run the task/object-plane microbenchmarks; ``only`` restricts to
    a subset of bench_ids (test smokes run a cheap slice, CI and the
    baseline recorder run everything)."""
    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_workers=num_workers)
    rows: List[ResultRow] = []
    lines: List[str] = []

    def want(bench_id):
        return only is None or bench_id in only

    def record(bench_id, name, mean, sd, unit="ops/s"):
        _record(rows, lines, bench_id, name, mean, sd, unit)

    # --- object plane (ray_perf.py "single client get/put") ---------------
    obj = rt.put(b"x" * 1024)
    BATCH = 1000

    if want("single_client_get"):
        def do_gets():
            for _ in range(BATCH):
                rt.get(obj)
            return BATCH
        m, s = _timeit("get", do_gets, trials, min_s)
        record("single_client_get", "single client get calls", m, s)

    if want("single_client_put"):
        payload = b"x" * 1024

        def do_puts():
            for _ in range(BATCH):
                rt.put(payload)
            return BATCH
        m, s = _timeit("put", do_puts, trials, min_s)
        record("single_client_put", "single client put calls", m, s)

    # --- put bandwidth (ray_perf "single client put gigabytes") -----------
    if want("single_client_put_gbps"):
        mb = b"x" * (1 << 20)

        def do_put_gb():
            for _ in range(16):
                rt.put(mb)
            return 16
        m, s = _timeit("put_gb", do_put_gb, trials, min_s)
        record("single_client_put_gbps", "single client put gigabytes",
               m / 1024.0, s / 1024.0, unit="GB/s")

    # --- tasks ------------------------------------------------------------
    @rt.remote
    def tiny():
        return b"ok"

    if want("tasks_sync"):
        def tasks_sync():
            for _ in range(100):
                rt.get(tiny.remote())
            return 100
        m, s = _timeit("tasks_sync", tasks_sync, trials, min_s)
        record("tasks_sync", "tasks synchronous", m, s)

    if want("tasks_async"):
        def tasks_async():
            rt.get([tiny.remote() for _ in range(1000)])
            return 1000
        m, s = _timeit("tasks_async", tasks_async, trials, min_s)
        record("tasks_async", "tasks async", m, s)

    # --- fast-path specific benches ----------------------------------------
    # small results ride the result pipe inline (no store round trip)
    if want("small_result_async"):
        small = b"y" * 8192

        @rt.remote
        def small_result():
            return small

        def small_results():
            rt.get([small_result.remote() for _ in range(500)])
            return 500
        m, s = _timeit("small_result_async", small_results, trials, min_s)
        record("small_result_async", "small result (8KB) tasks async",
               m, s)

    # large objects go driver→store→worker as StoreRef (zero-copy arg
    # forwarding) and back as a store result — the >INLINE_THRESHOLD leg
    if want("large_object_roundtrip"):
        big = b"z" * (4 << 20)

        @rt.remote
        def consume(buf):
            return len(buf)

        def large_roundtrip():
            ref = rt.put(big)
            assert rt.get(consume.remote(ref)) == len(big)
            return 1
        m, s = _timeit("large_object", large_roundtrip, trials, min_s)
        record("large_object_roundtrip", "large object (4MB) put+task",
               m, s)

    # --- zero-copy object plane: mapped-vs-copy A/B ------------------------
    # a get() of a large ndarray maps its buffer IN PLACE over the shm
    # segment (readonly, pinned) instead of memcpying it to the heap.
    # Interleaved A/B + min-of-rounds floors (bimodal-host protocol);
    # both arms proven bit-identical first.
    def record_ab(bench_id, name, rates, unit="ops/s"):
        mean = statistics.mean(rates)
        sd = statistics.stdev(rates) if len(rates) > 1 else 0.0
        _record(rows, lines, bench_id, name, mean, sd, unit,
                extra={"min": min(rates)})

    mapped_ids = {"large_get_copy", "large_get_mapped",
                  "large_get_mapped_speedup"}
    if only is None or mapped_ids & only:
        import numpy as np
        big_arr = np.arange(2 << 20, dtype=np.float32)      # 8 MB
        big_ref = rt.put(big_arr)
        mapped = rt.get(big_ref)
        copied = rt.get(big_ref, copy=True)
        assert not mapped.flags.writeable       # mapped reads are readonly
        assert np.array_equal(mapped, copied)   # and bit-identical
        del mapped, copied
        GETS = 8

        def get_copy():
            for _ in range(GETS):
                rt.get(big_ref, copy=True)
            return GETS

        def get_mapped():
            for _ in range(GETS):
                rt.get(big_ref)
            return GETS
        rc_, rm_ = _timeit_ab(get_copy, get_mapped, trials, min_s)
        record_ab("large_get_copy", "large get (8MB ndarray) copied", rc_)
        record_ab("large_get_mapped", "large get (8MB ndarray) mapped", rm_)
        ratios = [m / c for m, c in zip(rm_, rc_)]
        record_ab("large_get_mapped_speedup",
                  "large get mapped over copied", ratios, unit="x")
        del big_ref

    # serve-handoff A/B: a replica-actor's large batch result fetched by
    # the serving data plane (the BatchQueue._complete shape) — mapped
    # removes the driver-side memcpy from the handoff
    handoff_ids = {"serve_handoff_copy", "serve_handoff_mapped",
                   "serve_handoff_mapped_speedup"}
    if only is None or handoff_ids & only:
        import numpy as np

        @rt.remote
        class _BatchProducer:
            def __init__(self):
                import numpy as _np
                self._out = _np.arange(2 << 20, dtype=_np.float32)  # 8 MB

            def batch(self):
                return self._out

        prod = _BatchProducer.remote()
        a = rt.get(prod.batch.remote())
        b = rt.get(prod.batch.remote(), copy=True)
        assert np.array_equal(a, b)
        del a, b
        CALLS = 5

        def handoff_copy():
            for _ in range(CALLS):
                rt.get(prod.batch.remote(), copy=True)
            return CALLS

        def handoff_mapped():
            for _ in range(CALLS):
                rt.get(prod.batch.remote())
            return CALLS
        hc, hm = _timeit_ab(handoff_copy, handoff_mapped, trials, min_s)
        record_ab("serve_handoff_copy",
                  "serve handoff (8MB actor result) copied", hc)
        record_ab("serve_handoff_mapped",
                  "serve handoff (8MB actor result) mapped", hm)
        ratios = [m / c for m, c in zip(hm, hc)]
        record_ab("serve_handoff_mapped_speedup",
                  "serve handoff mapped over copied", ratios, unit="x")

    # wait() fan-out: N outstanding tasks collected through rt.wait
    if want("wait_fanout"):
        def wait_fanout():
            refs = [tiny.remote() for _ in range(200)]
            while refs:
                done, refs = rt.wait(refs,
                                     num_returns=min(10, len(refs)),
                                     timeout=30.0)
                assert done
            return 200
        m, s = _timeit("wait_fanout", wait_fanout, trials, min_s)
        record("wait_fanout", "wait fanout tasks", m, s)

    # --- actors -----------------------------------------------------------
    actor_ids = {"actor_calls_sync", "actor_calls_async",
                 "n_n_actor_calls_async"}
    if only is None or actor_ids & only:
        @rt.remote
        class Echo:
            def ping(self):
                return b"ok"

        a = Echo.remote()
        rt.get(a.ping.remote())  # actor warm

        if want("actor_calls_sync"):
            def actor_sync():
                for _ in range(100):
                    rt.get(a.ping.remote())
                return 100
            m, s = _timeit("actor_sync", actor_sync, trials, min_s)
            record("actor_calls_sync", "1:1 actor calls sync", m, s)

        if want("actor_calls_async"):
            def actor_async():
                rt.get([a.ping.remote() for _ in range(1000)])
                return 1000
            m, s = _timeit("actor_async", actor_async, trials, min_s)
            record("actor_calls_async", "1:1 actor calls async", m, s)

        if want("n_n_actor_calls_async"):
            n = max(2, num_workers)
            actors = [Echo.remote() for _ in range(n)]
            rt.get([b.ping.remote() for b in actors])

            def nn_actor_async():
                refs = []
                for b in actors:
                    refs.extend(b.ping.remote() for _ in range(250))
                rt.get(refs)
                return len(refs)
            m, s = _timeit("nn_actor_async", nn_actor_async, trials,
                           min_s)
            record("n_n_actor_calls_async", "n:n actor calls async",
                   m, s)

    # --- placement groups -------------------------------------------------
    if want("placement_group_cycle"):
        def pg_cycle():
            for _ in range(100):
                rt.placement_group(1).remove()
            return 100
        m, s = _timeit("pg_cycle", pg_cycle, trials, min_s)
        record("placement_group_cycle", "placement group create/remove",
               m, s)

    if not quiet:
        for ln in lines:
            print(ln)
    if own_runtime:
        rt.shutdown()
    return rows


def save_baseline(rows: List[ResultRow], path: str,
                  num_workers: int) -> None:
    """Record a microbench run as the regression-gate baseline JSON."""
    benches = {}
    for r in rows:
        entry = {"metric": r.metric, "value": r.value, "unit": r.unit,
                 "stddev": r.extra.get("stddev", 0.0)}
        if r.extra.get("lower_is_better"):
            entry["direction"] = "lower"   # latency-style row: the gate
            #                                fails on INCREASE
        benches[r.bench_id] = entry
    doc = {"schema": "bench_runtime/v1",
           "captured_unix": time.time(),
           "num_workers": num_workers,
           "benches": benches}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def check_against_baseline(rows: List[ResultRow], baseline_path: str,
                           threshold: float = 0.30,
                           gated: Optional[Tuple[str, ...]] = None
                           ) -> Tuple[bool, List[str]]:
    """Compare a run against a recorded baseline (higher-is-better rows).

    Returns (ok, report_lines). A gated bench regressing by more than
    ``threshold`` (fractional) fails the gate; benches present in only
    one of the two sets are reported but do not fail (so adding a bench
    does not break CI until a new baseline is recorded). ``gated``
    defaults to the runtime suite's :data:`GATED_BENCHES`; the serve
    suite passes its own tuple.
    """
    try:
        with open(baseline_path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise SystemExit(
            f"perf baseline {baseline_path!r} not found — record one "
            "first: python -m tosem_tpu_torch.runtime.bench_runtime "
            "--save "
            f"{baseline_path}")
    base = doc.get("benches", {})
    current = {r.bench_id: r for r in rows}
    ok = True
    report: List[str] = []
    for bid in (GATED_BENCHES if gated is None else gated):
        if bid not in base:
            continue
        if bid not in current:
            report.append(f"  {bid}: MISSING from current run (skipped)")
            continue
        b, c = base[bid]["value"], current[bid].value
        ratio = c / b if b else float("inf")
        if base[bid].get("direction") == "lower":
            # latency row: regression = got SLOWER than the ceiling
            if c > b * (1.0 + threshold):
                ok = False
                report.append(
                    f"  {bid}: REGRESSION {c:,.3f} vs baseline "
                    f"{b:,.3f} ({ratio:.2f}x > "
                    f"{1 + threshold:.2f}x ceiling)")
            else:
                report.append(f"  {bid}: ok {c:,.3f} vs baseline "
                              f"{b:,.3f} ({ratio:.2f}x, lower=better)")
            continue
        floor = b * (1.0 - threshold)
        if c < floor:
            ok = False
            report.append(f"  {bid}: REGRESSION {c:,.1f} vs baseline "
                          f"{b:,.1f} ({ratio:.2f}x < {1 - threshold:.2f}x "
                          "floor)")
        else:
            report.append(f"  {bid}: ok {c:,.1f} vs baseline {b:,.1f} "
                          f"({ratio:.2f}x)")
    return ok, report


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m tosem_tpu_torch.runtime.bench_runtime`` entry point.

    --save records the run as a baseline JSON; --check gates the run
    against a recorded baseline (exit 1 on >threshold regression) — the
    ci.sh perf_smoke tier.
    """
    import argparse
    p = argparse.ArgumentParser(prog="python -m tosem_tpu_torch.runtime.bench_runtime",
                                description="runtime microbenchmarks")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--min-s", type=float, default=0.5)
    p.add_argument("--save", default=None,
                   help="write the run as a baseline JSON")
    p.add_argument("--check", default=None,
                   help="baseline JSON to gate against")
    p.add_argument("--threshold", type=float, default=0.30,
                   help="allowed fractional regression vs baseline")
    p.add_argument("--control-plane", action="store_true",
                   help="also run the RPC/channel/xlang/param benches")
    p.add_argument("--serve", action="store_true",
                   help="run the serving data-plane benches "
                        "(serve/bench_serve.py) instead of the runtime "
                        "ones — the micro-batching fast path")
    p.add_argument("--decode", action="store_true",
                   help="run the autoregressive-decode benches "
                        "(serve/bench_decode.py) instead — continuous "
                        "batching vs the re-encode baseline")
    p.add_argument("--cluster", action="store_true",
                   help="run the cluster serving benches "
                        "(serve/bench_cluster.py) instead — 2 nodes x 2 "
                        "replicas behind the router tier vs the single-"
                        "process data plane, plus the node-kill "
                        "failover leg")
    p.add_argument("--control", action="store_true",
                   help="run the control-plane benches "
                        "(serve/bench_cluster.py diurnal scenario) "
                        "instead — open-loop 1x->8x->1x ramp with the "
                        "closed autoscaling loop, SLO admission, and "
                        "warm-before-traffic scale-up live")
    p.add_argument("--sparse", action="store_true",
                   help="run the block-sparse attention benches "
                        "(ops/bench_sparse.py) instead — t8192 "
                        "LocalMask(1024) vs the dense-causal flash "
                        "path, interleaved A/B")
    p.add_argument("--kernels", action="store_true",
                   help="run the cross-backend kernel benches "
                        "(ops/bench_kernels.py) instead — every "
                        "registered lowering of every kernel family, "
                        "interleaved A/B, parity-pinned; off-chip rows "
                        "labelled platform=cpu")
    p.add_argument("--train", action="store_true",
                   help="run the distributed-training benches "
                        "(train/bench_train.py) instead — bucketed-"
                        "overlap vs serialized all-reduce on a comms-"
                        "dominated dp4 job, async vs sync checkpoint "
                        "step cost, and the dp-vs-single-process "
                        "bit-identity pin")
    p.add_argument("--scenario", default=None,
                   choices=("window", "beam", "spec", "prefix",
                            "decode", "migrate"),
                   help="with --decode: run one decode fast-path "
                        "scenario's legs only (sliding-window t8192 "
                        "A/B, beam fanout, speculative k=4, prefix-"
                        "cache TTFT A/B + sessions); with "
                        "--cluster: decode (disaggregated prefill/"
                        "decode A/B) or migrate (drain-with-migration "
                        "vs step-0 re-admission)")
    p.add_argument("--only", default=None,
                   help="comma-separated bench_id subset, or 'gated' for "
                        "exactly the perf_smoke-gated benches")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the serve, decode and cluster suites' "
                        "model replicas, the train suite's ranks and the "
                        "kernel and sparse suites' kernels run")
    args = p.parse_args(argv)

    if args.sparse:
        from tosem_tpu_torch.ops.bench_sparse import GATED_SPARSE_BENCHES
        gated = GATED_SPARSE_BENCHES
    elif args.kernels:
        from tosem_tpu_torch.ops.bench_kernels import GATED_KERNEL_BENCHES
        gated = GATED_KERNEL_BENCHES
    elif args.serve:
        from tosem_tpu_torch.serve.bench_serve import GATED_SERVE_BENCHES
        gated = GATED_SERVE_BENCHES
    elif args.decode:
        from tosem_tpu_torch.serve.bench_decode import GATED_DECODE_BENCHES
        gated = GATED_DECODE_BENCHES
    elif args.cluster:
        from tosem_tpu_torch.serve.bench_cluster import GATED_CLUSTER_BENCHES
        gated = GATED_CLUSTER_BENCHES
    elif args.control:
        from tosem_tpu_torch.serve.bench_cluster import GATED_CONTROL_BENCHES
        gated = GATED_CONTROL_BENCHES
    elif args.train:
        from tosem_tpu_torch.train.bench_train import GATED_TRAIN_BENCHES
        gated = GATED_TRAIN_BENCHES
    else:
        gated = GATED_BENCHES
    only = None
    if args.only:
        only = (set(gated) if args.only == "gated"
                else set(args.only.split(",")))
    if args.scenario:
        if args.cluster:
            from tosem_tpu_torch.serve.bench_cluster import CLUSTER_SCENARIOS
            if args.scenario not in CLUSTER_SCENARIOS:
                p.error(f"--scenario={args.scenario} is not a "
                        "--cluster scenario (choose decode|migrate)")
            scen = set(CLUSTER_SCENARIOS[args.scenario])
        elif args.decode:
            from tosem_tpu_torch.serve.bench_decode import SCENARIO_BENCHES
            if args.scenario not in SCENARIO_BENCHES:
                p.error(f"--scenario={args.scenario} is not a "
                        "--decode scenario (choose "
                        "window|beam|spec|prefix)")
            scen = set(SCENARIO_BENCHES[args.scenario])
        else:
            p.error("--scenario requires --decode or --cluster")
        only = scen if only is None else (only & scen)
    if args.sparse:
        from tosem_tpu_torch.ops.bench_sparse import run_sparse_benchmarks
        from tosem_tpu_torch.ops.common import resolve_device
        card = resolve_device(args.device).type == "cuda"
        rows = run_sparse_benchmarks(trials=args.trials, min_s=args.min_s,
                                     quiet=args.quiet, only=only,
                                     seq=8192 if card else 256,
                                     device=args.device)
    elif args.kernels:
        from tosem_tpu_torch.ops.bench_kernels import run_kernel_benchmarks
        from tosem_tpu_torch.ops.common import resolve_device
        rows = run_kernel_benchmarks(
            trials=args.trials, min_s=args.min_s, quiet=args.quiet,
            only=only, platform=resolve_device(args.device).type)
    elif args.serve:
        from tosem_tpu_torch.serve.bench_serve import run_serve_benchmarks
        rows = run_serve_benchmarks(trials=args.trials, min_s=args.min_s,
                                    quiet=args.quiet, only=only,
                                    device=args.device)
    elif args.decode:
        from tosem_tpu_torch.serve.bench_decode import run_decode_benchmarks
        rows = run_decode_benchmarks(trials=args.trials, min_s=args.min_s,
                                     quiet=args.quiet, only=only,
                                     device=args.device)
    elif args.cluster:
        from tosem_tpu_torch.serve.bench_cluster import run_cluster_benchmarks
        rows = run_cluster_benchmarks(trials=args.trials,
                                      min_s=args.min_s,
                                      quiet=args.quiet, only=only,
                                      device=args.device)
    elif args.control:
        from tosem_tpu_torch.serve.bench_cluster import run_control_benchmarks
        rows = run_control_benchmarks(trials=args.trials,
                                      min_s=args.min_s,
                                      quiet=args.quiet, only=only)
    elif args.train:
        from tosem_tpu_torch.train.bench_train import run_train_benchmarks
        rows = run_train_benchmarks(trials=args.trials,
                                    min_s=args.min_s,
                                    quiet=args.quiet, only=only,
                                    device=args.device)
    else:
        rows = run_microbenchmarks(num_workers=args.workers,
                                   trials=args.trials,
                                   min_s=args.min_s, quiet=args.quiet,
                                   only=only)
        if args.control_plane:
            rows += run_control_plane_benchmarks(trials=args.trials,
                                                 min_s=args.min_s,
                                                 quiet=args.quiet)
    if args.save:
        # bench-noise protocol for the bimodal shared hosts: rows that
        # carry per-round minima (all serve/decode rows, the runtime
        # suite's interleaved A/B rows) record the MIN across rounds as
        # their floor, not the mean — a gate floor set off a fast-phase
        # mean fails spuriously in the slow phase
        for r in rows:
            r.value = float(r.extra.get("min", r.value))
        save_baseline(rows, args.save, num_workers=args.workers)
        print(f"baseline -> {args.save}")
    if args.check:
        ok, report = check_against_baseline(rows, args.check,
                                            threshold=args.threshold,
                                            gated=gated)
        print(f"perf gate vs {args.check} (threshold "
              f"{args.threshold:.0%}):")
        for line in report:
            print(line)
        if not ok:
            print("perf gate: FAIL")
            return 1
        print("perf gate: PASS")
    return 0


def run_control_plane_benchmarks(trials: int = 3, min_s: float = 0.5,
                                 quiet: bool = False) -> List[ResultRow]:
    """Control-plane microbenchmarks over the cross-process planes this
    framework adds around the compute path: raw RPC round trips, pub/sub
    channel publish + take, the cross-language JSON wire, and parameter
    server writes — the ray_perf-style numbers for OUR transports, so
    regressions in the runtime shell are as visible as kernel ones."""
    rows: List[ResultRow] = []
    lines: List[str] = []

    def record(bench_id, name, mean, sd, unit="ops/s"):
        _record(rows, lines, bench_id, name, mean, sd, unit)

    # --- raw RPC round trip -----------------------------------------------
    from tosem_tpu_torch.cluster.rpc import RpcClient, RpcServer
    srv = RpcServer({"echo": lambda x: x})
    cli = None
    try:
        cli = RpcClient(srv.address)

        def rpc_rt():
            for _ in range(200):
                cli.call("echo", b"x")
            return 200
        m, s = _timeit("rpc", rpc_rt, trials, min_s)
        record("rpc_round_trip", "rpc round trips", m, s)
    finally:
        if cli is not None:
            cli.close()
        srv.shutdown()

    # --- pub/sub channel ----------------------------------------------------
    from tosem_tpu_torch.cluster.channel import (ChannelBroker,
                                                 ChannelPublisher,
                                                 ChannelQos,
                                                 ChannelSubscriber)
    broker = ChannelBroker()
    pub = sub = None
    try:
        pub = ChannelPublisher(broker.address, "bench")
        sub = ChannelSubscriber(broker.address, "bench",
                                qos=ChannelQos(depth=64,
                                               reliability="best_effort"))

        def publish():
            for _ in range(200):
                pub.publish(b"frame")
            return 200
        m, s = _timeit("chan_pub", publish, trials, min_s)
        record("channel_publish", "channel publishes", m, s)

        def pub_take():
            for _ in range(50):
                pub.publish(b"frame")
                sub.take(max_n=64)
            return 50
        m, s = _timeit("chan_rt", pub_take, trials, min_s)
        record("channel_pub_take", "channel publish+take round trips",
               m, s)
    finally:
        for closer in (sub and sub.close, pub and pub.close,
                       broker.shutdown):
            if closer:
                try:
                    closer()
                except Exception:
                    pass

    # --- cross-language JSON wire -------------------------------------------
    from tosem_tpu_torch.cluster.xlang import XLangGateway, xlang_call
    gw = XLangGateway()
    gw.register("echo", lambda x: x)
    try:
        def xl():
            for _ in range(100):
                xlang_call(gw.address, "echo", 1)
            return 100
        m, s = _timeit("xlang", xl, trials, min_s)
        record("xlang_call", "xlang calls", m, s)
    finally:
        gw.close()

    # --- parameter server ---------------------------------------------------
    from tosem_tpu_torch.cluster.param import ParameterServer
    ps = ParameterServer()

    def param_set():
        for i in range(200):
            ps.set("p", i)
        return 200
    m, s = _timeit("param_set", param_set, trials, min_s)
    record("param_set", "parameter sets", m, s)

    if not quiet:
        for line in lines:
            print(line)
    return rows


if __name__ == "__main__":
    import sys
    sys.exit(main())
