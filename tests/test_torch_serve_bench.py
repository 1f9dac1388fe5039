"""The port's serving bench harness (``tosem_tpu_torch/serve/bench_common.py``,
``serve/bench_serve.py``): the closed- and paired-loop fleets, per-unit
percentiles and the suite emitter, each against the JAX package's copy
on the same inputs; ``VectorWorkBackend`` against the reference's; and
one cheap leg of ``run_serve_benchmarks`` through the port's runtime on
the CPU (no wall-clock bound is asserted: C-ref2)."""
import threading

import numpy as np
import pytest

from tosem_tpu_torch.serve import bench_common
from tosem_tpu_torch.serve.bench_serve import VectorWorkBackend


def test_per_unit_percentiles_equal_the_reference():
    from tosem_tpu.serve import bench_common as ref
    rng = np.random.default_rng(3)
    samples = [(float(rng.random()), float(rng.integers(0, 40)))
               for _ in range(101)]
    for pcts in ((50, 99), (10, 50, 90, 100)):
        assert bench_common.per_unit_percentiles(samples, pcts) == \
            ref.per_unit_percentiles(samples, pcts)
    assert all(np.isnan(v) for v in bench_common.per_unit_percentiles([]))


@pytest.mark.parametrize("lower", [False, True])
def test_suite_emitter_rows_equal_the_reference(lower):
    from tosem_tpu.serve import bench_common as ref
    vals = [3.0, 1.5, 2.25]
    got_em = bench_common.SuiteEmitter("serve", only={"a", "b"})
    want_em = ref.SuiteEmitter("serve", only={"a", "b"})
    for em in (got_em, want_em):
        em.emit("a", "serve leg a", vals, lower_is_better=lower)
        assert em.emit("c", "filtered out", vals) is None
        assert em.emit("b", "empty", []) is None
    (got,), (want,) = got_em.rows, want_em.rows
    fields = ("project", "config", "bench_id", "metric", "value", "unit",
              "device", "n_devices", "extra")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.extra["min"] == (3.0 if lower else 1.5)
    assert got_em.lines == want_em.lines
    assert got_em.flush(quiet=True) == got_em.rows


class _Clock:
    """``time`` for the fleets, no wall clock (C-ref2): ``perf_counter``
    reads 0.0 until every one of ``clients`` client threads has made a
    call, then 10.0, so each client calls at least once and the window
    the fleet divides by is 10 s whatever the host's load."""

    def __init__(self, clients):
        self.clients = clients
        self.seen = set()
        self.lock = threading.Lock()

    def arrive(self):
        with self.lock:
            self.seen.add(threading.get_ident())

    def perf_counter(self):
        with self.lock:
            return 10.0 if len(self.seen) >= self.clients else 0.0


@pytest.fixture
def clock(monkeypatch):
    def install(clients):
        c = _Clock(clients)
        monkeypatch.setattr(bench_common, "time", c)
        return c
    return install


def test_closed_loop_counts_units_and_collects_samples(clock):
    clk = clock(3)
    seen = []

    def call(req, timeout):
        clk.arrive()
        with clk.lock:
            seen.append(req)
        return {"n": 2}
    samples = []
    rate = bench_common.closed_loop(call, 3, 0.05, lambda i, k: (i, k),
                                    count_of=lambda out: out["n"],
                                    samples=samples)
    assert rate == 2 * len(seen) / 10.0
    assert len(samples) == len(seen) and all(u == 2 for _, u in samples)
    # every client called, each walking its own iteration counter from 0
    for i in range(3):
        ks = [k for c, k in seen if c == i]
        assert ks and ks == list(range(len(ks)))


def test_closed_loop_reraises_the_first_client_error(clock):
    clk = clock(2)

    def call(req, timeout):
        clk.arrive()
        raise ValueError("backend down")
    with pytest.raises(ValueError, match="backend down"):
        bench_common.closed_loop(call, 2, 0.05, lambda i, k: None)


def test_paired_loop_runs_both_arms_over_one_window(clock):
    clk = clock(4)
    calls = {"a": 0, "b": 0}

    def arm(name):
        def call(req, timeout):
            clk.arrive()
            with clk.lock:
                calls[name] += 1
        return call
    ra, rb = bench_common.paired_loop(arm("a"), arm("b"), 2, 0.05,
                                      lambda i, k: None)
    assert calls["a"] >= 2 and calls["b"] >= 2
    assert (ra, rb) == (calls["a"] / 10.0, calls["b"] / 10.0)


def test_vector_work_backend_equals_the_reference():
    from tosem_tpu.serve.bench_serve import VectorWorkBackend as Ref
    got, want = VectorWorkBackend(n=64), Ref(n=64)
    reqs = [{"x": i} for i in range(5)]
    assert [got.call(r) for r in reqs] == [want.call(r) for r in reqs]
    assert got.call_batch(reqs) == want.call_batch(reqs)


def test_serve_bench_leg_emits_its_row():
    """The single-client closed-loop leg through ``Serve`` on the port's
    runtime; its rows carry the suite, the rounds and their floor."""
    from tosem_tpu_torch.serve.bench_serve import run_serve_benchmarks
    rows = run_serve_benchmarks(trials=1, min_s=0.1, quiet=True,
                                only={"serve_single_closed_loop"},
                                skip_warm=True, device="cpu")
    assert [r.bench_id for r in rows] == ["serve_single_closed_loop"]
    row = rows[0]
    assert row.value > 0 and row.unit == "ops/s" and row.device == "cpu"
    assert row.extra["suite"] == "serve"
    assert row.extra["min"] == round(row.extra["rounds"][0], 4)
