"""The port's serve-layer hardening: ``tests/test_chaos_serve.py`` run
against :mod:`tosem_tpu_torch.serve` — the circuit breaker (closed /
open / half-open), retry backoff and chaos replica faults, and the
``serve-flap`` plan through the port's runner (``slow``, as in the JAX
package). None of these tests has a copy elsewhere:
``tests/test_torch_serve_control.py``'s breaker tests
(``TestBreakerLogicalCounts`` at :181 and the batch-loss breaker at :376)
are copies of ``tests/test_serve_batching.py``'s, other tests.

With them, the runner-driven serving tests that the JAX package keeps in
other files: ``tests/test_decode_serve.py``'s
``test_decode_chaos_canned_plan_survives`` and ``tests/test_control.py``'s
``test_scale_under_kill_plan_survives`` (``slow`` there and here).
``tests/test_kv_migration.py``'s ``decode-migrate`` plan runs in
``tests/test_torch_kv_transport.py``. Replicas run in spawned processes;
the backends here ship to them by value.
"""
import sys
import time

import cloudpickle
import pytest

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.chaos import (CANNED_PLANS, ChaosController, Fault,
                                   FaultPlan)
from tosem_tpu_torch.chaos.runner import run_plan
from tosem_tpu_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                           CircuitBreaker, CircuitOpen)
from tosem_tpu_torch.serve.core import Serve

# a spawned replica gets this module's backend by value, so it need not
# import the test module
cloudpickle.register_pickle_by_value(sys.modules[__name__])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestCircuitBreakerUnit:
    def test_opens_after_threshold_and_recovers_half_open(self):
        clk = FakeClock()
        b = CircuitBreaker(failure_threshold=3, cooldown_s=5.0, clock=clk)
        for _ in range(3):
            assert b.allow() is False        # closed: not a probe
            b.record_failure()
        assert b.state == OPEN
        with pytest.raises(CircuitOpen):
            b.allow()
        clk.t = 4.9
        with pytest.raises(CircuitOpen):     # cool-down not elapsed
            b.allow()
        clk.t = 5.0
        assert b.allow() is True             # the half-open probe
        assert b.state == HALF_OPEN
        with pytest.raises(CircuitOpen):     # only ONE probe at a time
            b.allow()
        b.record_success(probe=True)
        assert b.state == CLOSED
        b.allow()                            # closed again: free flow

    def test_half_open_failure_reopens(self):
        clk = FakeClock()
        b = CircuitBreaker(failure_threshold=1, cooldown_s=2.0, clock=clk)
        b.allow()
        b.record_failure()
        assert b.state == OPEN
        clk.t = 2.0
        assert b.allow() is True
        b.record_failure(probe=True)         # probe failed
        assert b.state == OPEN
        with pytest.raises(CircuitOpen):     # cool-down restarted
            b.allow()
        clk.t = 3.9
        with pytest.raises(CircuitOpen):
            b.allow()
        clk.t = 4.0
        assert b.allow() is True
        b.record_success(probe=True)
        assert b.state == CLOSED

    def test_success_resets_consecutive_count(self):
        b = CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
        b.allow(); b.record_failure()
        b.allow(); b.record_success()
        b.allow(); b.record_failure()        # 1 consecutive, not 2
        assert b.state == CLOSED

    def test_validation(self):
        with pytest.raises(ValueError):
            CircuitBreaker(failure_threshold=0)
        with pytest.raises(ValueError):
            CircuitBreaker(cooldown_s=-1.0)

    def test_released_probe_does_not_wedge_half_open(self):
        """An admitted probe abandoned without a verdict (caller timed
        out) must free the slot: the breaker returns to OPEN and the
        next allow() admits a fresh probe."""
        clk = FakeClock()
        b = CircuitBreaker(failure_threshold=1, cooldown_s=1.0, clock=clk)
        b.allow(); b.record_failure()
        clk.t = 1.0
        assert b.allow() is True             # probe admitted
        assert b.state == HALF_OPEN
        b.release_probe()                    # verdict unknown
        assert b.state == OPEN
        assert b.allow() is True             # fresh probe, immediately
        b.record_success(probe=True)
        assert b.state == CLOSED
        b.release_probe()                    # no probe held: no-op

    def test_probe_failure_after_concurrent_close_counts_normally(self):
        """If a stale success already closed the breaker while the
        probe was out, the probe's failure is just one ordinary
        failure — it must not re-open a breaker whose backend is
        demonstrably serving (threshold applies again)."""
        clk = FakeClock()
        b = CircuitBreaker(failure_threshold=5, cooldown_s=1.0, clock=clk)
        for _ in range(5):
            b.allow(); b.record_failure()
        assert b.state == OPEN
        clk.t = 1.0
        assert b.allow() is True             # probe admitted
        b.record_success(probe=False)        # stale request lands OK
        assert b.state == CLOSED
        b.record_failure(probe=True)         # the probe itself fails
        assert b.state == CLOSED             # 1 < threshold: stays closed

    def test_stale_nonprobe_failure_cannot_steal_probe_verdict(self):
        """A request admitted while CLOSED that fails late — during
        someone else's half-open probe — must neither restart the
        cool-down nor free the probe slot."""
        clk = FakeClock()
        b = CircuitBreaker(failure_threshold=2, cooldown_s=1.0, clock=clk)
        stale_probe = b.allow()              # False: admitted while closed
        b.allow(); b.record_failure()
        b.allow(); b.record_failure()        # breaker opens
        assert b.state == OPEN
        clk.t = 1.0
        assert b.allow() is True             # the real probe
        b.record_failure(probe=stale_probe)  # stale request fails late
        assert b.state == HALF_OPEN          # probe verdict still pending
        b.record_success(probe=True)         # the actual probe succeeds
        assert b.state == CLOSED


class FailNThenEcho:
    """Backend that raises for its first ``n`` calls, then echoes —
    the consecutive-failure shape that must open and then re-close the
    deployment's breaker."""

    def __init__(self, n):
        self.left = n

    def call(self, request):
        if self.left > 0:
            self.left -= 1
            raise RuntimeError("induced backend failure")
        return {"echo": request}


@pytest.fixture
def runtime():
    r = rt.init(num_workers=2, memory_monitor=False)
    yield r
    rt.shutdown()


class TestBreakerIntegration:
    def test_breaker_opens_rejects_fast_and_recovers(self, runtime):
        """Acceptance criterion: N consecutive replica failures open the
        breaker, callers are rejected fast with CircuitOpen, and the
        deployment recovers through half-open after the cool-down."""
        serve = Serve()
        breaker = CircuitBreaker(failure_threshold=3, cooldown_s=1.0)
        serve.deploy("flaky", FailNThenEcho, num_replicas=1,
                     init_args=(3,), circuit_breaker=breaker,
                     max_retries=0)
        h = serve.get_handle("flaky")
        for _ in range(3):                   # application errors: counted
            with pytest.raises(rt.TaskError):
                h.call({"x": 1}, timeout=30.0)
        assert breaker.state == OPEN
        t0 = time.monotonic()
        with pytest.raises(CircuitOpen):
            h.call({"x": 1}, timeout=30.0)
        assert time.monotonic() - t0 < 0.5   # rejected without dispatch
        time.sleep(1.1)                      # cool-down elapses
        # half-open probe goes through; backend now healthy → closes
        assert h.call({"x": 2}, timeout=30.0) == {"echo": {"x": 2}}
        assert breaker.state == CLOSED
        assert h.call({"x": 3}, timeout=30.0) == {"echo": {"x": 3}}

    def test_failed_dispatch_releases_probe(self, runtime):
        """A dispatch that raises (deployment deleted between requests)
        must release an acquired half-open probe slot — otherwise the
        shared breaker wedges in 'probe in flight' forever."""
        serve = Serve()
        breaker = CircuitBreaker(failure_threshold=1, cooldown_s=0.1)
        dep = serve.deploy("doomed", FailNThenEcho, num_replicas=1,
                           init_args=(0,), circuit_breaker=breaker,
                           max_retries=0)
        h = serve.get_handle("doomed")
        assert h.call({"a": 1}, timeout=30.0) == {"echo": {"a": 1}}
        breaker.allow(); breaker.record_failure()     # force it OPEN
        assert breaker.state == OPEN
        serve.delete("doomed")                        # no replicas left
        time.sleep(0.15)                              # cool-down elapses
        with pytest.raises(rt.ActorDiedError):        # probe dispatch dies
            h.call({"a": 2}, timeout=30.0)
        # the probe slot was released: a fresh probe is admitted (and
        # fails on dispatch again) instead of CircuitOpen('probe in
        # flight') wedging every future request
        with pytest.raises(rt.ActorDiedError):
            h.call({"a": 3}, timeout=30.0)

    def test_deadline_error_reachable_from_runtime_namespace(self):
        assert rt.DeadlineExceeded is not None        # rt.* idiom works

    def test_replica_crash_retry_with_backoff(self, runtime):
        """A chaos-crashed replica is absorbed by retry+backoff; the
        breaker stays closed (failures below threshold)."""
        plan = FaultPlan(seed=2, faults=[
            Fault(site="serve.dispatch", action="crash_replica", at=1)])
        serve = Serve()
        breaker = CircuitBreaker(failure_threshold=5, cooldown_s=5.0)
        serve.deploy("echo", FailNThenEcho, num_replicas=2,
                     init_args=(0,), circuit_breaker=breaker)
        h = serve.get_handle("echo")
        with ChaosController(plan) as chaos:
            assert h.call({"i": 0}, timeout=60.0) == {"echo": {"i": 0}}
            assert chaos.injections("serve.dispatch")
        assert breaker.state == CLOSED


@pytest.mark.slow
class TestServeFlapPlan:
    def test_canned_plan_survives(self):
        rep = run_plan(CANNED_PLANS["serve-flap"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["requests_ok"] == 12


# ------------------------------------- runner plans from other files


def test_decode_chaos_canned_plan_survives(monkeypatch):
    """The acceptance run: evict KV pages + kill the replica
    mid-decode; every sequence completes with fault-free tokens and
    zero surfaced errors."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rep = run_plan(CANNED_PLANS["decode-chaos"], device="cpu")
    assert rep.ok, rep.render()
    assert rep.counts["errors_surfaced"] == 0
    assert rep.counts["sequences_correct"] == rep.counts["sequences"]
    assert len(rep.injections) == 2


@pytest.mark.slow
def test_scale_under_kill_plan_survives():
    rep = run_plan(CANNED_PLANS["scale-under-kill"], device="cpu")
    assert rep.ok, rep.render()
    assert rep.counts["errors_untyped"] == 0
    assert rep.counts["replicas_on_dead_nodes"] == 0
