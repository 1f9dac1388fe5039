"""The port's serving control plane on the CPU: micro-batching, circuit
breaker, deployments, HTTP ingress — held to the JAX package's own
serving tests and, across packages, to its metric names and its served
outputs.

Copies, against :mod:`tosem_tpu_torch.serve`, of
``tests/test_serve_batching.py`` (bucket routing, breaker logical counts,
flush policy, poison isolation, ``serve.dispatch`` chaos with a batch in
flight, stats) and of ``tests/test_serve.py``'s ``TestServeCore`` and
``TestHttpIngress``, with ``TestServeAutoscaler``'s three tests of
``Deployment.scale``/``load`` that need no autoscaler. The BERT parity
test runs the port's tiny backend on ``device="cpu"``. The speech tests
are in ``tests/test_torch_speech_serve.py``; the autoscaler and
compile-cache tests in ``test_torch_control.py``, with the control plane
and ``CompileCache``'s budget and pins. Left out: the two flush tests
whose pass rests on a wall-clock budget (``test_flush_on_size``,
``test_adaptive_idle_dispatches_immediately``; C-ref2). Replicas run in
spawned processes at ``num_workers=2``, one intra-op thread each.
"""
import json
import sys
import threading
import time
import urllib.request

import cloudpickle
import numpy as np
import pytest
import torch

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.chaos import ChaosController, Fault, FaultPlan
from tosem_tpu_torch.data.feeding import bucket_for, pad_target
from tosem_tpu_torch.serve.batching import BatchPolicy
from tosem_tpu_torch.serve.breaker import (CLOSED, OPEN, CircuitBreaker,
                                           CircuitOpen)
from tosem_tpu_torch.serve.core import Serve, ServeFuture

torch.set_num_threads(1)
# replicas get this module's backends by value, so a spawned replica need
# not import this module (and torch with it) to build one
cloudpickle.register_pickle_by_value(sys.modules[__name__])


# ---------------------------------------------------------- test backends

class BatchEcho:
    """Echoes each request back with the batch size and pad bucket it
    was served under — the observable for flush-policy assertions."""

    def call(self, request):
        return {"i": request["i"], "n": 1, "bucket": None}

    def call_batch(self, requests, pad_to=None):
        n = len(requests)
        return [{"i": r["i"], "n": n, "bucket": pad_to} for r in requests]


class PoisonAware:
    """Vectorized path refuses any batch containing a poison request;
    the per-request path fails only the poison itself."""

    def call(self, request):
        if request.get("poison"):
            raise ValueError("poison request rejected")
        return request["i"] * 10

    def call_batch(self, requests, pad_to=None):
        if any(r.get("poison") for r in requests):
            raise ValueError("poison batch rejected")
        return [r["i"] * 10 for r in requests]


class SlowBatch:
    def call(self, request):
        time.sleep(float(request.get("s", 0.3)))
        return "done"

    def call_batch(self, requests, pad_to=None):
        time.sleep(max(float(r.get("s", 0.3)) for r in requests))
        return ["done"] * len(requests)


class Echo:
    def __init__(self, tag: str = "r"):
        self.tag = tag
        self.count = 0

    def call(self, request):
        self.count += 1
        return {"echo": request, "count": self.count}


class Boom:
    def call(self, request):
        raise ValueError("bad request payload")


class Slow:
    def call(self, request):
        time.sleep(float(request.get("s", 0.3)))
        return "done"


@pytest.fixture(scope="module")
def serve():
    # spawned replicas inherit the environment: one intra-op thread each
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        own = not rt.is_initialized()
        if own:
            rt.init(num_workers=2, memory_monitor=False)
        s = Serve()
        yield s
        for name in list(s.list_deployments()):
            s.delete(name)
        if own:
            rt.shutdown()


# ------------------------------------------------------------- unit layer

class TestBucketRouting:
    def test_bucket_for_smallest_fit(self):
        assert bucket_for(3, [4, 8, 16]) == 4
        assert bucket_for(4, [4, 8, 16]) == 4
        assert bucket_for(5, [4, 8, 16]) == 8
        assert bucket_for(17, [4, 8, 16]) is None

    def test_pad_target_overlong_aligns(self):
        assert pad_target(5, [4, 8], align=1) == 8
        assert pad_target(9, [4, 8], align=1) == 9      # own shape
        assert pad_target(9, [4, 8], align=128) == 128  # tile-aligned
        assert pad_target(130, [128], align=128) == 256

    def test_policy_bucket_of(self):
        p = BatchPolicy(buckets=[4, 8],
                        length_of=lambda r: len(r["seq"]), align=1)
        assert p.bucket_of({"seq": [1, 2, 3]}) == 4
        assert p.bucket_of({"seq": list(range(7))}) == 8
        # no palette: everything shares the None bin
        assert BatchPolicy().bucket_of({"seq": [1]}) is None

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            BatchPolicy(max_batch_size=0)
        with pytest.raises(ValueError):
            BatchPolicy(batch_wait_ms=-1.0)
        with pytest.raises(ValueError):
            BatchPolicy(max_inflight_per_replica=0)

    def test_pad_ids_batch_shapes_and_overlong(self):
        from tosem_tpu_torch.models.bert import pad_ids_batch
        ids, mask, lengths = pad_ids_batch([[1, 2], [3, 4, 5]], 8,
                                           pad_batch_to=4)
        assert ids.shape == mask.shape == (4, 8)
        assert list(lengths) == [2, 3, 0, 0]
        assert mask[2, 0] == 1 and mask[3, 0] == 1   # filler rows: 1 token
        assert mask[0].sum() == 2 and mask[1].sum() == 3
        with pytest.raises(ValueError, match="exceeds"):
            pad_ids_batch([list(range(9))], 8)


@pytest.mark.parametrize("n_buckets", [1, 3, 4, 8])
@pytest.mark.parametrize("align", [1, 64, 128])
def test_feeding_rules_equal_the_reference(n_buckets, align):
    """``bucket_boundaries`` and ``pad_target`` are copies: the same
    palette and the same pad target as the JAX package's on one length
    sample."""
    from tosem_tpu.data import feeding as ref
    from tosem_tpu_torch.data import feeding as port
    lengths = [int(n) for n in
               np.random.default_rng(n_buckets).integers(1, 600, 200)]
    palette = port.bucket_boundaries(lengths, n_buckets)
    assert palette == ref.bucket_boundaries(lengths, n_buckets)
    for n in lengths + [1, max(lengths), 700, 1025]:
        assert port.pad_target(n, palette, align=align) \
            == ref.pad_target(n, palette, align=align)


class TestBreakerLogicalCounts:
    def test_batch_failure_counts_per_request(self):
        # a 16-request batch loss is 16 trips of evidence — one record
        # call with count=16 must open a threshold-16 breaker
        b = CircuitBreaker(failure_threshold=16, cooldown_s=5.0)
        b.record_failure(count=16)
        assert b.state == OPEN

    def test_count_below_threshold_stays_closed(self):
        b = CircuitBreaker(failure_threshold=17, cooldown_s=5.0)
        b.record_failure(count=16)
        assert b.state == CLOSED
        b.record_failure()            # the 17th consecutive request
        assert b.state == OPEN

    def test_count_validation(self):
        b = CircuitBreaker()
        with pytest.raises(ValueError):
            b.record_failure(count=0)


# ------------------------------------------------------ data-plane layer

class TestFlushPolicy:
    def test_flush_on_timeout(self, serve):
        pol = BatchPolicy(max_batch_size=8, batch_wait_ms=100.0,
                          adaptive=False)
        serve.deploy("flush-time", BatchEcho, num_replicas=1,
                     batch_policy=pol)
        h = serve.get_handle("flush-time")
        futs = [h.remote({"i": i}) for i in range(3)]
        outs = [f.result(timeout=60.0) for f in futs]
        assert all(o["n"] == 3 for o in outs)  # partial batch, on deadline
        assert [o["i"] for o in outs] == [0, 1, 2]
        serve.delete("flush-time")

    def test_bucket_routing_segregates_batches(self, serve):
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=150.0,
                          adaptive=False, buckets=[4, 8], align=1,
                          length_of=lambda r: len(r["seq"]))
        serve.deploy("bucketed", BatchEcho, num_replicas=1,
                     batch_policy=pol)
        h = serve.get_handle("bucketed")
        short = [h.remote({"i": i, "seq": [0] * 3}) for i in range(4)]
        longer = [h.remote({"i": 10 + i, "seq": [0] * 7})
                  for i in range(4)]
        s_out = [f.result(timeout=60.0) for f in short]
        l_out = [f.result(timeout=60.0) for f in longer]
        # each batch carried exactly its palette bucket — short and long
        # requests never shared a batch
        assert all(o["bucket"] == 4 and o["n"] == 4 for o in s_out)
        assert all(o["bucket"] == 8 and o["n"] == 4 for o in l_out)
        serve.delete("bucketed")

    def test_pinned_handle_bypasses_batching(self, serve):
        dep = serve.deploy("pinned", BatchEcho, num_replicas=1,
                           max_batch_size=4)
        f = dep.handle(pin=0).remote({"i": 7})
        assert isinstance(f, ServeFuture)      # session affinity: direct
        assert f.result(timeout=60.0)["n"] == 1
        serve.delete("pinned")

    def test_batched_future_timeout_then_result(self, serve):
        serve.deploy("slowq", SlowBatch, num_replicas=1,
                     max_batch_size=2, batch_wait_ms=5.0)
        h = serve.get_handle("slowq")
        h.call({"s": 0.01}, timeout=60.0)      # cold boot
        f = h.remote({"s": 1.0})
        with pytest.raises(TimeoutError):
            f.result(timeout=0.05)
        assert f.result(timeout=60.0) == "done"
        serve.delete("slowq")

    def test_sync_call_timeout_bounds_inline_path(self, serve):
        # the idle-queue sync fast path completes inline on the caller
        # thread: the caller's timeout must still bound the wait. A call
        # that waited out the 30s request would return "done", so the
        # TimeoutError alone shows the bound (no wall-clock assertion)
        serve.deploy("synct", SlowBatch, num_replicas=1,
                     max_batch_size=4, batch_wait_ms=5.0, max_retries=0)
        h = serve.get_handle("synct")
        h.call({"s": 0.01}, timeout=60.0)      # cold boot
        with pytest.raises(TimeoutError):
            h.call({"s": 30.0}, timeout=0.4)
        serve.delete("synct")

    def test_queued_deadline_sheds_typed_at_flush(self, serve):
        # a request whose budget expired while it queued behind a slow
        # batch is shed typed at dispatch — its batchmates ride the
        # batch untouched, and the shed never reaches the replica
        from tosem_tpu_torch.runtime.common import DeadlineExceeded
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=5.0,
                          max_inflight_per_replica=1)
        dep = serve.deploy("dlq", SlowBatch, num_replicas=1,
                           batch_policy=pol, max_retries=0)
        h = serve.get_handle("dlq")
        h.call({"s": 0.01}, timeout=60.0)      # cold boot
        blocker = h.remote({"s": 0.8})         # occupies the replica
        time.sleep(0.1)                        # ...and is in flight
        healthy = [h.remote({"s": 0.01}) for _ in range(3)]
        doomed = dep._queue.submit({"s": 0.01}, timeout=0.05)
        assert blocker.result(timeout=60.0) == "done"
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=60.0)
        assert all(f.result(timeout=60.0) == "done" for f in healthy)
        serve.delete("dlq")

    def test_queued_deadline_not_expired_rides_batch(self, serve):
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=5.0,
                          max_inflight_per_replica=1)
        dep = serve.deploy("dlq2", SlowBatch, num_replicas=1,
                           batch_policy=pol)
        h = serve.get_handle("dlq2")
        h.call({"s": 0.01}, timeout=60.0)      # cold boot
        blocker = h.remote({"s": 0.3})
        time.sleep(0.05)
        f = dep._queue.submit({"s": 0.01}, timeout=30.0)
        assert blocker.result(timeout=60.0) == "done"
        assert f.result(timeout=60.0) == "done"
        serve.delete("dlq2")

    def test_delete_fails_queued_requests(self, serve):
        pol = BatchPolicy(max_batch_size=1, batch_wait_ms=1.0,
                          max_inflight_per_replica=1)
        serve.deploy("doomedq", SlowBatch, num_replicas=1,
                     batch_policy=pol)
        h = serve.get_handle("doomedq")
        h.call({"s": 0.01}, timeout=60.0)      # cold boot
        futs = [h.remote({"s": 0.5}) for _ in range(4)]  # 1 flying, 3 queued
        time.sleep(0.1)
        serve.delete("doomedq")
        errs = 0
        for f in futs:
            try:
                f.result(timeout=60.0)
            except Exception:
                errs += 1
        assert errs >= 3                       # every queued request failed
        with pytest.raises(Exception, match="closed|deleted"):
            h.remote({"s": 0.1})


class TestPoisonIsolation:
    def test_poison_fails_only_its_future(self, serve):
        breaker = CircuitBreaker(failure_threshold=4, cooldown_s=5.0)
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=150.0,
                          adaptive=False)
        dep = serve.deploy("poison", PoisonAware, num_replicas=1,
                           batch_policy=pol, circuit_breaker=breaker)
        h = serve.get_handle("poison")
        reqs = [{"i": 0}, {"i": 1}, {"i": 2, "poison": True}, {"i": 3}]
        futs = [h.remote(r) for r in reqs]
        assert futs[0].result(timeout=60.0) == 0
        assert futs[1].result(timeout=60.0) == 10
        with pytest.raises(rt.TaskError, match="poison"):
            futs[2].result(timeout=60.0)
        assert futs[3].result(timeout=60.0) == 30
        # one poison request is ONE failure — far from tripping the
        # breaker, and the queue's per-request ledger shows 3/1
        assert breaker.state == CLOSED
        st = dep._queue.stats()
        assert st["requests_ok"] == 3 and st["requests_err"] == 1
        serve.delete("poison")


class TestChaosBatchInFlight:
    def test_batch_transport_failure_isolated_and_recovers(self, serve):
        """serve.dispatch crash while a batch is in flight: with retries
        exhausted, only THAT batch's futures error; the breaker counts
        one trip per logical request and later batches (restarted
        replica) succeed, closing the ledger."""
        breaker = CircuitBreaker(failure_threshold=50, cooldown_s=0.5)
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=150.0,
                          adaptive=False)
        serve.deploy("chaosb", BatchEcho, num_replicas=1, max_restarts=2,
                     max_retries=0, batch_policy=pol,
                     circuit_breaker=breaker)
        h = serve.get_handle("chaosb")
        plan = FaultPlan(seed=5, faults=[
            Fault(site="serve.dispatch", action="crash_replica", at=1)])
        with ChaosController(plan) as chaos:
            futs = [h.remote({"i": i}) for i in range(4)]
            for f in futs:
                with pytest.raises((rt.ActorDiedError,
                                    rt.WorkerCrashedError)):
                    f.result(timeout=60.0)
            assert chaos.injections("serve.dispatch")
        assert breaker._consecutive_failures == 4   # 4 trips, 1 dispatch
        assert breaker.state == CLOSED              # 4 < 50
        futs = [h.remote({"i": i}) for i in range(4)]
        outs = [f.result(timeout=60.0) for f in futs]
        assert [o["i"] for o in outs] == [0, 1, 2, 3]
        assert breaker._consecutive_failures == 0
        serve.delete("chaosb")

    def test_one_batch_loss_opens_request_threshold_breaker(self, serve):
        breaker = CircuitBreaker(failure_threshold=4, cooldown_s=30.0)
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=150.0,
                          adaptive=False)
        serve.deploy("chaost", BatchEcho, num_replicas=1, max_restarts=2,
                     max_retries=0, batch_policy=pol,
                     circuit_breaker=breaker)
        h = serve.get_handle("chaost")
        plan = FaultPlan(seed=6, faults=[
            Fault(site="serve.dispatch", action="crash_replica", at=1)])
        with ChaosController(plan):
            futs = [h.remote({"i": i}) for i in range(4)]
            for f in futs:
                with pytest.raises((rt.ActorDiedError,
                                    rt.WorkerCrashedError)):
                    f.result(timeout=60.0)
        assert breaker.state == OPEN
        with pytest.raises(CircuitOpen):
            h.remote({"i": 9})
        serve.delete("chaost")

    def test_batch_retry_absorbs_crash(self, serve):
        breaker = CircuitBreaker(failure_threshold=50, cooldown_s=5.0)
        pol = BatchPolicy(max_batch_size=4, batch_wait_ms=150.0,
                          adaptive=False)
        serve.deploy("chaosr", BatchEcho, num_replicas=2, max_restarts=2,
                     max_retries=3, batch_policy=pol,
                     circuit_breaker=breaker)
        h = serve.get_handle("chaosr")
        plan = FaultPlan(seed=7, faults=[
            Fault(site="serve.dispatch", action="crash_replica", at=1)])
        with ChaosController(plan) as chaos:
            futs = [h.remote({"i": i}) for i in range(4)]
            outs = [f.result(timeout=120.0) for f in futs]
            assert chaos.injections("serve.dispatch")
        assert [o["i"] for o in outs] == [0, 1, 2, 3]
        assert all(o["n"] == 4 for o in outs)
        assert breaker.state == CLOSED
        assert breaker._consecutive_failures == 0
        serve.delete("chaosr")


# ------------------------------------------------------ model parity layer

class TestModelBackendParity:
    def test_bert_batched_vs_sequential_bitexact_and_flash(self, serve):
        """Batched and sequential BERT responses are bit-exact, deploy
        builds the bucket's step callable before any request, and the
        replica's dispatch tally shows the padded batches took the flash
        path (the dense count stays 0)."""
        from tosem_tpu_torch.serve.backends import BertEncodeBackend
        kw = {"max_len": 128, "max_batch": 4, "seed": 3, "device": "cpu"}
        dep = serve.deploy("bert", BertEncodeBackend, num_replicas=1,
                           init_kwargs=kw, max_batch_size=4,
                           batch_wait_ms=150.0, buckets=[128],
                           length_of=BertEncodeBackend.length_of,
                           warmup_shapes=[128])
        st = rt.get(dep._replicas[0].stats.remote(), timeout=120.0)
        assert st["compile_cache"]["entries"] >= 1
        reqs = [{"ids": list(range(1, 2 + 7 * (i + 1)))} for i in range(4)]
        h = serve.get_handle("bert")
        futs = [h.remote(r) for r in reqs]
        batched = [f.result(timeout=300.0) for f in futs]
        local = BertEncodeBackend(**kw)
        sequential = [local.call(r) for r in reqs]
        for b, s, r in zip(batched, sequential, reqs):
            assert b["len"] == s["len"] == len(r["ids"])
            assert np.array_equal(b["pooled"], s["pooled"])   # bit-exact
        st = rt.get(dep._replicas[0].stats.remote(), timeout=60.0)
        disp = st["flash_dispatch"]
        assert disp["flash"] >= 1 and disp.get("dense", 0) == 0
        assert st["compile_cache"]["hits"] >= 1   # calls reused the step
        serve.delete("bert")

    def test_bert_backend_rejects_poison_inputs(self):
        from tosem_tpu_torch.serve.backends import BertEncodeBackend
        b = BertEncodeBackend(max_len=128, max_batch=4, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            b.call_batch([{"ids": [999]}], pad_to=128)
        with pytest.raises(ValueError, match="out of range"):
            b.call_batch([{"ids": [-1]}], pad_to=128)
        with pytest.raises(ValueError, match="empty"):
            b.call_batch([{"ids": []}], pad_to=128)


class TestStatsSurface:
    def test_serve_stats_and_http_endpoint(self, serve):
        from tosem_tpu_torch.serve import HttpIngress
        serve.deploy("statd", BatchEcho, num_replicas=1,
                     max_batch_size=4, batch_wait_ms=5.0)
        h = serve.get_handle("statd")
        h.call({"i": 0}, timeout=60.0)
        st = serve.stats()["statd"]
        assert st["batched"] is True
        assert st["max_batch_size"] == 4
        assert st["requests_ok"] >= 1
        ingress = HttpIngress(serve)
        try:
            with urllib.request.urlopen(f"{ingress.url}/-/stats",
                                        timeout=30) as r:
                body = json.loads(r.read())
            assert body["deployments"]["statd"]["batched"] is True
            assert "train" not in body       # no training job is live
        finally:
            ingress.shutdown()
        serve.delete("statd")

    def test_batch_metrics_registered(self, serve):
        from tosem_tpu_torch.obs.metrics import DEFAULT
        serve.deploy("metd", BatchEcho, num_replicas=1,
                     max_batch_size=4, batch_wait_ms=5.0)
        h = serve.get_handle("metd")
        h.call({"i": 0}, timeout=60.0)
        assert DEFAULT.get("serve_queue_depth") is not None
        assert DEFAULT.get("serve_batch_wait_ms") is not None
        assert DEFAULT.get("serve_requests_total").value(
            ("metd", "ok")) >= 1
        serve.delete("metd")


# --------------------------------------------- deployments (test_serve.py)

class TestServeCore:
    def test_deploy_and_call(self, serve):
        serve.deploy("echo", Echo, num_replicas=2)
        h = serve.get_handle("echo")
        out = h.call({"x": 1}, timeout=60)
        assert out["echo"] == {"x": 1}

    def test_concurrent_requests_spread_over_replicas(self, serve):
        h = serve.get_handle("echo")
        results, errors = [], []

        def worker(i):
            try:
                results.append(h.call({"i": i}, timeout=60))
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert not errors and len(results) == 16

    def test_backend_exception_propagates(self, serve):
        serve.deploy("boom", Boom)
        h = serve.get_handle("boom")
        with pytest.raises(Exception):
            h.call({}, timeout=60)

    def test_replica_kill_midflight_recovers(self, serve):
        from tosem_tpu_torch.runtime import api as rt_api
        serve.deploy("echo2", Echo, num_replicas=2, max_restarts=2)
        dep = serve._deployments["echo2"]
        h = serve.get_handle("echo2")
        assert h.call({"warm": 1}, timeout=60)
        results, errors = [], []

        def client(i):
            try:
                results.append(h.call({"i": i}, timeout=60))
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        [t.start() for t in threads]
        # crash one replica process mid-flight: the restart policy must
        # bring it back, retries cover the gap
        actor_id = dep._replicas[0]._actor_id
        rec = rt_api._runtime.actors[actor_id]
        rec.worker.proc.kill()
        [t.join() for t in threads]
        assert not errors, errors
        assert len(results) == 12

    def test_scale_up_down(self, serve):
        serve.deploy("echo3", Echo, num_replicas=1)
        dep = serve._deployments["echo3"]
        dep.scale(3)
        assert len(dep._replicas) == 3
        h = serve.get_handle("echo3")
        assert h.call({"a": 1}, timeout=60)
        dep.scale(1)
        assert len(dep._replicas) == 1
        assert h.call({"b": 2}, timeout=60)


class TestDeploymentScale:
    """``TestServeAutoscaler``'s tests of ``Deployment.scale`` and
    ``load`` that run without the autoscaler (ROADMAP.md A11)."""

    def test_scale_after_delete_is_noop(self, serve):
        from tosem_tpu_torch.runtime import ActorDiedError
        dep = serve.deploy("gone", Echo, num_replicas=1)
        h = serve.get_handle("gone")
        serve.delete("gone")
        dep.scale(3)                 # late scale: must not resurrect
        assert dep.num_replicas == 0
        with pytest.raises(ActorDiedError, match="no replicas"):
            h.remote({"x": 1})

    def test_scale_down_retires_idle_replica_first(self, serve):
        dep = serve.deploy("busy", Slow, num_replicas=2)
        pinned = dep.handle(pin=0)
        f = pinned.remote({"s": 1.5})
        time.sleep(0.2)
        busy_replica = dep._replicas[0]
        dep.scale(1)                 # must retire the IDLE replica 1
        assert dep.num_replicas == 1
        assert dep._replicas[0] is busy_replica
        assert f.result(timeout=60) == "done"   # in-flight unharmed
        serve.delete("busy")

    def test_load_prunes_completed(self, serve):
        dep = serve.deploy("quick", Echo, num_replicas=1)
        h = serve.get_handle("quick")
        futs = [h.remote(i) for i in range(5)]
        for f in futs:
            f.result(timeout=10)
        assert dep.load() == 0
        serve.delete("quick")


class TestHttpIngress:
    def test_post_roundtrip_and_errors(self, serve):
        from tosem_tpu_torch.serve import HttpIngress
        serve.deploy("echo-http", Echo, num_replicas=1)
        ingress = HttpIngress(serve)
        try:
            req = urllib.request.Request(
                f"{ingress.url}/echo-http",
                data=json.dumps({"q": 7}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.loads(r.read())
            assert body["result"]["echo"] == {"q": 7}

            with urllib.request.urlopen(f"{ingress.url}/-/routes",
                                        timeout=30) as r:
                assert "echo-http" in json.loads(r.read())["routes"]

            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    f"{ingress.url}/nosuch", data=b"{}"), timeout=30)
            assert ei.value.code == 404
        finally:
            ingress.shutdown()
        serve.delete("echo-http")


# ----------------------------------------------------------- across packages

def _registry_shape(metrics_mod):
    """(kind, name, help, labels, buckets) of every instrument set the
    metrics module defines, each built into a fresh registry."""
    out = {}
    for factory in ("serve_metrics", "cluster_serve_metrics",
                    "control_plane_metrics", "train_metrics"):
        for key, m in getattr(metrics_mod, factory)(
                metrics_mod.Registry()).items():
            out[(factory, key)] = (type(m).__name__, m.name, m.description,
                                   m.label_names,
                                   getattr(m, "buckets", None))
    return out


def test_metric_names_types_and_labels_equal_the_reference():
    from tosem_tpu.obs import metrics as ref
    from tosem_tpu_torch.obs import metrics as port
    assert _registry_shape(port) == _registry_shape(ref)


def test_runtime_and_memory_metrics_equal_the_reference():
    import tosem_tpu.runtime.runtime as ref_rt
    import tosem_tpu_torch.runtime.runtime as port_rt
    from tosem_tpu.obs import memory_monitor as ref_mm
    from tosem_tpu.obs import metrics as ref_metrics
    from tosem_tpu_torch.obs import memory_monitor as port_mm
    from tosem_tpu_torch.obs import metrics as port_metrics

    def shape(m):
        return (type(m).__name__, m.name, m.description, m.label_names)

    names = sorted(n for n in vars(ref_rt) if n.startswith("M_"))
    assert names == sorted(n for n in vars(port_rt) if n.startswith("M_"))
    for n in names:
        assert shape(getattr(port_rt, n)) == shape(getattr(ref_rt, n))
    ref_mm.MemoryMonitor()
    port_mm.MemoryMonitor()
    for n in ("process_rss_bytes", "host_available_bytes",
              "objstore_used_bytes", "objstore_capacity_bytes"):
        assert shape(port_metrics.DEFAULT.get(n)) \
            == shape(ref_metrics.DEFAULT.get(n))


ENCODE_BATCHING = dict(max_batch_size=4, batch_wait_ms=150.0, buckets=[128],
                       length_of=lambda r: len(r["ids"]),
                       warmup_shapes=[128])


@pytest.fixture(scope="module")
def jax_encode():
    """The JAX package's tiny encoder, micro-batched behind its own
    ``Serve`` on its own runtime, and its weights as numpy arrays."""
    import jax
    import tosem_tpu.runtime as jrt
    from tosem_tpu.serve.backends import BertEncodeBackend as JEnc
    from tosem_tpu.serve.core import Serve as JServe
    params = jax.tree_util.tree_map(
        np.asarray, JEnc(max_batch=4)._vs["params"])
    own = not jrt.is_initialized()
    if own:
        jrt.init(num_workers=1, memory_monitor=False)
    jserve = JServe()
    jserve.deploy("enc-ref", JEnc, init_kwargs={"max_batch": 4},
                  **ENCODE_BATCHING)
    yield jserve, params
    jserve.delete("enc-ref")
    if own:
        jrt.shutdown()


def test_served_encode_matches_the_reference_served_encode(serve,
                                                           jax_encode):
    """One micro-batched encode deployment in each package, the port's
    carrying the JAX package's tiny weights through ``init_kwargs``
    (``models/convert.py`` loads them in the replica): every pooled
    output within ``TOLERANCES["flash"]["bfloat16"]``."""
    from tosem_tpu.ops.parity import TOLERANCES
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    jserve, params = jax_encode
    rng = np.random.default_rng(11)
    reqs = [{"ids": [int(t) for t in rng.integers(0, 128, size=n)]}
            for n in (5, 33, 60, 127)]
    h = jserve.get_handle("enc-ref")
    want = [f.result(timeout=300.0) for f in [h.remote(r) for r in reqs]]
    serve.deploy("enc-port", BertEncodeBackend,
                 init_kwargs={"max_batch": 4, "device": "cpu",
                              "params": params},
                 **ENCODE_BATCHING)
    h = serve.get_handle("enc-port")
    got = [f.result(timeout=300.0) for f in [h.remote(r) for r in reqs]]
    serve.delete("enc-port")
    tol = TOLERANCES["flash"]["bfloat16"]
    for w, g in zip(want, got):
        assert g["len"] == w["len"]
        assert np.abs(g["pooled"] - w["pooled"]).max() <= tol


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=120)
    return ei.value.code, json.loads(ei.value.read())


def test_encode_over_http_answers_500_in_both_packages(serve, jax_encode):
    """C-ref5: the ingress ``json.dumps`` a backend's result, and the
    encode backend returns numpy arrays, so an encode POST answers 500
    ``TypeError`` in the JAX package; the port copies the quirk as it
    is, and a handle still serves the request."""
    from tosem_tpu.serve.http import HttpIngress as JIngress
    from tosem_tpu_torch.serve import BertEncodeBackend, HttpIngress
    jserve, _ = jax_encode
    ingress = JIngress(jserve)
    try:
        ref_code, ref_body = _post(f"{ingress.url}/enc-ref",
                                   {"ids": [5, 6, 7]})
    finally:
        ingress.shutdown()
    serve.deploy("enc-http", BertEncodeBackend,
                 init_kwargs={"max_batch": 4, "device": "cpu"},
                 **ENCODE_BATCHING)
    ingress = HttpIngress(serve)
    try:
        code, body = _post(f"{ingress.url}/enc-http", {"ids": [5, 6, 7]})
    finally:
        ingress.shutdown()
    out = serve.get_handle("enc-http").call({"ids": [5, 6, 7]}, timeout=120)
    serve.delete("enc-http")
    assert ref_code == code == 500
    assert ref_body["error"].startswith("TypeError")
    assert body["error"].startswith("TypeError")
    assert "not JSON serializable" in body["error"]
    assert out["len"] == 3 and out["pooled"].shape == (32,)


def test_ingress_listen_backlog_is_the_reference_s(serve):
    """C-ref6: both ingresses listen with ``socketserver``'s default
    backlog of 5, so a burst of more concurrent connects than that can
    lose a SYN and wait out the client's retransmit; the port copies the
    server as it is."""
    from tosem_tpu.serve.http import HttpIngress as JIngress
    from tosem_tpu_torch.serve import HttpIngress
    ref, port = JIngress(serve), HttpIngress(serve)
    try:
        assert type(port._server) is type(ref._server)
        assert port._server.request_queue_size \
            == ref._server.request_queue_size == 5
    finally:
        ref.shutdown()
        port.shutdown()
