"""Continuous-batching decode through the port's control plane on the
CPU: ``Serve`` → ``DecodeQueue`` → a ``BertDecodeBackend`` replica in a
spawned process, at the tiny preset.

Copies, against :mod:`tosem_tpu_torch.serve`, of
``tests/test_decode_serve.py``'s ``TestDecodeQueueE2E`` (served streams
equal direct decode token for token, iteration-level packing, poison
isolation, an oversized sequence failing alone, page pressure spilling
and restoring, the decode gauges) and of its deploy-time ``max_active``
guard; of ``tests/test_decode_modes.py``'s ``TestServeModes`` (speculative,
windowed and beam deployments) with a session's second turn; and of
``tests/test_kv_migration.py``'s ``TestServeMigration`` (a drain that
migrates live sequences, disaggregated prefill by export, a one-replica
fleet). ``TestStreaming`` stands in for ``test_serve.py``'s
``TestStreamingThroughServe`` (whose backend is the speech stream, A13):
a decode stream over HTTP, and one that survives a replica crash
mid-stream. Across packages, the JAX package's tiny weights ride
``init_kwargs`` into the replica, and the served streams equal the port's
direct ones.
"""
import json
import sys
import threading
import urllib.request

import cloudpickle
import numpy as np
import pytest
import torch

import tosem_tpu_torch.runtime as rt

torch.set_num_threads(1)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

DECODE_KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
                 max_new_tokens=6, device="cpu")


def make_backend(**over):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = dict(DECODE_KW)
    kw.update(over)
    return BertDecodeBackend(**kw)


def drive(backend, sid, prompt):
    """Sequential decode of one prompt; returns the final tokens."""
    out = backend.admit(sid, {"ids": list(prompt)})
    step = 0
    while not out.get("done"):
        out = backend.step_batch([sid], [step])[0]
        step += 1
    tokens = backend.result(sid)["tokens"]
    backend.release(sid)
    return tokens


def test_max_active_beyond_backend_max_batch_rejected_at_deploy():
    """max_active > the step callable's batch dimension would fail every
    packed sequence at run time; it must fail at deployment
    construction instead."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Deployment
    with pytest.raises(ValueError, match="max_active"):
        Deployment("d", BertDecodeBackend, 1, (), {"max_batch": 4},
                   max_restarts=0, max_retries=1,
                   decode_policy=DecodePolicy(max_active=8))


@pytest.fixture(scope="module")
def runtime():
    # spawned replicas inherit the environment: one intra-op thread each
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        r = rt.init(num_workers=2, memory_monitor=False)
        yield r
        rt.shutdown()


MODE_PROMPT = {"ids": [1 + ((7 + j) % 126) for j in range(12)]}
# 8 prompts of 13-44 tokens: 3, 3, 2, 2, 2, 1, 1, 1 pages of 16 at admit
TIGHT_PROMPTS = [[1 + (7 * i + j) % 120 for j in range(n)]
                 for i, n in enumerate((44, 36, 32, 23, 24, 14, 15, 13))]


class _HideSpill(type):
    """Metaclass of a backend class on which ``hasattr(cls, "spill_seq")``
    is False, as on a backend that cannot spill (instances keep the
    methods; the queue reads only the class)."""

    def __getattribute__(cls, name):
        if name in ("spill_seq", "restore_seq"):
            raise AttributeError(name)
        return super().__getattribute__(name)


def no_spill_backend():
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    return _HideSpill("NoSpillDecode", (BertDecodeBackend,), {})


def deploy(name, max_active=4, policy=None, backend=None, **over):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve
    serve = Serve()
    kw = dict(DECODE_KW)
    kw.update(over)
    serve.deploy(name, backend or BertDecodeBackend, init_kwargs=kw,
                 decode_policy=policy or DecodePolicy(max_active=max_active),
                 circuit_breaker=True)
    return serve


class TestDecodeQueueE2E:
    def test_iteration_scheduling_parity_and_stats(self, runtime):
        ref = make_backend()
        prompts = [[1 + i, 2 + i, 3 + i] for i in range(6)]
        expected = [drive(ref, f"r{i}", p) for i, p in enumerate(prompts)]

        serve = deploy("dq", max_active=4)
        try:
            h = serve.get_handle("dq")
            futs = [h.remote({"ids": p}) for p in prompts]
            got = [f.result(timeout=300.0)["tokens"] for f in futs]
            assert got == expected
            st = serve.get_deployment("dq").stats()
            assert st["decode"] is True and st["batched"] is False
            assert st["sequences_ok"] == 6 and st["sequences_err"] == 0
            assert st["max_active"] == 4
            # iteration-level packing: 6 sequences of ~6 steps each in
            # FAR fewer scheduler iterations than 6 sequential decodes
            assert st["decode_steps"] < 6 * (DECODE_KW["max_new_tokens"]
                                             + 1)
            assert st["tokens_emitted"] >= sum(
                len(t) - 3 for t in expected)
        finally:
            serve.delete("dq")

    def test_poison_isolation_through_the_queue(self, runtime):
        serve = deploy("dq-poison")
        try:
            h = serve.get_handle("dq-poison")
            good = [h.remote({"ids": [1 + i, 2]}) for i in range(3)]
            bad = h.remote({"ids": [999]})
            from tosem_tpu_torch.runtime.common import TaskError
            with pytest.raises(TaskError):
                bad.result(timeout=120.0)
            for f in good:
                assert f.result(timeout=120.0)["tokens"]
        finally:
            serve.delete("dq-poison")

    def test_oversized_sequence_fails_alone(self, runtime):
        # a lone sequence that cannot ever fit fails with CachePressure
        # instead of deadlocking the queue
        serve = deploy("dq-huge", num_pages=1)
        try:
            h = serve.get_handle("dq-huge")
            fut = h.remote({"ids": [1] * 17})     # needs 2 pages, pool=1
            with pytest.raises(Exception):
                fut.result(timeout=120.0)
        finally:
            serve.delete("dq-huge")

    def test_decode_gauges_exported(self, runtime):
        from tosem_tpu_torch.obs.metrics import prometheus_text
        serve = deploy("dq-metrics")
        try:
            h = serve.get_handle("dq-metrics")
            h.call({"ids": [1, 2, 3]}, timeout=300.0)
            serve.get_deployment("dq-metrics").stats()
            text = prometheus_text()
            assert "serve_decode_active_sequences" in text
            assert "serve_decode_batch_occupancy" in text
            assert "serve_kv_pages" in text
        finally:
            serve.delete("dq-metrics")


class TestDecodeModes:
    """``tests/test_decode_modes.py``'s ``TestServeModes`` against the
    port (a windowed, a speculative and a beam deployment), plus a
    session through the queue."""

    def test_spec_deployment_parity_and_gauges(self, runtime):
        from tosem_tpu_torch.obs.metrics import DEFAULT
        serve = deploy("spec-dep", max_active=4, spec_k=4)
        try:
            h = serve.get_handle("spec-dep")
            outs = [h.call(dict(MODE_PROMPT), timeout=120.0)
                    for _ in range(2)]
            assert outs[0]["tokens"] == outs[1]["tokens"]
            ref = drive(make_backend(spec_k=4), "r", MODE_PROMPT["ids"])
            assert outs[0]["tokens"] == ref
            # speculation commits greedy's stream
            assert ref == drive(make_backend(), "g", MODE_PROMPT["ids"])
            dep = serve.get_deployment("spec-dep")
            assert dep.stats()["tokens_emitted"] >= \
                2 * len(outs[0]["generated"])
            dep._queue._last_scrape = 0.0
            dep._queue._refresh_gauges()
            g = DEFAULT.get("serve_spec_acceptance_rate")
            assert g is not None
            assert 0.0 <= g.value(("spec-dep",)) <= 1.0
        finally:
            serve.delete("spec-dep")

    def test_window_deployment_evicts_and_exports(self, runtime):
        from tosem_tpu_torch.obs.metrics import DEFAULT
        serve = deploy("win-dep", max_active=4, window=16, max_len=96,
                       max_new_tokens=48)
        try:
            h = serve.get_handle("win-dep")
            out = h.call(dict(MODE_PROMPT), timeout=180.0)
            assert len(out["generated"]) == 48
            ref = drive(make_backend(window=16, max_len=96,
                                     max_new_tokens=48), "r",
                        MODE_PROMPT["ids"])
            assert out["tokens"] == ref
            dep = serve.get_deployment("win-dep")
            dep._queue._last_scrape = 0.0
            dep._queue._refresh_gauges()
            assert dep.stats()["kv_pages_evicted_total"] > 0
            g = DEFAULT.get("serve_kv_pages_evicted_total")
            assert g is not None and g.value(("win-dep",)) > 0
        finally:
            serve.delete("win-dep")

    def test_sampling_policy_fanout_through_queue(self, runtime):
        from tosem_tpu_torch.serve.batching import (DecodePolicy,
                                                    SamplingPolicy)
        serve = deploy("beam-dep", policy=DecodePolicy(
            max_active=4, sampling=SamplingPolicy(n=4, beam=True)))
        try:
            h = serve.get_handle("beam-dep")
            out = h.call(dict(MODE_PROMPT), timeout=180.0)
            assert len(out["beams"]) == 4
            want = make_backend().call({**MODE_PROMPT, "n": 4,
                                        "beam": True})
            assert out["beams"] == want["beams"]
            # per-request override: plain greedy rides the same queue
            single = h.call({**MODE_PROMPT, "n": 1}, timeout=180.0)
            assert "beams" not in single
            assert single["tokens"] == drive(make_backend(), "r",
                                             MODE_PROMPT["ids"])
        finally:
            serve.delete("beam-dep")

    def test_oversized_group_fails_alone_in_queue(self, runtime):
        from tosem_tpu_torch.runtime.common import TaskError
        serve = deploy("cap-dep", max_active=4)
        try:
            h = serve.get_handle("cap-dep")
            with pytest.raises((ValueError, TaskError)):
                h.call({**MODE_PROMPT, "n": 8, "beam": True}, timeout=60.0)
            assert h.call(dict(MODE_PROMPT), timeout=120.0)["generated"]
        finally:
            serve.delete("cap-dep")

    def test_session_turn2_through_the_queue(self, runtime):
        from tosem_tpu_torch.serve.batching import DecodePolicy
        serve = deploy("sess-dep", policy=DecodePolicy(max_active=4,
                                                       session=True))
        try:
            h = serve.get_handle("sess-dep")
            t1 = h.call({**MODE_PROMPT, "session": "u1"}, timeout=120.0)
            ids2 = t1["tokens"] + [5, 6]
            t2 = h.call({"ids": ids2, "session": "u1"}, timeout=120.0)
            cold = make_backend(prefix_cache=False)
            assert t2["tokens"] == drive(cold, "c", ids2)
            replica = serve.get_deployment("sess-dep")._replicas[0]
            st = rt.get(replica.stats.remote(), timeout=60)
            assert st["session_hits"] == 1
        finally:
            serve.delete("sess-dep")


class TestSpillAndMigration:
    """``tests/test_decode_serve.py``'s page-pressure test and
    ``tests/test_kv_migration.py``'s ``TestServeMigration`` (drain with
    migration, disaggregated prefill, a one-replica fleet) against the
    port's backend."""

    def test_page_pressure_spills_and_all_complete(self, runtime):
        # 14-token prompts fit one page at admit and cross into a second
        # mid-decode: 4 sequences over a 5-page pool must spill and
        # requeue while all are active
        prompts = [[2 + i] * 14 for i in range(4)]
        ref = make_backend()
        expected = [drive(ref, f"r{i}", p) for i, p in enumerate(prompts)]
        serve = deploy("dq-pressure", max_active=4, num_pages=5)
        try:
            h = serve.get_handle("dq-pressure")
            futs = [h.remote({"ids": p}) for p in prompts]
            assert [f.result(timeout=600.0)["tokens"]
                    for f in futs] == expected
            st = serve.get_deployment("dq-pressure").stats()
            assert st["kv_spills"] >= 1 and st["kv_restores"] >= 1
            assert st["sequences_err"] == 0
        finally:
            serve.delete("dq-pressure")

    def test_drain_with_migration_continues_from_current_step(self,
                                                              runtime):
        import time
        from tosem_tpu_torch.serve.backends import BertDecodeBackend
        from tosem_tpu_torch.serve.batching import DecodePolicy
        from tosem_tpu_torch.serve.core import Serve
        kw = dict(DECODE_KW, max_new_tokens=40)
        prompts = [[1 + i, 2 + i, 3 + i] for i in range(4)]
        ref = make_backend(max_new_tokens=40)
        expected = [drive(ref, f"r{i}", p) for i, p in enumerate(prompts)]
        serve = Serve()
        serve.deploy("drain", BertDecodeBackend, init_kwargs=kw,
                     num_replicas=2,
                     decode_policy=DecodePolicy(max_active=4),
                     max_retries=2)
        try:
            dep = serve.get_deployment("drain")
            h = serve.get_handle("drain")
            futs = [h.remote({"ids": p}) for p in prompts]
            q = dep._queue
            deadline = time.time() + 120
            while time.time() < deadline:
                with q._lock:
                    if len(q._active) >= 2:
                        break
                time.sleep(0.02)
            loads = q.replica_loads()
            with dep._lock:
                reps = list(dep._replicas)
            victim = max(reps, key=lambda r: loads.get(id(r), 0))
            assert q.drain_replica(victim, migrate=True)["migrated"] >= 1
            assert [f.result(timeout=180.0)["tokens"]
                    for f in futs] == expected
            st = dep.stats()
            assert st["kv_migrations"] >= 1
            assert st["seqs_readmitted_step0"] == 0
            assert st["sequences_err"] == 0
        finally:
            serve.delete("drain")

    @staticmethod
    def _disaggregated(name, replicas, prompts, n_new, max_active=4,
                       **over):
        """Stream ``prompts`` at once from a deployment with one prefill
        replica; returns its stats after checking the results and the
        streamed tokens against direct decode."""
        from tosem_tpu_torch.serve.backends import BertDecodeBackend
        from tosem_tpu_torch.serve.batching import DecodePolicy
        from tosem_tpu_torch.serve.core import Serve
        ref = make_backend(max_new_tokens=n_new)
        expected = [drive(ref, f"r{i}", p) for i, p in enumerate(prompts)]
        serve = Serve()
        serve.deploy(name, BertDecodeBackend,
                     init_kwargs=dict(DECODE_KW, max_new_tokens=n_new,
                                      **over),
                     num_replicas=replicas,
                     decode_policy=DecodePolicy(max_active=max_active,
                                                prefill_replicas=1),
                     max_retries=2)
        try:
            h = serve.get_handle(name)
            got = [None] * len(prompts)
            streamed = [[] for _ in prompts]

            def client(i):
                got[i] = h.stream({"ids": prompts[i]},
                                  lambda toks, done: streamed[i].extend(toks),
                                  timeout=180.0)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=240.0)
            assert [g["tokens"] for g in got] == expected
            # every token streams once, the admit's included (C-ref7)
            assert streamed == [g["generated"] for g in got]
            return serve.get_deployment(name).stats()
        finally:
            serve.delete(name)

    def test_disaggregated_prefill_decode_bit_identical(self, runtime):
        """Each prefilled sequence's pages migrate from the prefill
        replica to a decode replica, by export (the port has no streamed
        hand-off yet)."""
        prompts = [[1 + i, 2 + i, 3 + i] for i in range(4)]
        st = self._disaggregated("disagg", 3, prompts, 20)
        assert st["kv_migrations"] >= 4
        assert st["kv_migration_fallbacks"] == 0
        assert st["sequences_ok"] == 4 and st["sequences_err"] == 0

    def test_disaggregated_prefill_onto_a_pressured_decode_replica(
            self, runtime):
        """Hand-off and the spill tier in one deployment: 8 sequences
        needing 20 pages migrate to a decode replica of 13, which parks
        pressured imports, spills and restores as they grow, and every
        stream equals the direct one."""
        st = self._disaggregated("disagg-pressure", 2, TIGHT_PROMPTS, 8,
                                 max_active=8, max_batch=8, num_pages=13)
        assert st["kv_spills"] >= 1 and st["kv_restores"] >= 1
        assert st["kv_migrations"] >= 8
        assert st["kv_migration_fallbacks"] == 0
        assert st["sequences_ok"] == 8 and st["sequences_err"] == 0

    def test_parked_handoff_retries_once_the_prefill_tier_idles(
            self, runtime):
        """The second sequence's import meets a decode pool the first
        one fills (3 pages each, 3 in the pool) and parks; once the
        first retires it must import, though no prefill is left to
        finish (C-ref8: the JAX package's copy retries parked imports
        only when a prefill completes, so this request hangs)."""
        prompts = [[3] * 30, [4] * 30]
        st = self._disaggregated("disagg-parked", 2, prompts, 12,
                                 max_active=2, num_pages=3)
        assert st["kv_migrations"] >= 2
        assert st["sequences_ok"] == 2 and st["sequences_err"] == 0

    def test_tight_pool_serves_every_sequence(self, runtime):
        """8 sequences needing 22 pages over a pool of 12, colocated:
        pressure spills rotate them all to completion. The JAX package's
        copy restores a spilled sequence before the others' next step
        and counts each such spill as a stall, so a sequence the pool
        could serve fails after 6 (C-ref9)."""
        expected = [drive(make_backend(max_new_tokens=12), f"r{i}", p)
                    for i, p in enumerate(TIGHT_PROMPTS)]
        serve = deploy("dq-tight", max_active=8, max_batch=8, num_pages=12,
                       max_new_tokens=12)
        try:
            h = serve.get_handle("dq-tight")
            futs = [h.remote({"ids": p}) for p in TIGHT_PROMPTS]
            assert [f.result(timeout=180.0)["tokens"]
                    for f in futs] == expected
            st = serve.get_deployment("dq-tight").stats()
            assert st["kv_spills"] >= 1 and st["sequences_err"] == 0
        finally:
            serve.delete("dq-tight")

    def test_mutually_blocking_sequences_fail_one_without_spill(
            self, runtime):
        """On a backend without ``spill_seq``, two 30-token sequences
        fill a 4-page pool at admit and both need a third page at the
        same step. Neither can spill, so the pressured one fails typed
        after ``PRESSURE_STALL_LIMIT`` tries and the other then completes
        (a stall rule that skipped the count whenever another sequence
        was active would retry them forever)."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        prompts = [[3] * 30, [4] * 30]
        expected = drive(make_backend(), "r", prompts[1])
        serve = deploy("dq-nospill", max_active=2, num_pages=4,
                       backend=no_spill_backend())
        try:
            h = serve.get_handle("dq-nospill")
            futs = [h.remote({"ids": p}) for p in prompts]
            with pytest.raises(CachePressure, match="cannot grow"):
                futs[0].result(timeout=120.0)
            assert futs[1].result(timeout=120.0)["tokens"] == expected
            st = serve.get_deployment("dq-nospill").stats()
            assert st["kv_spills"] == 0
            assert st["sequences_ok"] == 1 and st["sequences_err"] == 1
        finally:
            serve.delete("dq-nospill")

    def test_disaggregated_single_replica_falls_back_colocated(self,
                                                               runtime):
        """``prefill_replicas`` >= the fleet leaves no prefill tier:
        admission falls back to the colocated path instead of stalling."""
        prompts = [[1 + i, 2 + i, 3 + i] for i in range(2)]
        st = self._disaggregated("disagg1", 1, prompts, 8)
        assert st["sequences_ok"] == 2


class TestStreaming:
    def test_http_stream_equals_the_direct_decode(self, runtime):
        from tosem_tpu_torch.serve import HttpIngress
        prompt = [5, 6, 7, 8]
        expected = drive(make_backend(), "r", prompt)
        serve = deploy("dq-http")
        ingress = HttpIngress(serve)
        try:
            req = urllib.request.Request(
                f"{ingress.url}/dq-http?stream=1",
                data=json.dumps({"ids": prompt}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                lines = [json.loads(x) for x in r if x.strip()]
            streamed = [t for ln in lines[:-1] for t in ln["tokens"]]
            assert lines[-2]["done"] is True
            assert lines[-1]["result"]["tokens"] == expected
            assert streamed == expected[len(prompt):]
            # a plain POST answers with the whole result (lists: JSON)
            req = urllib.request.Request(
                f"{ingress.url}/dq-http",
                data=json.dumps({"ids": prompt}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                assert json.loads(r.read())["result"]["tokens"] == expected
        finally:
            ingress.shutdown()
            serve.delete("dq-http")

    def test_stream_survives_replica_crash(self, runtime):
        """A replica crash mid-stream (``serve.dispatch`` chaos on a
        decode step): the queue re-admits the sequence on the restarted
        replica, greedy decode replays the same path, and the stream
        delivers every token exactly once."""
        from tosem_tpu_torch.chaos import ChaosController, Fault, FaultPlan
        from tosem_tpu_torch.serve.backends import BertDecodeBackend
        from tosem_tpu_torch.serve.batching import DecodePolicy
        from tosem_tpu_torch.serve.core import Serve
        prompt = [9, 8, 7]
        kw = dict(DECODE_KW, max_new_tokens=12)
        expected = drive(make_backend(max_new_tokens=12), "r", prompt)
        serve = Serve()
        serve.deploy("dq-crash", BertDecodeBackend, init_kwargs=kw,
                     decode_policy=DecodePolicy(max_active=4),
                     max_restarts=2)
        try:
            h = serve.get_handle("dq-crash")
            h.call({"ids": [1, 2]}, timeout=120.0)     # replica is up
            streamed = []
            plan = FaultPlan(seed=3, faults=[
                Fault(site="serve.dispatch", action="crash_replica",
                      at=4)])
            with ChaosController(plan) as chaos:
                out = h.stream({"ids": prompt},
                               lambda toks, done: streamed.extend(toks),
                               timeout=300.0)
                assert chaos.injections("serve.dispatch")
            assert out["tokens"] == expected
            assert streamed == expected[len(prompt):]
            st = serve.get_deployment("dq-crash").stats()
            assert st["seqs_readmitted_step0"] >= 1
            assert st["sequences_err"] == 0
        finally:
            serve.delete("dq-crash")


def test_served_streams_with_reference_weights_equal_direct_decode(
        runtime):
    """The JAX package's tiny decoder weights, carried over through
    ``init_kwargs`` (``models/convert.py`` loads them in the replica):
    the served greedy streams equal the port's direct decode with the
    same weights, token for token, and the direct decode's first token
    is the reference's argmax within the bf16 tolerance."""
    import jax
    from tosem_tpu.ops.parity import TOLERANCES
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    ref_kw = {k: v for k, v in DECODE_KW.items() if k != "device"}
    jdec = JDec(**ref_kw)
    params = jax.tree_util.tree_map(np.asarray, jdec._vs["params"])
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (3, 9, 17, 30)]
    direct = make_backend(params=params)
    expected = [drive(direct, f"r{i}", p) for i, p in enumerate(prompts)]
    serve = deploy("dq-ref", params=params)
    try:
        h = serve.get_handle("dq-ref")
        futs = [h.remote({"ids": p}) for p in prompts]
        got = [f.result(timeout=300.0)["tokens"] for f in futs]
    finally:
        serve.delete("dq-ref")
    assert got == expected
    tol = TOLERANCES["flash"]["bfloat16"]
    for p in prompts:
        first = jdec.call({"ids": p})["generated"][0]
        direct.cache.create("x")
        direct.cache.extend("x", len(p))
        row = direct._prefill_into_cache("x", p)
        direct.cache.free("x")
        assert row[first] >= row.max() - tol
