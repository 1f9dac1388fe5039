"""Continuous-batching decode through the port's control plane on the
CPU: ``Serve`` → ``DecodeQueue`` → a ``BertDecodeBackend`` replica in a
spawned process, at the tiny preset.

Copies, against :mod:`tosem_tpu_torch.serve`, of
``tests/test_decode_serve.py``'s ``TestDecodeQueueE2E`` (served streams
equal direct decode token for token, iteration-level packing, poison
isolation, an oversized sequence failing alone, the decode gauges) and
of its deploy-time ``max_active`` guard. The page-pressure spill test
waits for the backend's ``spill_seq`` (ROADMAP.md A6). ``TestStreaming``
stands in for ``test_serve.py``'s ``TestStreamingThroughServe`` (whose
backend is the speech stream, A13): a decode stream over HTTP, and one
that survives a replica crash mid-stream. The decode modes the port's
backend does not have yet fail typed through the queue, never hang.
Across packages, the JAX package's tiny weights ride ``init_kwargs``
into the replica, and the served streams equal the port's direct ones.
"""
import json
import sys
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


def deploy(name, max_active=4, policy=None, **over):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve
    serve = Serve()
    kw = dict(DECODE_KW)
    kw.update(over)
    serve.deploy(name, BertDecodeBackend, init_kwargs=kw,
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


def _unported(kind):
    """(DecodePolicy, request, message) of one decode mode the port's
    backend does not have yet."""
    from tosem_tpu_torch.serve.batching import DecodePolicy, SamplingPolicy
    if kind == "session":
        return (DecodePolicy(max_active=4, session=True),
                {"ids": [1, 2, 3], "session": "user-1"},
                r"multi-turn sessions is not ported yet \(ROADMAP.md A7")
    if kind == "sampling":
        return (DecodePolicy(max_active=4, sampling=SamplingPolicy(n=2)),
                {"ids": [1, 2, 3]},
                r"n > 1 beam/sampling groups is not ported yet "
                r"\(ROADMAP.md A7")
    return (DecodePolicy(max_active=4), {"ids": [1, 2, 3], "n": 2},
            r"n > 1 beam/sampling groups is not ported yet \(ROADMAP.md A7")


@pytest.mark.parametrize("kind", ["session", "sampling", "request_n"])
def test_unported_decode_modes_fail_typed_through_the_queue(runtime, kind):
    """A request the backend cannot serve yet fails its own future with a
    ``TaskError`` carrying the backend's message, while a plain request
    on the same deployment still decodes."""
    from tosem_tpu_torch.runtime.common import TaskError
    policy, request, message = _unported(kind)
    name = f"dq-{kind}"
    serve = deploy(name, policy=policy)
    try:
        h = serve.get_handle(name)
        fut = h.remote(request)
        with pytest.raises(TaskError, match=message) as ei:
            fut.result(timeout=120.0)
        assert isinstance(ei.value.cause, NotImplementedError)
        if kind != "sampling":
            assert h.call({"ids": [4, 5]}, timeout=120.0)["tokens"]
        st = serve.get_deployment(name).stats()
        assert st["sequences_err"] >= 1 and st["active_sequences"] == 0
    finally:
        serve.delete(name)


def test_disaggregated_prefill_refused_without_migration(runtime):
    """``prefill_replicas`` needs ``export_seq``/``import_seq``, which
    the port's backend does not have yet (ROADMAP.md A6/A7): the deploy
    fails, typed, before any replica serves."""
    from tosem_tpu_torch.serve.batching import DecodePolicy
    with pytest.raises(ValueError, match="migration surface"):
        deploy("dq-disagg", policy=DecodePolicy(max_active=4,
                                                prefill_replicas=1))


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
