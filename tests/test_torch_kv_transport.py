"""Replica-to-replica KV hand-off over the tensor transport
(``BertDecodeBackend.transport_address`` / ``send_seq`` / ``adopt_seq`` /
``send_prefix`` / ``adopt_prefix`` / ``admit(send_to=)``).

``tests/test_kv_migration.py``'s transport cases run against the port
(a streamed sequence decodes the stream a direct decode gives, token for
token; adopt is idempotent; the served disaggregated deployment streams
every prefilled sequence; the ``decode-migrate`` chaos plan through the
port's runner), and ``tests/test_prefix_cache.py``'s cross-node prefix
transfer. Across packages (ROADMAP C5): a port stream lands in a JAX
package replica with its bf16 pages as ``bfloat16`` and a JAX package
stream is adopted by the port, bytes equal both ways.
"""
import sys
import threading

import cloudpickle
import numpy as np
import pytest
import torch

import tosem_tpu_torch.runtime as rt

torch.set_num_threads(1)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
          max_new_tokens=8)
PROMPT = {"ids": [1, 2, 3, 4]}


def make_backend(**over):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = dict(KW, device="cpu")
    kw.update(over)
    return BertDecodeBackend(**kw)


def _decode_from(b, sid, out, step):
    while not out.get("done"):
        out = b.step_batch([sid], [step])[0]
        step += 1
    res = b.result(sid)
    b.release(sid)
    return res


def _decode_all(b, sid, req):
    return _decode_from(b, sid, b.admit(sid, req), 0)


@pytest.fixture(scope="module")
def reference_tokens():
    return _decode_all(make_backend(), "ref", PROMPT)["tokens"]


@pytest.fixture
def pair():
    src, dst = make_backend(), make_backend()
    yield src, dst
    src.shutdown()
    dst.shutdown()


class TestBackendTransport:
    def test_transport_migration_bit_identical(self, pair,
                                               reference_tokens):
        src, dst = pair
        out = src.admit("s", PROMPT)
        out = src.step_batch(["s"], [0])[0]
        n = src.send_seq("s", dst.transport_address())
        assert n > 0
        dst.adopt_seq("s")
        src.release("s")
        got = _decode_from(dst, "s", out, 1)
        assert got["tokens"] == reference_tokens
        st = dst.cache_stats()
        assert st["handoffs_adopted"] == 1
        assert src.cache_stats()["handoffs_sent"] == 1

    def test_adopt_is_idempotent(self, pair, reference_tokens):
        src, dst = pair
        out = src.admit("s", PROMPT)
        src.send_seq("s", dst.transport_address())
        dst.adopt_seq("s")
        dst.adopt_seq("s", timeout=0.1)      # replayed adopt: a no-op
        dst.import_seq("s", {"kind": "seq"})  # replayed import: no-op
        got = _decode_from(dst, "s", out, 0)
        assert got["tokens"] == reference_tokens

    def test_beam_group_streams_every_branch(self, pair):
        src, dst = pair
        req = {"ids": [5, 6, 7], "n": 3, "beam": True}
        want = _decode_all(make_backend(), "g", req)
        out = src.admit("g", req)
        out = src.step_batch(["g"], [0])[0]
        src.send_seq("g", dst.transport_address())
        dst.adopt_seq("g")
        src.release("g")
        assert _decode_from(dst, "g", out, 1) == want

    def test_admit_send_to_hands_off_and_releases(self, pair,
                                                  reference_tokens):
        src, dst = pair
        addr = dst.transport_address()
        out = src.admit("s", PROMPT, send_to=addr)
        assert out["sent"] is True and "state" not in out
        assert src.cache.stats()["pages_used"] == 0    # source released
        assert src.admit("s", PROMPT, send_to=addr) == out   # replay
        dst.adopt_seq("s")
        got = _decode_from(dst, "s", out, 0)
        assert got["tokens"] == reference_tokens

    def test_pressured_adopt_parks_the_stream(self, reference_tokens):
        """A pool with no room raises CachePressure and parks the stream
        on the receiver: the retried adopt imports it without a second
        send."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        src, dst = make_backend(), make_backend(num_pages=2)
        try:
            out = src.admit("s", PROMPT)
            dst.admit("hog", {"ids": list(range(1, 30))})   # 2 pages
            src.send_seq("s", dst.transport_address())
            with pytest.raises(CachePressure):
                dst.adopt_seq("s")
            assert dst._receiver.stats()["pending_keys"] == ["seq:s"]
            dst.release("hog")
            dst.adopt_seq("s", timeout=0)
            assert dst._receiver.stats()["received"] == 1
            got = _decode_from(dst, "s", out, 0)
            assert got["tokens"] == reference_tokens
        finally:
            src.shutdown()
            dst.shutdown()

    def test_release_drops_an_unadopted_stream(self, pair):
        src, dst = pair
        src.admit("s", PROMPT)
        src.send_seq("s", dst.transport_address())
        assert dst._receiver.stats()["pending_keys"] == ["seq:s"]
        dst.release("s")
        assert dst._receiver.stats()["pending_keys"] == []
        with pytest.raises(TimeoutError):
            dst.adopt_seq("s", timeout=0.05)

    def test_shutdown_closes_the_receiver(self):
        b = make_backend()
        b.transport_address()
        receiver = b._receiver
        b.shutdown()
        # the listening socket is closed (a send now would reach nothing,
        # or another process's receiver that took the freed port)
        assert receiver._sock.fileno() == -1
        assert receiver._shutdown.is_set()
        with pytest.raises(RuntimeError, match="transport_address"):
            b.adopt_seq("s")
        b.shutdown()                          # idempotent

    def test_adopt_without_a_receiver_raises(self):
        with pytest.raises(RuntimeError, match="transport_address"):
            make_backend().adopt_seq("s")


# ------------------------------------------------- prefix transfer

PREFIX_KW = dict(max_batch=2, max_len=128, page_size=8, num_pages=64,
                 max_new_tokens=4)
SHARED = [3 + (i * 5) % 97 for i in range(40)]


def _prompt(tail):
    return {"ids": SHARED + [7 + tail % 80, 9 + tail % 80]}


def test_cross_node_transfer_hit_bit_identical():
    from tosem_tpu_torch.serve.prefix_cache import prefix_hash
    warm = make_backend(**PREFIX_KW)
    cold = make_backend(prefix_cache=False, **PREFIX_KW)
    peer = make_backend(**PREFIX_KW)               # same seed, same model
    try:
        addr = peer.transport_address()
        warm.call(_prompt(0))                      # indexed here
        depth, n_tok, h = max(warm.prefix_digest(), key=lambda r: r[0])
        assert h == prefix_hash(SHARED[:n_tok])
        with pytest.raises(KeyError):
            warm.send_prefix(depth, "0" * 16, addr)  # evicted since digest
        warm.send_prefix(depth, h, addr)
        assert peer.adopt_prefix(h) >= 1
        assert peer.cache_stats()["prefix_remote_imports"] == 1
        # a prompt sharing the transferred prefix now hits on the peer and
        # decodes the exact cold-prefill stream
        got = peer.call(_prompt(40))["tokens"]
        assert peer._prefix_hits >= 1
        assert got == cold.call(_prompt(40))["tokens"]
    finally:
        peer.shutdown()


# ---------------------------------------------- served hand-off


@pytest.fixture(scope="module")
def runtime():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        r = rt.init(num_workers=3, memory_monitor=False)
        yield r
        rt.shutdown()


def _expected(prompts, kw):
    ref = make_backend(**kw)
    return [_decode_all(ref, f"r{i}", p)["tokens"]
            for i, p in enumerate(prompts)]


def test_disaggregated_prefill_streams_replica_to_replica(runtime):
    """One prefill and two decode replicas: every prefilled sequence's
    pages stream to its decode replica (none by export), and every
    result equals the direct decode."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve
    kw = dict(KW, max_new_tokens=12, device="cpu")
    prompts = [{"ids": [1 + i, 2 + i, 3 + i]} for i in range(4)]
    expected = _expected(prompts, kw)
    serve = Serve()
    serve.deploy("xfer", BertDecodeBackend, init_kwargs=kw, num_replicas=3,
                 decode_policy=DecodePolicy(max_active=4,
                                            prefill_replicas=1),
                 max_retries=2)
    try:
        h = serve.get_handle("xfer")
        futs = [h.remote(p) for p in prompts]
        assert [f.result(timeout=180.0)["tokens"] for f in futs] == expected
        dep = serve.get_deployment("xfer")
        st = dep.stats()
        reps = [rt.get(r.stats.remote(), timeout=60) for r in dep._replicas]
        assert st["kv_migrations"] >= len(prompts)
        assert st["kv_migration_fallbacks"] == 0
        assert sum(r["handoffs_sent"] for r in reps) == len(prompts)
        assert sum(r["handoffs_adopted"] for r in reps) == len(prompts)
        assert sum(r["handoffs_exported"] for r in reps) == 0
    finally:
        serve.delete("xfer")


def test_decode_migrate_chaos_plan_survives(monkeypatch):
    """The JAX package's ``decode-migrate`` plan through
    ``tosem_tpu_torch.chaos.runner.run_plan``: 8 sequences through a
    disaggregated deployment (1 prefill + 2 decode replicas) while a
    decode replica is drained mid-stream (its sequences migrate) and the
    prefill replica is then crashed; every sequence completes with the
    fault-free tokens, no error reaches a client, and sequences
    migrate. The runner starts its own runtime."""
    from tosem_tpu_torch.chaos.plan import CANNED_PLANS
    from tosem_tpu_torch.chaos.runner import run_plan
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rep = run_plan(CANNED_PLANS["decode-migrate"], device="cpu")
    assert rep.ok, rep.render()
    assert rep.counts["errors_surfaced"] == 0
    assert rep.counts["sequences_correct"] == rep.counts["sequences"] == 8
    assert rep.counts["kv_migrations"] > 0
    assert rep.counts["drains_injected"] > 0


# -------------------------------------------- across packages (C5)


def test_port_stream_lands_in_a_reference_replica():
    """The port's ``send_seq`` into a JAX package replica's receiver:
    the pages arrive as ``bfloat16`` (never as uint16), and the
    reference's ``adopt_seq`` imports them byte for byte."""
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    src = make_backend()
    ref = JDec(**KW)
    assert src.cfg.dtype == "bfloat16"
    src.admit("s", PROMPT)
    src.step_batch(["s"], [0])
    sent = src.export_seq("s")["kv"]
    src.send_seq("s", ref.transport_address())
    rx = ref._receiver.pop("seq:s", timeout=10.0)
    arrs = rx.arrays()
    assert str(arrs["k0"].dtype) == "bfloat16"
    assert arrs["k0"].tobytes() == sent["k"].tobytes()
    assert arrs["v0"].tobytes() == sent["v"].tobytes()
    assert rx.meta["decode_state"]["tokens"] == src._seqs["s"].tokens
    ref._receiver.put_back("seq:s", rx)
    ref.adopt_seq("s")
    landed = ref.export_seq("s")["kv"]
    assert np.asarray(landed["k"]).tobytes() == sent["k"].tobytes()
    assert np.asarray(landed["v"]).tobytes() == sent["v"].tobytes()
    src.shutdown()


def test_reference_stream_adopted_by_the_port():
    """A JAX package replica's ``send_seq`` into the port: ``adopt_seq``
    registers the request with the pages byte for byte and its
    bookkeeping (tokens, step ledger)."""
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    ref = JDec(**KW)
    dst = make_backend()
    try:
        ref.admit("s", PROMPT)
        ref.step_batch(["s"], [0])
        state = ref.export_seq("s")
        ref.send_seq("s", dst.transport_address())
        dst.adopt_seq("s")
        landed = dst.export_seq("s")
        assert landed["tokens"] == list(state["tokens"])
        assert landed["next_step"] == state["next_step"]
        for k in ("k", "v"):
            assert landed["kv"][k].tobytes() == \
                np.asarray(state["kv"][k]).tobytes()
        assert landed["kv"]["header"]["dtype"] == "bfloat16"
    finally:
        dst.shutdown()


def test_threads_adopting_distinct_streams(pair, reference_tokens):
    """Streams land in any order and by key: two sequences sent at once
    are each adopted by their own id."""
    src, dst = pair
    outs = {sid: src.admit(sid, PROMPT) for sid in ("a", "b")}
    addr = dst.transport_address()
    ts = [threading.Thread(target=src.send_seq, args=(sid, addr))
          for sid in ("b", "a")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for sid in ("a", "b"):
        dst.adopt_seq(sid)
        assert _decode_from(dst, sid, outs[sid], 0)["tokens"] == \
            reference_tokens
