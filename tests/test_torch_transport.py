"""The port's chunked tensor transport (``tosem_tpu_torch/cluster/
transport.py``): the JAX package's ``tests/test_cluster_transport.py``
run against the copy — round trip, framing, typed wire errors, the KV
glue and duplicate streams — plus the wire the two packages share:
streams sent by either package land in the other's receiver with equal
bytes, bf16 arrays and KV payloads included (ROADMAP.md C5). Its
companions too: the epoch fences (``cluster/fencing.py``, the reference's
``tests/test_gray_failure.py`` cases) and the emulated network state the
transport consults (``chaos/network.py``)."""
import json
import socket
import struct
import time

import numpy as np
import pytest
import torch

from tosem_tpu_torch.cluster.transport import (DEFAULT_CHUNK_BYTES, MAGIC,
                                               TRANSPORT_WIRE_VERSION,
                                               TensorReceiver,
                                               TransportError,
                                               WireFormatError,
                                               received_kv_payload,
                                               send_kv_payload, send_tensors)

torch.set_num_threads(1)

_H = struct.Struct(">I")
_C = struct.Struct(">IQI")


@pytest.fixture()
def rx():
    r = TensorReceiver()
    yield r
    r.shutdown()


def _raw(rx, payload: bytes) -> None:
    s = socket.create_connection(("127.0.0.1", rx.port), timeout=5.0)
    try:
        s.sendall(payload)
    finally:
        s.close()


def _wait_errors(rx, n, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if rx.stats()["errors"] >= n:
            return rx.stats()
    raise AssertionError(
        f"receiver never recorded {n} errors: {rx.stats()}")


def _header(total, name="z", shape=None, nbytes=None, dtype="uint8"):
    nbytes = total if nbytes is None else nbytes
    return json.dumps({
        "version": 1, "total_bytes": total,
        "arrays": [{"name": name, "dtype": dtype,
                    "shape": shape or [total], "offset": 0,
                    "nbytes": nbytes}],
        "meta": {}}).encode()


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_wire_constants_are_the_references():
    from tosem_tpu.cluster import transport as ref
    assert MAGIC == ref.MAGIC == b"KVX1"
    assert TRANSPORT_WIRE_VERSION == ref.TRANSPORT_WIRE_VERSION == 1
    assert DEFAULT_CHUNK_BYTES == ref.DEFAULT_CHUNK_BYTES


class TestRoundTrip:
    def test_multi_chunk_bit_identity(self, rx):
        a = torch.arange(700_000, dtype=torch.float32).reshape(7, 100_000)
        b = torch.arange(64, dtype=torch.int64)
        n = send_tensors(rx.address, {"key": "k1"},
                         {"a": a, "b": b}, chunk_bytes=1 << 16)
        assert n == a.numel() * 4 + b.numel() * 8
        assert n > (1 << 16)          # really chunked
        got = rx.pop("k1", timeout=10.0)
        arrs = got.arrays()
        assert torch.equal(arrs["a"], a) and torch.equal(arrs["b"], b)
        assert arrs["a"].shape == a.shape
        got.release()

    def test_arrivals_alias_the_receive_buffer(self, rx):
        # no copy on arrival: two reads of one stream share their memory
        a = torch.ones((8, 8), dtype=torch.float32)
        send_tensors(rx.address, {"key": "ro"}, {"a": a})
        got = rx.pop("ro", timeout=10.0)
        assert rx.store_backed
        assert (got.arrays()["a"].data_ptr()
                == got.arrays()["a"].data_ptr())
        got.release()

    def test_keyless_fifo_take(self, rx):
        send_tensors(rx.address, {"tag": 1},
                     {"x": torch.arange(4, dtype=torch.int32)})
        got = rx.take(timeout=10.0)
        assert got.meta["tag"] == 1
        got.release()

    def test_take_timeout(self, rx):
        with pytest.raises(TimeoutError):
            rx.take(timeout=0.05)

    def test_pop_timeout_names_key(self, rx):
        with pytest.raises(TimeoutError, match="nope"):
            rx.pop("nope", timeout=0.05)

    def test_bfloat16_round_trip(self, rx):
        a = torch.arange(256, dtype=torch.bfloat16) / 7
        send_tensors(rx.address, {"key": "bf"}, {"a": a})
        got = rx.pop("bf", timeout=10.0)
        out = got.arrays()["a"]
        assert out.dtype == torch.bfloat16
        assert _bytes(out) == _bytes(a)
        got.release()

    def test_scalars_and_empties_keep_their_shape(self, rx):
        send_tensors(rx.address, {"key": "s"},
                     {"step": torch.tensor(7),
                      "none": torch.zeros((0, 3), dtype=torch.bfloat16),
                      "flag": torch.tensor([True, False])})
        arrs = rx.pop("s", timeout=10.0).arrays()
        assert arrs["step"].shape == () and int(arrs["step"]) == 7
        assert arrs["none"].shape == (0, 3)
        assert arrs["none"].dtype == torch.bfloat16
        assert arrs["flag"].tolist() == [True, False]

    def test_device_tensor_is_refused(self, rx):
        # the caller copies to the host itself: a send never hides one
        with pytest.raises(ValueError, match="host"):
            send_tensors(rx.address, {"key": "m"},
                         {"a": torch.zeros(4, device="meta")})
        with pytest.raises(TypeError, match="torch tensor"):
            send_tensors(rx.address, {"key": "n"}, {"a": np.zeros(4)})

    def test_put_back_repops(self, rx):
        send_tensors(rx.address, {"key": "pb"},
                     {"x": torch.arange(4, dtype=torch.int32)})
        got = rx.pop("pb", timeout=10.0)
        rx.put_back("pb", got)
        again = rx.pop("pb", timeout=1.0)
        assert again.arrays()["x"].tolist() == [0, 1, 2, 3]
        again.release()

    def test_bytes_counters(self, rx):
        from tosem_tpu_torch.obs.metrics import prometheus_text
        a = torch.arange(1024, dtype=torch.float64)
        send_tensors(rx.address, {"key": "m"}, {"a": a})
        rx.pop("m", timeout=10.0).release()
        text = prometheus_text()
        assert "cluster_transport_bytes_total" in text
        assert 'direction="sent"' in text
        assert 'direction="received"' in text
        assert rx.stats()["bytes_received"] >= 1024 * 8

    def test_public_bind_warns(self):
        with pytest.warns(RuntimeWarning, match="unauthenticated"):
            r = TensorReceiver(host="0.0.0.0")
        r.shutdown()


class TestFraming:
    def test_torn_stream_mid_chunk(self, rx):
        hdr = _header(100)
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr
             + _C.pack(0, 0, 100) + b"xy")          # dies mid-chunk
        st = _wait_errors(rx, 1)
        assert "torn stream" in st["last_error"]

    def test_truncated_header(self, rx):
        _raw(rx, MAGIC + _H.pack(64) + b"notjson")
        st = _wait_errors(rx, 1)
        assert ("torn stream" in st["last_error"]
                or "header" in st["last_error"])

    def test_garbled_header_json(self, rx):
        blob = b"x" * 32
        _raw(rx, MAGIC + _H.pack(len(blob)) + blob)
        st = _wait_errors(rx, 1)
        assert "WireFormatError" in st["last_error"]

    def test_bad_magic(self, rx):
        _raw(rx, b"NOPE" + _H.pack(4) + b"{}!!")
        st = _wait_errors(rx, 1)
        assert "magic" in st["last_error"]

    def test_out_of_order_chunk_rejected(self, rx):
        hdr = _header(100)
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr
             + _C.pack(5, 0, 50) + b"a" * 50)
        st = _wait_errors(rx, 1)
        assert "out-of-order" in st["last_error"]

    def test_chunk_past_extent_rejected(self, rx):
        hdr = _header(10)
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr
             + _C.pack(0, 0, 64) + b"a" * 64)
        st = _wait_errors(rx, 1)
        assert "extent" in st["last_error"]

    def test_fin_short_rejected(self, rx):
        hdr = _header(100)
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr
             + _C.pack(0xFFFFFFFF, 0, 0))           # FIN before bytes
        st = _wait_errors(rx, 1)
        assert "FIN" in st["last_error"]

    def test_version_mismatch_rejected(self, rx):
        blob = json.dumps({"version": 99, "total_bytes": 0,
                           "arrays": [], "meta": {}}).encode()
        _raw(rx, MAGIC + _H.pack(len(blob)) + blob)
        st = _wait_errors(rx, 1)
        assert "version" in st["last_error"]

    def test_specs_must_sum_to_total(self, rx):
        hdr = _header(100, nbytes=40)
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr)
        st = _wait_errors(rx, 1)
        assert "sum" in st["last_error"]

    def test_unknown_wire_dtype_is_typed(self, rx):
        hdr = json.dumps({"version": 1, "total_bytes": 4, "meta":
                          {"key": "f8"}, "arrays": [
                              {"name": "z", "dtype": "float8", "shape": [4],
                               "offset": 0, "nbytes": 4}]}).encode()
        _raw(rx, MAGIC + _H.pack(len(hdr)) + hdr + _C.pack(0, 0, 4)
             + b"abcd" + _C.pack(0xFFFFFFFF, 4, 0))
        got = rx.pop("f8", timeout=10.0)
        with pytest.raises(WireFormatError, match="float8"):
            got.arrays()
        got.release()

    def test_errors_do_not_break_later_streams(self, rx):
        _raw(rx, b"NOPE")
        _wait_errors(rx, 1)
        a = torch.arange(16, dtype=torch.int32)
        send_tensors(rx.address, {"key": "after"}, {"a": a})
        got = rx.pop("after", timeout=10.0)
        assert got.arrays()["a"].tolist() == list(range(16))
        got.release()

    def test_sender_sees_peer_loss_typed(self):
        # a peer that dies mid-stream surfaces as TransportError on
        # the SENDER (torn send or torn ack, both typed)
        import threading
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]

        def slam():
            conn, _ = srv.accept()
            conn.close()

        t = threading.Thread(target=slam, daemon=True)
        t.start()
        with pytest.raises(TransportError):
            send_tensors(f"127.0.0.1:{port}", {},
                         {"a": torch.zeros(1 << 22, dtype=torch.uint8)},
                         timeout=5.0)
        t.join()
        srv.close()

    def test_chunk_bytes_validated(self, rx):
        with pytest.raises(ValueError):
            send_tensors(rx.address, {}, {"a": torch.zeros(4)},
                         chunk_bytes=0)


def _port_pool(dtype, num_pages=8, seed=3, **geom):
    from tosem_tpu_torch.serve.kv_cache import LocalSpillStore, PagedKVCache
    geom = {"page_size": 4, "layers": 2, "heads": 2, "head_dim": 8, **geom}
    c = PagedKVCache(num_pages, dtype=dtype, device="cpu",
                     spill_store=LocalSpillStore(), **geom)
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    for pool in (c.k_pool, c.v_pool):
        pool.copy_(torch.from_numpy(rng.standard_normal(
            tuple(pool.shape)).astype(np.float32)).to(tdt))
    return c


class TestKvGlue:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_kv_payload_round_trip(self, rx, dtype):
        src = _port_pool(dtype)
        src.create("s")
        src.extend("s", 10)
        payload = src.export_seq("s")
        send_kv_payload(rx.address, payload, key="s")
        got = rx.pop("s", timeout=10.0)
        # the wire names the pool's dtype, never uint16
        assert got.arrays()["k"].dtype == getattr(torch, dtype)
        back = received_kv_payload(got)
        assert back["header"] == payload["header"]
        assert back["k"].tobytes() == payload["k"].tobytes()
        assert back["v"].tobytes() == payload["v"].tobytes()
        dst = _port_pool(dtype, seed=9)
        dst.import_seq("s", back)
        got.release()
        assert dst.length("s") == 10
        assert torch.equal(dst.k_pool[:, dst.pages_of("s")],
                           src.k_pool[:, src.pages_of("s")])

    def test_stream_without_kv_header_rejected(self, rx):
        send_tensors(rx.address, {"key": "nohdr"},
                     {"k": torch.zeros(4), "v": torch.zeros(4)})
        got = rx.pop("nohdr", timeout=10.0)
        with pytest.raises(WireFormatError):
            received_kv_payload(got)
        got.release()


class TestDuplicateStreams:
    """At-least-once delivery: a sender whose COMMIT ack was lost
    replays the whole stream. The receiver's by-key dedupe must DROP
    the replay — the first copy is the committed one — and count it,
    never pin two copies or clobber the parked payload."""

    def test_replayed_key_keeps_first_copy(self, rx):
        from tosem_tpu_torch.cluster.transport import transport_counters
        dup0 = transport_counters()["streams"].value(("duplicate",))
        first = torch.arange(64, dtype=torch.int32)
        send_tensors(rx.address, {"key": "dup"}, {"a": first})
        send_tensors(rx.address, {"key": "dup"},
                     {"a": torch.zeros(64, dtype=torch.int32)})
        got = rx.pop("dup", timeout=10.0)
        assert got.arrays()["a"].tolist() == first.tolist()
        got.release()
        st = rx.stats()
        assert st["received"] == 2           # both fully drained
        assert st["pending_keys"] == []      # exactly ONE was parked
        assert transport_counters()["streams"].value(
            ("duplicate",)) == dup0 + 1

    def test_chaos_dup_stream_absorbed(self, rx):
        from tosem_tpu_torch.chaos import network as _net
        from tosem_tpu_torch.cluster.transport import transport_counters
        dup0 = transport_counters()["streams"].value(("duplicate",))
        try:
            _net.state().dup_stream(1)
            a = torch.arange(32, dtype=torch.float32)
            n = send_tensors(rx.address, {"key": "cd"}, {"a": a})
            assert n == 32 * 4                # caller sees ONE send
            got = rx.pop("cd", timeout=10.0)
            assert got.arrays()["a"].tolist() == a.tolist()
            got.release()
            deadline = time.time() + 5.0
            while rx.stats()["received"] < 2 and time.time() < deadline:
                time.sleep(0.01)             # replay drains async
            st = rx.stats()
            assert st["received"] == 2 and st["pending_keys"] == []
            assert transport_counters()["streams"].value(
                ("duplicate",)) == dup0 + 1
        finally:
            _net.state().reset()

    def test_keyless_stream_neither_replays_nor_eats_armed_dup(self, rx):
        from tosem_tpu_torch.chaos import network as _net
        from tosem_tpu_torch.cluster.transport import transport_counters
        dup0 = transport_counters()["streams"].value(("duplicate",))
        try:
            _net.state().dup_stream(1)
            send_tensors(rx.address, {}, {"a": torch.zeros(8)})
            got = rx.take(timeout=10.0)      # delivered exactly once
            got.release()
            assert rx.stats()["received"] == 1
            a = torch.arange(16, dtype=torch.float32)
            send_tensors(rx.address, {"key": "kd"}, {"a": a})
            got = rx.pop("kd", timeout=10.0)
            got.release()
            deadline = time.time() + 5.0
            while rx.stats()["received"] < 3 and time.time() < deadline:
                time.sleep(0.01)             # keyed replay drains async
            st = rx.stats()
            assert st["received"] == 3       # keyless + keyed + replay
            assert st["pending_keys"] == []
            assert transport_counters()["streams"].value(
                ("duplicate",)) == dup0 + 1
        finally:
            _net.state().reset()

    def test_partitioned_stream_drops_typed(self, rx):
        from tosem_tpu_torch.chaos import network as _net
        try:
            _net.state().partition(["src"], ["dst"])
            with pytest.raises(TransportError):
                send_tensors(rx.address,
                             {"key": "p", "src_node": "src",
                              "dst_node": "dst"},
                             {"a": torch.zeros(4)})
            assert rx.stats()["received"] == 0
        finally:
            _net.state().reset()


# ------------------------------------------ the wire the packages share


@pytest.fixture()
def ref_rx():
    from tosem_tpu.cluster.transport import TensorReceiver as RefReceiver
    r = RefReceiver()
    yield r
    r.shutdown()


def _ref_pool(dtype, num_pages=8, seed=5):
    import jax.numpy as jnp
    from tosem_tpu.serve.kv_cache import LocalSpillStore as JStore
    from tosem_tpu.serve.kv_cache import PagedKVCache as JCache
    c = JCache(num_pages, page_size=4, layers=2, heads=2, head_dim=8,
               dtype=dtype, spill_store=JStore())
    rng = np.random.default_rng(seed)
    c.set_pools(
        jnp.asarray(rng.standard_normal(c.k_pool.shape), jnp.dtype(dtype)),
        jnp.asarray(rng.standard_normal(c.v_pool.shape), jnp.dtype(dtype)))
    return c


class TestAcrossPackages:
    def test_port_sender_reference_receiver(self, ref_rx):
        a = torch.arange(300, dtype=torch.bfloat16) / 3
        b = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        send_tensors(ref_rx.address, {"key": "x"}, {"a": a, "b": b,
                                                    "s": torch.tensor(5)},
                     chunk_bytes=128)
        got = ref_rx.pop("x", timeout=10.0)
        arrs = got.arrays()
        assert str(arrs["a"].dtype) == "bfloat16"
        assert arrs["a"].tobytes() == _bytes(a)
        assert arrs["b"].dtype == np.float32 and arrs["b"].shape == (3, 4)
        assert arrs["b"].tobytes() == _bytes(b)
        assert arrs["s"].shape == () and int(arrs["s"]) == 5
        got.release()

    def test_reference_sender_port_receiver(self, rx):
        import jax.numpy as jnp
        from tosem_tpu.cluster.transport import send_tensors as ref_send
        a = np.asarray(jnp.arange(300, dtype=jnp.bfloat16) / 3)
        b = np.arange(12, dtype=np.int64).reshape(3, 4)
        ref_send(rx.address, {"key": "y"}, {"a": a, "b": b},
                 chunk_bytes=128)
        got = rx.pop("y", timeout=10.0)
        arrs = got.arrays()
        assert arrs["a"].dtype == torch.bfloat16
        assert _bytes(arrs["a"]) == a.tobytes()
        assert arrs["b"].dtype == torch.int64
        assert torch.equal(arrs["b"], torch.from_numpy(b))
        got.release()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_kv_payload_lands_in_the_reference(self, ref_rx, dtype):
        from tosem_tpu.cluster.transport import \
            received_kv_payload as ref_received
        src = _port_pool(dtype)
        src.create("s")
        src.extend("s", 10)
        payload = src.export_seq("s")
        send_kv_payload(ref_rx.address, payload, key="s")
        got = ref_rx.pop("s", timeout=10.0)
        back = ref_received(got)
        assert str(back["k"].dtype) == dtype     # bfloat16, not uint16
        assert back["k"].tobytes() == payload["k"].tobytes()
        assert back["v"].tobytes() == payload["v"].tobytes()
        dst = _ref_pool(dtype)
        dst.import_seq("s", back)
        got.release()
        assert dst.length("s") == 10
        pages = np.asarray(dst.pages_of("s"))
        for pool_r, pool_p in ((dst.k_pool, src.k_pool),
                               (dst.v_pool, src.v_pool)):
            np.testing.assert_array_equal(
                np.asarray(pool_r[:, pages], np.float32),
                pool_p[:, src.pages_of("s")].float().numpy())

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_reference_kv_payload_lands_in_the_port(self, rx, dtype):
        from tosem_tpu.cluster.transport import send_kv_payload as ref_kv
        src = _ref_pool(dtype)
        src.create("r")
        src.extend("r", 10)
        payload = src.export_seq("r")
        ref_kv(rx.address, payload, key="r")
        got = rx.pop("r", timeout=10.0)
        assert got.arrays()["k"].dtype == getattr(torch, dtype)
        back = received_kv_payload(got)
        assert back["k"].tobytes() == np.asarray(payload["k"]).tobytes()
        assert back["v"].tobytes() == np.asarray(payload["v"]).tobytes()
        dst = _port_pool(dtype, seed=9)
        dst.import_seq("r", back)
        got.release()
        assert dst.length("r") == 10
        pages = np.asarray(src.pages_of("r"))
        for pool_r, pool_p in ((src.k_pool, dst.k_pool),
                               (src.v_pool, dst.v_pool)):
            np.testing.assert_array_equal(
                np.asarray(pool_r[:, pages], np.float32),
                pool_p[:, dst.pages_of("r")].float().numpy())


# ------------------------------------------- fences and the network state


def _acquire_epochs(path, n, out_q):
    from tosem_tpu_torch.cluster.fencing import EpochFence
    fence = EpochFence(path)
    out_q.put([fence.acquire() for _ in range(n)])


class TestEpochFence:
    def test_concurrent_cross_process_acquires_are_distinct(self, tmp_path):
        import multiprocessing as mp
        path = str(tmp_path / "fence.epoch")
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_acquire_epochs, args=(path, 25, q))
                 for _ in range(4)]
        for p in procs:
            p.start()
        epochs = []
        for _ in procs:
            epochs.extend(q.get(timeout=60))
        for p in procs:
            p.join(timeout=60)
        assert sorted(epochs) == list(range(1, 101))

    def test_stale_epoch_rejected_after_newer_acquire(self, tmp_path):
        from tosem_tpu_torch.cluster.fencing import EpochFence, StaleEpochError
        fence = EpochFence(str(tmp_path / "fence.epoch"))
        old = fence.acquire()
        new = fence.acquire()
        fence.check(new)                     # current holder passes
        with pytest.raises(StaleEpochError):
            fence.check(old)

    def test_watermark_holds_presented_epochs_only(self):
        from tosem_tpu_torch.cluster.fencing import StaleEpochError, Watermark
        w = Watermark()
        w.check(None)                        # an unfenced caller passes
        w.check(3)
        assert w.epoch == 3
        with pytest.raises(StaleEpochError, match="stale epoch 2"):
            w.check(2)
        assert w.advance(1) == 3 and w.advance(5) == 5


class TestNetworkState:
    def test_partition_is_bidirectional_until_healed(self):
        from tosem_tpu_torch.chaos.network import NetworkState
        net = NetworkState()
        net.partition(["a"], ["b", "c"])
        assert net.dropped("a", "c") and net.dropped("b", "a")
        assert not net.dropped("b", "c")
        net.heal()
        assert not net.dropped("a", "b")

    def test_slow_node_and_armed_duplicates(self):
        from tosem_tpu_torch.chaos.network import NetworkState
        net = NetworkState()
        net.slow_node("n1", 0.25)
        assert net.delay("n1") == 0.25 and net.delay("n2") == 0.0
        net.slow_node("n1", 0)
        assert net.delay("n1") == 0.0
        net.dup_stream(2)
        assert [net.take_dup() for _ in range(3)] == [True, True, False]
        net.partition(["x"], ["y"])
        net.dup_stream(1)
        net.reset()
        assert not net.dropped("x", "y") and not net.take_dup()
