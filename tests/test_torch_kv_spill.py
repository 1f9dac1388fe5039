"""The port's KV spill tier, window eviction and wire format on the CPU.

Copies, against :mod:`tosem_tpu_torch.serve.kv_cache`, of the JAX
package's ``tests/test_kv_cache.py`` spill tests (round trip, pressure,
lost payloads, forks across spills, payload reclamation, the runtime
store), ``tests/test_kv_migration.py``'s ``TestWireFormat`` and
``TestCacheMigration``, and ``tests/test_decode_modes.py``'s cache tests
(``release_below``, ``truncate``, a spill carrying its page offset).

Across packages, in both directions and in fp32 and bf16: a payload the
JAX package's cache cuts imports into the port's cache, and the port's
paged attention over it equals the JAX package's over the source within
``TOLERANCES["paged"]``; a payload the port cuts imports into the JAX
package's cache and holds the same pages. The port carries bf16 page
bytes as ``uint16`` (numpy has no bfloat16, and the port does not import
``ml_dtypes``), which the JAX package's import would cast as numbers, so
this test views those bits as ``ml_dtypes.bfloat16`` on its side before
handing the payload over (``ROADMAP.md`` C5).
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.serve.kv_cache import (KV_WIRE_VERSION, CachePressure,
                                            KVWireError, LocalSpillStore,
                                            PagedKVCache, PagesLostError,
                                            RuntimeSpillStore)

torch.set_num_threads(1)


def make_cache(num_pages=8, page_size=4, **kw):
    kw.setdefault("layers", 2)
    kw.setdefault("heads", 2)
    kw.setdefault("head_dim", 4)
    kw.setdefault("spill_store", LocalSpillStore())
    kw.setdefault("device", "cpu")
    return PagedKVCache(num_pages, page_size, **kw)


def fill_pages(cache, seq_id, seed=0):
    """Write recognizable bytes into a sequence's pages (the allocator
    moves pages around; contents must follow)."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(cache.pages_of(seq_id), dtype=torch.long)
    shape = (cache.layers, len(idx), cache.page_size, cache.heads,
             cache.head_dim)
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    cache.k_pool[:, idx] = k.to(cache.k_pool.dtype)
    cache.v_pool[:, idx] = v.to(cache.v_pool.dtype)
    return k, v


def gather(cache, seq_id):
    idx = torch.as_tensor(cache.pages_of(seq_id), dtype=torch.long)
    return cache.k_pool[:, idx].clone(), cache.v_pool[:, idx].clone()


# ------------------------------------------- tests/test_kv_cache.py spill


def test_spill_restore_round_trip_is_byte_identical():
    c = make_cache(num_pages=4)
    c.create("a")
    c.extend("a", 7)
    fill_pages(c, "a")
    k0, v0 = gather(c, "a")
    c.spill("a")
    assert c.is_spilled("a")
    assert c.stats()["pages_used"] == 0
    assert c.stats()["pages_spilled"] == 2
    assert c.length("a") == 7              # length visible while spilled
    # churn the pool so the restore lands on different physical pages
    c.create("x")
    c.extend("x", 4)
    c.restore("a")
    assert not c.is_spilled("a")
    k1, v1 = gather(c, "a")
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert c.length("a") == 7


def test_restore_under_pressure_changes_nothing():
    c = make_cache(num_pages=2)
    c.create("a")
    c.extend("a", 8)                       # both pages
    c.spill("a")
    c.create("b")
    c.extend("b", 8)                       # pool full again
    with pytest.raises(CachePressure):
        c.restore("a")
    assert c.is_spilled("a")               # still parked, payload intact
    c.free("b")
    c.restore("a")
    assert c.length("a") == 8


def test_lost_payload_raises_and_drop_spilled_recovers():
    store = LocalSpillStore()
    c = make_cache(spill_store=store)
    c.create("a")
    c.extend("a", 4)
    c.spill("a")
    store._data.clear()                    # chaos: the payload is gone
    with pytest.raises(PagesLostError):
        c.restore("a")
    c.drop_spilled("a")                    # the re-prefill path
    c.create("a")
    c.extend("a", 4)
    assert c.length("a") == 4


def test_create_duplicate_and_spilled_duplicate_rejected():
    c = make_cache()
    c.create("a")
    with pytest.raises(ValueError):
        c.create("a")
    c.extend("a", 1)
    c.spill("a")
    with pytest.raises(ValueError):
        c.create("a")                      # spilled still owns the name


def test_stats_counts():
    c = make_cache(num_pages=6)
    c.create("a")
    c.extend("a", 8)
    c.create("b")
    c.extend("b", 4)
    c.spill("b")
    assert c.stats() == {"pages_total": 6, "pages_used": 2,
                         "pages_free": 4, "pages_shared": 0,
                         "pages_spilled": 1, "pages_evicted_total": 0,
                         "sequences": 1, "sequences_spilled": 1}


def test_forked_child_survives_parent_spill_and_restore():
    c = make_cache(num_pages=12)
    c.create("a")
    c.extend("a", 9)
    fill_pages(c, "a")
    c.fork("a", "b")
    child_before = gather(c, "b")
    c.spill("a")                           # parent demoted
    assert torch.equal(gather(c, "b")[0], child_before[0])
    c.extend("b", 1)                       # child keeps decoding (COW)
    c.restore("a")                         # parent back on FRESH pages
    assert torch.equal(gather(c, "a")[0], child_before[0])
    assert not set(c.pages_of("a")) & set(c.pages_of("b")[:2])
    c.free("a")
    c.free("b")
    assert c.stats()["pages_used"] == 0    # refcounts never double-free


def test_parent_drop_spilled_leaves_child_intact():
    c = make_cache(num_pages=12)
    c.create("a")
    c.extend("a", 9)
    fill_pages(c, "a")
    c.fork("a", "b")
    before = gather(c, "b")
    c.spill("a")
    c.drop_spilled("a")
    assert torch.equal(gather(c, "b")[0], before[0])
    c.free("b")
    assert c.stats()["pages_used"] == 0
    assert c.stats()["sequences_spilled"] == 0


def test_both_forks_spilled_restore_independently():
    c = make_cache(num_pages=16)
    c.create("a")
    c.extend("a", 9)
    fill_pages(c, "a")
    c.fork("a", "b")
    shared = gather(c, "a")
    c.spill("a")
    c.spill("b")
    assert c.stats()["pages_used"] == 0    # shared pages freed ONCE each
    c.restore("b")
    c.restore("a")
    assert torch.equal(gather(c, "a")[0], shared[0])
    assert torch.equal(gather(c, "b")[0], shared[0])
    c.free("a")
    c.free("b")
    assert c.stats()["pages_used"] == 0


@pytest.mark.parametrize("retire", ["free", "restore"])
def test_retiring_a_spilled_sequence_reclaims_its_payload(retire):
    store = LocalSpillStore()
    c = make_cache(spill_store=store)
    c.create("a")
    c.extend("a", 4)
    c.spill("a")
    assert len(store._data) == 1
    getattr(c, retire)("a")
    assert len(store._data) == 0


@pytest.fixture
def port_runtime():
    import tosem_tpu_torch.runtime as rt
    rt.init(num_workers=1, memory_monitor=False)
    try:
        yield rt
    finally:
        rt.shutdown()


def _runtime_kv_cache():
    return make_cache(num_pages=8, page_size=64, layers=2, heads=8,
                      head_dim=32, spill_store=RuntimeSpillStore())


def _in_store(ref):
    from tosem_tpu_torch.runtime import api
    from tosem_tpu_torch.runtime.object_store import ObjectID
    return api._runtime.store.contains(ObjectID(ref.oid.binary))


def test_runtime_spill_drop_frees_store_object(port_runtime):
    """``RuntimeSpillStore.drop`` frees the payload's store object at
    once, not at the driver's reference collection."""
    c = _runtime_kv_cache()
    c.create("a")
    c.extend("a", 256)                     # 4 pages, ~512 KB of payload
    c.spill("a")
    ref = c._spilled["a"].ref
    assert _in_store(ref)
    c.free("a")
    assert not _in_store(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runtime_spill_restore_round_trip_mapped(port_runtime, dtype):
    """Through the runtime store and its mapped (read-only, no heap
    copy) read, a restore is bit for bit and frees the payload."""
    c = make_cache(num_pages=8, page_size=64, layers=2, heads=8,
                   head_dim=32, dtype=dtype, spill_store=RuntimeSpillStore())
    c.create("a")
    c.extend("a", 200)
    fill_pages(c, "a", seed=3)
    k0, v0 = gather(c, "a")
    c.spill("a")
    ref = c._spilled["a"].ref
    c.restore("a")
    k1, v1 = gather(c, "a")
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert not _in_store(ref)


# ----------------------------- tests/test_decode_modes.py cache section


def small_cache():
    return PagedKVCache(16, 4, layers=1, heads=1, head_dim=8,
                        spill_store=LocalSpillStore(), device="cpu")


def test_release_below_frees_leading_pages_and_counts():
    c = small_cache()
    c.create("a")
    c.extend("a", 15)                 # pages 0..3 (page_size 4)
    free0 = c.stats()["pages_free"]
    assert c.release_below("a", 9) == 2    # pages 0, 1 below pos 9
    assert c.page_offset("a") == 2
    assert c.stats()["pages_free"] == free0 + 2
    assert c.stats()["pages_evicted_total"] == 2
    assert len(c.pages_of("a")) == 2
    assert c.extend("a", 1) == (15, 16)
    c.release_below("a", 999)         # the newest page always stays
    assert len(c.pages_of("a")) == 1


def test_truncate_rolls_back_pages_via_refcounts():
    c = small_cache()
    c.create("a")
    c.extend("a", 10)                 # 3 pages
    used = c.stats()["pages_used"]
    c.truncate("a", 5)
    assert c.length("a") == 5
    assert c.stats()["pages_used"] == used - 1
    with pytest.raises(ValueError):
        c.truncate("a", 7)            # can't truncate UP
    c.fork("a", "b")
    c.truncate("a", 2)
    assert c.length("b") == 5         # sibling untouched
    c.extend("b", 1)
    c.free("a")
    c.free("b")
    assert c.stats()["pages_used"] == 0


def test_release_below_respects_fork_refcounts():
    c = small_cache()
    c.create("a")
    c.extend("a", 12)
    c.fork("a", "b")
    used = c.stats()["pages_used"]
    c.release_below("a", 9)           # b keeps pages 0, 1
    assert c.stats()["pages_used"] == used
    c.release_below("b", 9)
    assert c.stats()["pages_used"] == used - 2
    c.free("a")
    c.free("b")
    assert c.stats()["pages_used"] == 0


def test_truncate_into_released_pages_and_fork_prefix_refused():
    c = small_cache()
    c.create("a")
    c.extend("a", 15)
    c.release_below("a", 9)
    with pytest.raises(ValueError, match="released"):
        c.truncate("a", 7)
    with pytest.raises(ValueError, match="window-evicted"):
        c.fork_prefix("a", "p", 1)


def test_spill_restore_carries_released_offset():
    c = small_cache()
    c.create("a")
    c.extend("a", 15)
    c.k_pool.copy_(torch.arange(c.k_pool.numel(), dtype=torch.float32)
                   .reshape(c.k_pool.shape))
    c.release_below("a", 9)
    tail = gather(c, "a")[0]
    c.spill("a")
    c.restore("a")
    assert c.page_offset("a") == 2
    assert c.length("a") == 15
    assert torch.equal(gather(c, "a")[0], tail)


# --------------------------------------- tests/test_kv_migration.py caches


def _pool(num_pages=8, page_size=4, layers=2, heads=2, head_dim=8, seed=0,
          dtype="float32"):
    c = PagedKVCache(num_pages, page_size, layers=layers, heads=heads,
                     head_dim=head_dim, dtype=dtype, device="cpu",
                     spill_store=LocalSpillStore())
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    c.k_pool.copy_(torch.from_numpy(
        rng.standard_normal(tuple(c.k_pool.shape)).astype(np.float32)
    ).to(tdt))
    c.v_pool.copy_(torch.from_numpy(
        rng.standard_normal(tuple(c.v_pool.shape)).astype(np.float32)
    ).to(tdt))
    return c


class TestWireFormat:
    def test_spill_payload_carries_versioned_header(self):
        c = _pool()
        c.create("a")
        c.extend("a", 10)
        h = c.export_seq("a")["header"]
        assert h["version"] == KV_WIRE_VERSION
        assert h["layout"] == "lpshd"
        assert h["page_size"] == 4 and h["dtype"] == "float32"
        assert h["n_pages"] == 3 and h["length"] == 10
        assert h["page_offset"] == 0

    def test_import_into_mismatched_pool_raises_typed(self):
        c = _pool()
        c.create("a")
        c.extend("a", 10)
        payload = c.export_seq("a")
        for kw in (dict(page_size=8), dict(dtype="bfloat16"),
                   dict(layers=1), dict(heads=4)):
            bad = _pool(**kw)
            with pytest.raises(KVWireError):
                bad.import_seq("a", payload)
            assert bad.stats()["pages_used"] == 0   # nothing changed

    def test_version_and_layout_mismatch_rejected(self):
        c = _pool()
        c.create("a")
        c.extend("a", 4)
        good = c.export_seq("a")
        dst = _pool()
        for header in ({**good["header"], "version": 99},
                       {**good["header"], "layout": "phsld"}, None):
            with pytest.raises(KVWireError):
                dst.import_seq("x", {**good, "header": header})

    def test_restore_validates_header(self):
        c = _pool()
        c.create("a")
        c.extend("a", 6)
        c.spill("a")
        payload = c._spill_store.get(c._spilled["a"].ref)
        payload["header"] = {**payload["header"], "version": 99}
        with pytest.raises(KVWireError):
            c.restore("a")

    def test_array_shape_must_match_header(self):
        c = _pool()
        c.create("a")
        c.extend("a", 10)
        payload = c.export_seq("a")
        bad = dict(payload)
        bad["k"] = payload["k"][:, :1]
        with pytest.raises(KVWireError):
            _pool().import_seq("a", bad)

    def test_bf16_payload_is_uint16_bits_and_values_never_convert(self):
        c = _pool(dtype="bfloat16")
        c.create("a")
        c.extend("a", 10)
        payload = c.export_seq("a")
        assert payload["header"]["dtype"] == "bfloat16"
        assert payload["k"].dtype == np.uint16
        dst = _pool(dtype="bfloat16", seed=5)
        dst.import_seq("a", payload)
        assert torch.equal(gather(dst, "a")[0], gather(c, "a")[0])
        # a float array for a bf16 pool is refused, not cast
        with pytest.raises(KVWireError, match="uint16 or bfloat16"):
            _pool(dtype="bfloat16").import_seq(
                "b", {**payload, "k": payload["k"].astype(np.float32),
                      "v": payload["v"].astype(np.float32)})


class TestCacheMigration:
    def test_export_import_bit_identical_attention(self):
        from tosem_tpu_torch.ops.paged_attention import paged_attention
        src = _pool(seed=1)
        dst = _pool(seed=2)                  # different resident bytes
        src.create("s")
        src.extend("s", 10)
        dst.import_seq("s", src.export_seq("s"))
        q = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (1, 2, 8)).astype(np.float32))
        sl = torch.tensor([10], dtype=torch.int32)
        outs = [paged_attention(
            q, c.k_pool[0], c.v_pool[0],
            torch.from_numpy(c.block_table("s", 3)[None]), sl)
            for c in (src, dst)]
        assert torch.equal(outs[0], outs[1])

    def test_export_leaves_source_untouched(self):
        src = _pool()
        src.create("s")
        src.extend("s", 10)
        before = src.stats()
        refs = dict(src._refs)
        src.export_seq("s")
        assert src.stats() == before
        assert dict(src._refs) == refs

    def test_import_all_or_nothing_under_pressure(self):
        src = _pool(num_pages=8)
        src.create("s")
        src.extend("s", 20)                  # 5 pages
        payload = src.export_seq("s")
        dst = _pool(num_pages=8)
        dst.create("hog")
        dst.extend("hog", 20)                # 5 of 8 pages taken
        with pytest.raises(CachePressure):
            dst.import_seq("s", payload)
        assert dst.stats()["pages_used"] == 5
        dst.free("hog")
        dst.import_seq("s", payload)

    def test_import_duplicate_id_rejected(self):
        src = _pool()
        src.create("s")
        src.extend("s", 4)
        with pytest.raises(ValueError):
            src.import_seq("s", src.export_seq("s"))

    def test_migrating_fork_leaves_sibling_refcounts_intact(self):
        src = _pool()
        src.create("a")
        src.extend("a", 6)                   # spans 2 pages
        src.fork("a", "b")
        refs_shared = dict(src._refs)
        assert any(v == 2 for v in refs_shared.values())
        _pool().import_seq("b", src.export_seq("b"))
        assert dict(src._refs) == refs_shared
        src.free("b")
        assert all(v == 1 for v in src._refs.values())
        assert len(src.pages_of("a")) == 2

    def test_migration_mid_spill(self):
        src = _pool()
        src.create("s")
        src.extend("s", 10)
        expect_k = src.export_seq("s")["k"].tobytes()
        src.spill("s")
        payload = src.export_seq("s")        # export of a SPILLED seq
        assert payload["k"].tobytes() == expect_k
        dst = _pool()
        dst.import_seq("s", payload)
        assert dst.length("s") == 10
        assert not dst.is_spilled("s")

    def test_window_offset_survives_migration(self):
        src = _pool(num_pages=16)
        src.create("w")
        src.extend("w", 14)                  # 4 pages
        src.release_below("w", 9)
        assert src.page_offset("w") == 2
        payload = src.export_seq("w")
        assert payload["header"]["page_offset"] == 2
        dst = _pool(num_pages=16)
        dst.import_seq("w", payload)
        assert dst.page_offset("w") == 2
        assert dst.length("w") == 14


# --------------------------------------------------------- across packages


def _ref_pool(dtype, num_pages=10, seed=0, **geom):
    import jax.numpy as jnp
    from tosem_tpu.serve.kv_cache import LocalSpillStore as JStore
    from tosem_tpu.serve.kv_cache import PagedKVCache as JCache
    geom = {"page_size": 4, "layers": 2, "heads": 2, "head_dim": 16,
            **geom}
    c = JCache(num_pages, dtype=dtype, spill_store=JStore(), **geom)
    rng = np.random.default_rng(seed)
    c.set_pools(
        jnp.asarray(rng.standard_normal(c.k_pool.shape), jnp.dtype(dtype)),
        jnp.asarray(rng.standard_normal(c.v_pool.shape), jnp.dtype(dtype)))
    return c


GEOM16 = dict(page_size=4, layers=2, heads=2, head_dim=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_payload_imports_into_the_port(dtype):
    """A (window-evicted) sequence cut by the JAX package's cache: the
    port's import holds its bytes, offset and length, and the port's
    paged attention over it (rolling table, window, offsets) equals the
    JAX package's over the source within ``TOLERANCES["paged"]``."""
    import jax.numpy as jnp
    from tosem_tpu.ops.paged_attention import paged_attention as jpa
    from tosem_tpu.ops.parity import TOLERANCES
    from tosem_tpu_torch.models.convert import array_to_tensor
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    ref = _ref_pool(dtype, seed=1)
    ref.create("w")
    ref.extend("w", 22)                      # 6 pages of 4
    ref.release_below("w", 13)               # 3 leading pages gone
    payload = ref.export_seq("w")
    port = _pool(num_pages=10, seed=2, dtype=dtype, **GEOM16)
    port.import_seq("w", payload)
    assert port.page_offset("w") == 3 and port.length("w") == 22
    np.testing.assert_array_equal(
        port.k_pool[:, port.pages_of("w")].float().numpy(),
        np.asarray(payload["k"], np.float32))
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 2, 16)).astype(np.float32)
    kw = dict(window=9)
    want = jpa(jnp.asarray(q, jnp.dtype(dtype)), ref.k_pool[1],
               ref.v_pool[1], jnp.asarray(ref.block_table("w", 4)[None]),
               jnp.asarray([22], jnp.int32), impl="xla",
               page_offsets=jnp.asarray([3], jnp.int32), **kw)
    got = paged_attention(
        array_to_tensor(np.asarray(jnp.asarray(q, jnp.dtype(dtype)))),
        port.k_pool[1], port.v_pool[1],
        torch.from_numpy(port.block_table("w", 4)[None]),
        torch.tensor([22], dtype=torch.int32),
        page_offsets=torch.tensor([3], dtype=torch.int32), **kw)
    err = np.abs(got.float().numpy()
                 - np.asarray(want, np.float32)).max()
    assert err <= TOLERANCES["paged"][dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_payload_imports_into_the_reference(dtype):
    """The other way: the port's payload lands in the JAX package's
    cache with the same page values, offset and length (bf16 bits viewed
    as ``ml_dtypes.bfloat16`` on this side, ROADMAP.md C5)."""
    import ml_dtypes
    port = _pool(num_pages=10, seed=4, dtype=dtype, **GEOM16)
    port.create("w")
    port.extend("w", 22)
    port.release_below("w", 13)
    payload = port.export_seq("w")
    if dtype == "bfloat16":
        assert payload["k"].dtype == np.uint16
        payload = {**payload, "k": payload["k"].view(ml_dtypes.bfloat16),
                   "v": payload["v"].view(ml_dtypes.bfloat16)}
    ref = _ref_pool(dtype, seed=5)
    ref.import_seq("w", payload)
    assert ref.page_offset("w") == 3 and ref.length("w") == 22
    pages = np.asarray(ref.pages_of("w"))
    for pool_r, pool_p in ((ref.k_pool, port.k_pool),
                           (ref.v_pool, port.v_pool)):
        got = np.asarray(pool_r[:, pages], np.float32)
        want = pool_p[:, port.pages_of("w")].float().numpy()
        np.testing.assert_array_equal(got, want)
