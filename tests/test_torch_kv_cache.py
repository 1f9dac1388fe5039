"""The port's paged KV cache against the JAX package's: the same sequence
of allocator operations gives the same pages, block tables, free-list
order and pool contents (copy-on-write copies included)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

GEOM = dict(num_pages=10, page_size=4, layers=2, heads=2, head_dim=8)


@pytest.fixture
def caches():
    import jax.numpy as jnp
    from tosem_tpu.serve.kv_cache import LocalSpillStore
    from tosem_tpu.serve.kv_cache import PagedKVCache as JCache
    from tosem_tpu_torch.serve.kv_cache import PagedKVCache
    ref = JCache(**GEOM, spill_store=LocalSpillStore())
    port = PagedKVCache(**GEOM, device="cpu")
    rng = np.random.default_rng(0)
    shape = (2, 10, 4, 2, 8)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    ref.set_pools(jnp.asarray(k), jnp.asarray(v))
    port.set_pools(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    return ref, port


def _same(ref, port, seqs):
    for s in seqs:
        assert port.pages_of(s) == ref.pages_of(s)
        assert port.length(s) == ref.length(s)
        np.testing.assert_array_equal(port.block_table(s, 6),
                                      ref.block_table(s, 6))
        assert port.page_offset(s) == ref.page_offset(s)
    assert port._free == ref._free
    assert port._refs == ref._refs
    np.testing.assert_array_equal(port.k_pool.numpy(),
                                  np.asarray(ref.k_pool))
    np.testing.assert_array_equal(port.v_pool.numpy(),
                                  np.asarray(ref.v_pool))
    st_r, st_p = ref.stats(), port.stats()
    for key in ("pages_total", "pages_used", "pages_free", "pages_shared",
                "sequences"):
        assert st_p[key] == st_r[key], key


def _apply(cache, ops):
    for op, *args in ops:
        getattr(cache, op)(*args)


OPS = [("create", "a"), ("extend", "a", 6), ("fork", "a", "b"),
       ("extend", "b", 1),                       # COW of the shared tail
       ("extend", "a", 3), ("fork_prefix", "a", "p", 2),
       ("create", "c"), ("extend", "c", 9), ("truncate", "c", 5),
       ("free", "a"), ("extend", "p", 2), ("truncate", "b", 2),
       ("free", "c"), ("create", "d"), ("extend", "d", 4)]


@pytest.mark.parametrize("n", list(range(1, len(OPS) + 1)))
def test_same_state_after_each_operation(caches, n):
    ref, port = caches
    _apply(ref, OPS[:n])
    _apply(port, OPS[:n])
    live = [s for s in ("a", "b", "c", "d", "p") if s in ref._seqs]
    _same(ref, port, live)


def test_pressure_is_all_or_nothing(caches):
    from tosem_tpu_torch.serve.kv_cache import CachePressure
    ref, port = caches
    for c in (ref, port):
        c.create("x")
        c.extend("x", 30)
    with pytest.raises(CachePressure):
        port.extend("x", 20)
    assert port.length("x") == 30 and len(port._free) == 2
    with pytest.raises(ValueError):
        port.truncate("x", 31)
    with pytest.raises(ValueError):
        port.fork_prefix("x", "y", 9)


def test_cow_copy_leaves_the_other_branch_untouched():
    from tosem_tpu_torch.serve.kv_cache import PagedKVCache
    c = PagedKVCache(**GEOM, device="cpu")
    c.create("a")
    c.extend("a", 3)
    c.k_pool[:, 0] = 1.0
    c.fork("a", "b")
    c.extend("b", 1)
    fresh = c.pages_of("b")[0]
    assert fresh != 0 and torch.all(c.k_pool[:, fresh] == 1.0)
    c.k_pool[:, fresh] = 2.0
    assert torch.all(c.k_pool[:, 0] == 1.0)
