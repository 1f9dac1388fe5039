"""The port's framework-neutral serving caches held against the JAX
package's: the prefix cache over each package's paged KV cache (the same
sequence of operations gives the same entries, hits, evictions and page
refcounts on both), and the step-callable cache keys."""
import dataclasses

import pytest
import torch

torch.set_num_threads(1)

PAGE = 4
GEOM = dict(num_pages=24, page_size=PAGE, layers=1, heads=1, head_dim=2)

A = list(range(1, 11))                  # 2 whole pages + 2 tokens
B = A[:8] + [40, 41, 42, 43, 44]        # shares A's 2 pages
C = [60 + i for i in range(13)]         # 3 whole pages, shares nothing


@pytest.fixture
def prefix_pair():
    from tosem_tpu.serve.kv_cache import LocalSpillStore
    from tosem_tpu.serve.kv_cache import PagedKVCache as JCache
    from tosem_tpu.serve.prefix_cache import PrefixCache as JPrefix
    from tosem_tpu_torch.serve.kv_cache import PagedKVCache
    from tosem_tpu_torch.serve.prefix_cache import PrefixCache
    ref = JCache(**GEOM, spill_store=LocalSpillStore())
    port = PagedKVCache(**GEOM, device="cpu")
    return ((ref, JPrefix(ref, PAGE, max_entries=5)),
            (port, PrefixCache(port, PAGE, max_entries=5)))


def _admit(cache, prefix, sid, ids):
    """What a decode backend's admit does with the two caches."""
    ent = prefix.lookup(ids)
    if ent is None:
        cache.create(sid)
        cache.extend(sid, len(ids))
        hit = None
    else:
        cache.fork(ent.cid, sid)
        cache.extend(sid, len(ids) - ent.depth * PAGE)
        hit = (ent.cid, ent.depth)
    return hit, prefix.insert(ids, sid)


def _lookup(cache, prefix, ids):
    ent = prefix.lookup(ids)
    return None if ent is None else (ent.cid, ent.depth, ent.hits)


PREFIX_OPS = [
    (_admit, "a", A), (_admit, "b", B), (_lookup, A[:9]),
    (_admit, "c", C),                   # 6 entries > 5: LRU eviction
    (_lookup, B + [7]),
    (lambda c, p: p.evict_one(),),
    (lambda c, p, s: c.free(s), "a"), (_lookup, A),
    (lambda c, p, cid: p.invalidate(cid), "__prefix__/4"),
    (_admit, "d", A + [99]),
    (lambda c, p: p.clear(),),
]


def _prefix_state(cache, prefix):
    ents = [(k, e.cid, e.depth, e.hash, e.hits)
            for k, e in prefix._by_key.items()]
    seqs = {s: cache.pages_of(s) for s in sorted(cache._seqs, key=str)}
    return (ents, prefix.digest(), prefix.stats(), list(cache._free),
            dict(cache._refs), seqs)


@pytest.mark.parametrize("n", list(range(1, len(PREFIX_OPS) + 1)))
def test_prefix_cache_same_state_after_each_operation(prefix_pair, n):
    (rc, rp), (pc, pp) = prefix_pair
    for fn, *args in PREFIX_OPS[:n]:
        assert fn(pc, pp, *args) == fn(rc, rp, *args)
    assert _prefix_state(pc, pp) == _prefix_state(rc, rp)


def test_prefix_hash_is_the_reference_wire_identity():
    from tosem_tpu.serve.prefix_cache import prefix_hash as j_hash
    from tosem_tpu_torch.serve.prefix_cache import prefix_hash
    for toks in ([], A, C, [2 ** 31 - 1, -5]):
        assert prefix_hash(toks) == j_hash(toks)


# ------------------------------------------------------- step-callable cache


def _tags(pkg):
    """The decode backend's tag and its program variants, built by each
    package's own ``model_tag`` over its own tiny config."""
    if pkg == "ref":
        from tosem_tpu.models.bert import BertConfig
        from tosem_tpu.serve.backends import model_tag
    else:
        from tosem_tpu_torch.models.bert import BertConfig
        from tosem_tpu_torch.serve.backends import model_tag
    cfg = BertConfig.tiny()
    one = model_tag("bert_decode", cfg, 0, page=16, pages=48)
    two = model_tag("bert_decode", dataclasses.replace(cfg, layers=3), 0,
                    page=16, pages=48)
    three = model_tag("bert_encode", cfg, 1, use_flash=True)
    return {"m1": one, "m1s": one + ";step", "m2": two, "m3": three}


@pytest.mark.parametrize("shape", [(4, 128), (1, 6, 16, 64)])
@pytest.mark.parametrize("model", ["m1", "m1s", "m2", "m3"])
def test_shape_keys_match_the_reference(model, shape):
    from tosem_tpu.serve.compile_cache import shape_key as j_key
    from tosem_tpu_torch.serve.compile_cache import shape_key
    ref, port = _tags("ref"), _tags("port")
    assert port[model] == ref[model]
    assert shape_key(port[model], shape, "bfloat16") == \
        j_key(ref[model], shape, "bfloat16")


def test_step_cache_builds_each_key_once():
    from tosem_tpu_torch.serve.compile_cache import StepCache, shape_key
    cache, built = StepCache(), []
    keys = [shape_key("m", (1, n), "float32") for n in (16, 32, 16, 16)]
    got = [cache.get_or_build(k, lambda k=k: built.append(k) or k[1])
           for k in keys]
    assert got == [(1, 16), (1, 32), (1, 16), (1, 16)]
    assert built == keys[:2] and len(cache) == 2 and keys[1] in cache
    assert cache.stats() == {"entries": 2, "hits": 2, "misses": 2}
