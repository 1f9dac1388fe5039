"""The port's BERT serving backends on the CPU at ``preset="tiny"``, with
the JAX package's weights carried across: encode outputs and
teacher-forced decode logits held against the JAX backends at the bf16
tolerance (2e-2), and the port's own serving contracts (prefix hit ==
cold, packed == sequential, replay idempotency, poison inputs)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BF16_TOL = 2e-2
DEC = dict(max_batch=4, max_len=96, page_size=16, num_pages=48,
           max_new_tokens=8)
SHARED = [1 + (5 * j) % 97 for j in range(32)]      # 2 whole pages


def _params(backend):
    import jax
    return jax.tree_util.tree_map(np.asarray, backend._vs["params"])


@pytest.fixture(scope="module")
def ref_decode():
    from tosem_tpu.serve.backends import BertDecodeBackend
    return BertDecodeBackend(**DEC)


@pytest.fixture(scope="module")
def port_decode(ref_decode):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    return BertDecodeBackend(device="cpu", params=_params(ref_decode),
                             **DEC)


def test_encode_pooled_outputs_match_reference():
    from tosem_tpu.serve.backends import BertEncodeBackend as JEnc
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    ref = JEnc(max_batch=4)
    port = BertEncodeBackend(max_batch=4, device="cpu",
                             params=_params(ref))
    rng = np.random.default_rng(0)
    reqs = [{"ids": [int(t) for t in rng.integers(0, 128, size=n)]}
            for n in (5, 60, 127)]
    want = ref.call_batch(reqs)
    got = port.call_batch(reqs)
    for w, g in zip(want, got):
        assert g["len"] == w["len"]
        assert np.abs(g["pooled"] - w["pooled"]).max() <= BF16_TOL
    assert port.stats()["flash_dispatch"]["flash"] >= 1


@pytest.mark.parametrize("case", range(3))
def test_decode_teacher_forced_on_the_reference_stream(ref_decode,
                                                       port_decode, case):
    """Feed the JAX backend's greedy stream into the port: at every step
    the reference's token is within the bf16 tolerance of the port's
    top logit."""
    from tosem_tpu_torch.serve.backends import _DecodeSeq
    rng = np.random.default_rng(10 + case)
    prompt = [int(t) for t in rng.integers(0, 128, size=12 + 9 * case)]
    stream = ref_decode.call({"ids": prompt})["generated"]
    b = port_decode
    sid = f"tf{case}"
    b.cache.create(sid)
    b.cache.extend(sid, len(prompt))
    row = b._prefill_into_cache(sid, prompt)
    assert row[stream[0]] >= row.max() - BF16_TOL
    b._seqs[sid] = _DecodeSeq(prompt + [stream[0]], len(prompt))
    for tok in stream[1:]:
        start, _ = b.cache.extend(sid, 1)
        row = b._run_step([(sid, start)])[0]
        assert row[tok] >= row.max() - BF16_TOL
        b._seqs[sid].tokens.append(tok)
    b.release(sid)
    assert len(stream) == DEC["max_new_tokens"]


def _prompt(i):
    return {"ids": SHARED + [2 + i, 3 + i, 4 + i]}


def test_prefix_hit_stream_equals_cold_stream():
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    warm = BertDecodeBackend(device="cpu", **DEC)
    cold = BertDecodeBackend(device="cpu", prefix_cache=False, **DEC)
    want = [cold.call(_prompt(i))["tokens"] for i in range(4)]
    got = [warm.call(_prompt(i))["tokens"] for i in range(4)]
    assert got == want
    st = warm.cache_stats()
    assert st["prefix_hits"] >= 3 and warm.suffix_q == 64
    assert st["prefix_pages_reused"] >= 3 * 2
    assert st["reused_tokens"] >= 3 * 32


def test_packed_step_batch_equals_sequential_calls():
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    prompts = [{"ids": [int(t) for t in
                        np.random.default_rng(i).integers(0, 128, size=n)]}
               for i, n in enumerate((7, 20, 33))]
    solo = BertDecodeBackend(device="cpu", prefix_cache=False, **DEC)
    want = [solo.call(p)["generated"] for p in prompts]
    packed = BertDecodeBackend(device="cpu", prefix_cache=False, **DEC)
    for i, p in enumerate(prompts):
        packed.admit(i, p)
    live, step = [0, 1, 2], 0
    while live:
        outs = packed.step_batch(live, [step] * len(live))
        live = [s for s, o in zip(live, outs) if not o["done"]]
        step += 1
    assert [packed.result(i)["generated"] for i in range(3)] == want


def test_admit_and_step_replays_are_idempotent(port_decode):
    b = port_decode
    first = b.admit("r", {"ids": [5, 6, 7]})
    assert b.admit("r", {"ids": [5, 6, 7]})["token"] == first["token"]
    out0 = b.step_batch(["r"], [0])[0]
    length = b.cache.length("r")
    assert b.step_batch(["r"], [0])[0] == out0       # memo, no new step
    assert b.cache.length("r") == length
    with pytest.raises(RuntimeError):
        b.step_batch(["r"], [5])
    assert b.step_batch(["ghost"], [0])[0] == {"pending": True}
    b.release("r")


@pytest.mark.parametrize("ids", [[], [3, 128], [-1], list(range(96))])
def test_poison_requests_fail_alone(port_decode, ids):
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    with pytest.raises(ValueError):
        port_decode.admit("poison", {"ids": ids})
    assert "poison" not in port_decode._seqs
    if ids and len(ids) < 96:
        enc = BertEncodeBackend(max_batch=2, device="cpu")
        with pytest.raises(ValueError):
            enc.call({"ids": ids})


def test_prefill_pad_positions_never_land_in_a_page():
    """The JAX backend routes pad slots to page ``num_pages`` and relies
    on the scatter dropping them; the port writes real positions only."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    b = BertDecodeBackend(device="cpu", prefix_cache=False, **DEC)
    b.admit("s", {"ids": list(range(1, 21))})        # 20 = 16 + 4 tokens
    first, tail = b.cache.pages_of("s")
    others = [p for p in range(b.cache.num_pages) if p not in (first, tail)]
    for pool in (b.cache.k_pool, b.cache.v_pool):
        assert torch.all(pool[:, first].abs().sum(-1) > 0)
        assert torch.all(pool[:, tail, :4].abs().sum(-1) > 0)
        assert torch.all(pool[:, tail, 4:] == 0)
        assert torch.all(pool[:, others] == 0)


def test_pool_pressure_raises_and_allocates_nothing():
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.kv_cache import CachePressure
    b = BertDecodeBackend(device="cpu", max_batch=2, max_len=96,
                          page_size=16, num_pages=2, prefix_cache=False)
    with pytest.raises(CachePressure):
        b.admit("big", {"ids": list(range(40))})
    assert b.cache.stats()["pages_used"] == 0


def _tree(kind, seed):
    """The JAX-package parameter tree of a tiny backend at ``seed``."""
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    from tosem_tpu.serve.backends import BertEncodeBackend as JEnc
    ref = JDec(seed=seed, **DEC) if kind == "decode" else \
        JEnc(seed=seed, max_batch=2)
    return _params(ref)


def _served_logits(kind, be):
    """Logits through the backend's cached step callables, next to the
    same call on the backend's own model."""
    from tosem_tpu_torch.models.bert import pad_ids_batch
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 128, 20)]
    # 32 = the decode bucket of 20 tokens at page 16, and the encode pad
    ids, mask, _ = pad_ids_batch([prompt], 32, pad_batch_to=be.max_batch)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    if kind == "decode":
        be.cache.create("x")
        be.cache.extend("x", len(prompt))
        got = be._prefill_into_cache("x", prompt)
        own = be.model.prefill_fn()(ids[:1], mask[:1])[0][0, 19]
    else:
        got = be.call_batch([{"ids": prompt}], pad_to=32)[0]["pooled"]
        own = be.model.encode_fn(attn_fn=flash_attn_fn())(ids, mask)
        own = own[0, :20].float().mean(0)
    assert not own.requires_grad      # serving builds no autograd graph
    return got, own.float().numpy()


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_backends_never_share_step_callables(kind):
    """Two backends built in turn from different parameter trees run
    their own weights through their cached steps, even when the caller
    hands both trees over in one dict object (refilled in between), so
    nothing about the argument can tell them apart."""
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)
    params = {}

    def make(seed):
        params.clear()
        params.update(_tree(kind, seed))
        if kind == "decode":
            return BertDecodeBackend(device="cpu", params=params,
                                     prefix_cache=False, **DEC)
        return BertEncodeBackend(max_batch=2, device="cpu", params=params)
    first = make(1)
    got_a, own_a = _served_logits(kind, first)
    second = make(2)
    got_b, own_b = _served_logits(kind, second)
    np.testing.assert_array_equal(got_a, own_a)
    np.testing.assert_array_equal(got_b, own_b)
    assert not np.allclose(got_a, got_b, atol=1e-3)
    for be in (first, second):
        if kind == "decode":
            assert be._step_compiled() is be._step
        else:
            assert be._compiled(32) is be._fwd


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_dropped_backend_frees_its_model(kind):
    import gc
    import weakref

    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)
    if kind == "decode":
        be = BertDecodeBackend(device="cpu", **DEC)
        be.call({"ids": SHARED + [7], "max_new_tokens": 2})
    else:
        be = BertEncodeBackend(max_batch=2, device="cpu")
        be.call({"ids": [5, 6, 7]})
    assert be.stats()["compile_cache"]["entries"] >= 1
    model = weakref.ref(be.model)
    del be
    gc.collect()
    assert model() is None


@pytest.mark.parametrize("kw,req", [
    ({"window": 8}, None), ({"spec_k": 3}, None),
    ({}, {"ids": [1, 2], "n": 2}), ({}, {"ids": [1, 2], "session": "s"})])
def test_unported_modes_raise_naming_the_roadmap(kw, req):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b = BertDecodeBackend(device="cpu", **kw)
        b.admit("x", req)
