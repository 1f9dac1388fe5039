"""The decode microbench (``serve/bench_decode.py``) on the CPU.

Every leg at the JAX package's tiny sizes, one round, short windows:
each answer check of the reference raises inside the bench (paged ≡
re-encode, spec ≡ single, the window's page bound and evictions, the
beam group's page ratio, prefix warm ≡ cold, the session's suffix-only
prefill, no compile-cache miss after warm-up), so a run that returns
rows passed them. The speed floors ride the ratio rows, reported and
never raised. Across the packages, the bench's two backends on the JAX
package's tiny weights (seed 0, converted) give the reference's greedy
streams, with the re-encode's logits within ``TOLERANCES``; both
packages' decoders are built at fp32 for the comparison (at bf16 the
rows part by rounding, as in ``test_torch_decode_modes.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from tosem_tpu_torch.serve import bench_decode as bd

torch.set_num_threads(1)

ALL_IDS = ({"decode_naive_c1", "decode_paged_c1", "decode_naive_c16",
            "decode_paged_c16", "decode_speedup_c16",
            "decode_paged_c16_p50_ms", "decode_paged_c16_p99_ms"}
           | {b for ids in bd.SCENARIO_BENCHES.values() for b in ids})


def test_every_leg_at_tiny_sizes():
    stats = []
    rows = bd.run_decode_benchmarks(trials=1, min_s=0.05, quiet=True,
                                    device="cpu", replica_stats=stats)
    by_id = {r.bench_id: r for r in rows}
    assert set(by_id) == ALL_IDS
    assert all(r.value > 0 or r.bench_id == "decode_prefix_session_"
               "suffix_frac" for r in rows)
    # the reference's speed floors are reported beside their ratios
    for bid, floor in bd.SPEED_FLOORS.items():
        extra = by_id[bid].extra
        assert extra["reference_floor"] == floor
        assert extra["floor_met"] == (by_id[bid].value >= floor)
    # the window arm's live pages respect ceil(w/page) + 2
    win = by_id["decode_window_t8192"].extra
    assert win["live_pages_per_seq"] <= win["live_pages_bound"] == \
        -(-bd.WIN_W // bd.WIN_PAGE) + 2
    assert win["pages_evicted"] > 0
    assert by_id["decode_beam_pages_ratio"].value <= 1.5
    assert by_id["decode_paged_c16"].extra[
        "compile_cache_misses_during_rounds"] == 0
    assert 0 < by_id["decode_prefix_session_suffix_frac"].value < 0.05
    assert by_id["decode_prefix_warm_ttft_ms"].extra["prefix_hit_rate"] > 0
    assert {r.extra["preset"] for r in rows} == {"tiny"}
    # every deployed replica reported before it retired
    assert [s["deployment"] for s in stats] == [
        "bench-decode", "bench-recode", "bench-spec", "bench-single",
        "bench-beam", "bench-prefix-sess"]
    assert all(s["compile_cache"]["misses"] > 0 for s in stats)


def test_scenario_subset_runs_only_its_legs():
    rows = bd.run_decode_benchmarks(
        trials=1, min_s=0.05, quiet=True, device="cpu",
        only=set(bd.SCENARIO_BENCHES["beam"]))
    assert {r.bench_id for r in rows} == set(bd.SCENARIO_BENCHES["beam"])


def test_a_speed_floor_is_reported_not_raised():
    em = bd.SuiteEmitter("decode")
    em.emit_floored("decode_window_speedup_t8192", "x", [0.5, 0.9], 2.0)
    em.emit_floored("decode_spec_speedup_c8", "y", [1.2, 1.6], 1.5)
    assert [(r.extra["reference_floor"], r.extra["floor_met"])
            for r in em.rows] == [(2.0, False), (1.5, True)]
    assert em.emit_floored("decode_x", "z", [], 2.0) is None


def test_naive_backend_equals_the_paged_backend():
    """The pin the base leg raises on, in process: the re-encode arm and
    the paged arm emit the same greedy stream (bf16, the tiny model)."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    naive = bd.NaiveRecodeBackend(max_len=bd.MODEL_KW["max_len"],
                                  page_size=bd.MODEL_KW["page_size"],
                                  max_new_tokens=32, device="cpu")
    paged = BertDecodeBackend(**bd.MODEL_KW, device="cpu")
    for i in range(3):
        want = paged.call(bd._prompt(i))
        got = naive.call(bd._prompt(i))
        assert got["tokens"] == want["tokens"]
        assert len(got["generated"]) == 32
    assert naive.stats()["compile_cache"]["misses"] == 3   # 3 buckets


@pytest.fixture
def fp32_configs(monkeypatch):
    """Both packages' decoders built at float32."""
    import tosem_tpu.models.bert as jbert
    import tosem_tpu_torch.models.bert as tbert

    @dataclasses.dataclass(frozen=True)
    class RefConfig32(jbert.BertConfig):
        dtype: str = "float32"

    @dataclasses.dataclass(frozen=True)
    class PortConfig32(tbert.BertConfig):
        dtype: str = "float32"

    monkeypatch.setattr(jbert, "BertConfig", RefConfig32)
    monkeypatch.setattr(tbert, "BertConfig", PortConfig32)


def test_bench_backends_give_the_reference_s_streams(fp32_configs):
    import jax

    from tosem_tpu.ops.parity import TOLERANCES
    from tosem_tpu.serve import bench_decode as ref_bd
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = dict(max_len=bd.MODEL_KW["max_len"],
              page_size=bd.MODEL_KW["page_size"], max_new_tokens=16)
    ref_naive = ref_bd.NaiveRecodeBackend(**kw)
    ref_paged = JDec(**dict(bd.MODEL_KW, max_new_tokens=16))
    params = jax.tree_util.tree_map(np.asarray, ref_naive._vs["params"])
    naive = bd.NaiveRecodeBackend(**kw, device="cpu", params=params)
    paged = BertDecodeBackend(**dict(bd.MODEL_KW, max_new_tokens=16),
                              device="cpu", params=params)
    assert naive.cfg.dtype == "float32" and paged.cfg.dtype == "float32"
    tol = TOLERANCES["flash"]["float32"]
    for i in range(3):
        want = ref_naive.call(bd._prompt(i))["tokens"]
        assert ref_paged.call(bd._prompt(i))["tokens"] == want
        assert naive.call(bd._prompt(i))["tokens"] == want
        assert paged.call(bd._prompt(i))["tokens"] == want
        # the re-encode's last prefill, both packages, same bucket
        T = len(want) - 1
        bucket = -(-T // kw["page_size"]) * kw["page_size"]
        ids = np.zeros((1, bucket), np.int32)
        mask = np.zeros((1, bucket), np.int32)
        ids[0, :T] = want[:T]
        mask[0, :T] = 1
        ref_logits = np.asarray(ref_naive._compiled(bucket)(ids, mask)[0])
        got = naive._compiled(bucket)(torch.as_tensor(ids),
                                      torch.as_tensor(mask))[0].numpy()
        np.testing.assert_allclose(got[0, :T], ref_logits[0, :T],
                                   rtol=tol, atol=tol)
