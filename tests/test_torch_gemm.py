"""The port's GEMM (``tosem_tpu_torch/ops/gemm.py``) and timing pieces
(``utils/timing.py``: ``BenchStats``, ``time_fn``, ``chain_overhead``,
``conv2d_flops``) held against the JAX package's on the CPU.

Operands come from seeded numpy (or the port's ``gemm_operands``) and go
through both packages' ``gemm``: fp32 within 1e-5, int8 bit for bit.
``tests/test_ops.py::TestGemm`` is copied without wall-clock asserts
(ROADMAP.md C-ref2): a CPU time is never a device's speed."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _ref_gemm(a, b, precision="float32"):
    import jax.numpy as jnp
    from tosem_tpu.ops.gemm import gemm
    return np.asarray(gemm(jnp.asarray(a), jnp.asarray(b), precision))


@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (33, 70, 17)])
def test_fp32_gemm_matches_reference(m, k, n):
    from tosem_tpu_torch.ops.gemm import gemm
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    got = gemm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = _ref_gemm(a, b)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the yardstick: the product of a transposed operand breaks it
    bad = gemm(torch.from_numpy(a), torch.from_numpy(
        np.ascontiguousarray(b[::-1]))).numpy()
    assert np.abs(bad - want).max() > 1e-2


@pytest.mark.parametrize("m", [64, 40])
def test_int8_gemm_equals_reference_bit_for_bit(m):
    from tosem_tpu_torch.ops.gemm import GemmSpec, gemm, gemm_operands
    a, b = gemm_operands(GemmSpec(m, 64, 64, "int8", "default"),
                         device="cpu")
    assert b.stride() == (1, 64)             # column-major, same values
    got = gemm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, gemm(a, b.contiguous()))
    want = _ref_gemm(a.numpy(), b.numpy(), "default")
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_gemm_within_bf16_of_reference():
    import jax.numpy as jnp
    from tosem_tpu_torch.ops.gemm import gemm
    rng = np.random.default_rng(3)
    a = rng.standard_normal((32, 64), dtype=np.float32)
    b = rng.standard_normal((64, 16), dtype=np.float32)
    got = gemm(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
               "default").float().numpy()
    want = _ref_gemm(jnp.asarray(a, jnp.bfloat16), jnp.asarray(
        b, jnp.bfloat16), "default").astype(np.float32)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    # fp32 products of the unrounded operands differ by more: the check
    # sees the operands' bf16 rounding
    exact = a @ b
    assert np.abs(exact - want).max() > 1e-4 * scale


def test_sweep_and_ids_equal_the_reference():
    import importlib
    ref = importlib.import_module("tosem_tpu.ops.gemm")
    port = importlib.import_module("tosem_tpu_torch.ops.gemm")
    assert [(s.m, s.n, s.k, s.dtype, s.precision)
            for s in port.DEFAULT_GEMM_SWEEP] == \
        [(s.m, s.n, s.k, s.dtype, s.precision)
         for s in ref.DEFAULT_GEMM_SWEEP]
    for p, r in zip(port.DEFAULT_GEMM_SWEEP, ref.DEFAULT_GEMM_SWEEP):
        assert p.bench_id == r.bench_id and p.flops == r.flops


def test_bench_row_has_the_reference_keys():
    from tosem_tpu_torch.ops.gemm import GemmSpec, gemm_bench
    spec = GemmSpec(64, 64, 64)
    stats, row = gemm_bench(spec, n_iter=4, reps=1, device="cpu")
    assert row.config == "gemm" and row.metric == "gflops"
    assert row.unit == "GFLOPS" and row.device == "cpu"
    assert {"m", "n", "k", "dtype", "precision", "mean_ms", "bytes"} \
        <= set(row.extra)
    assert row.extra["timing"] == "host"
    assert row.extra["bytes"] == 3 * 64 * 64 * 4
    assert stats.min_s > 0


def test_gemm_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from tosem_tpu_torch.ops.gemm import GemmSpec, gemm_bench
    with pytest.raises(RuntimeError, match="cuda"):
        gemm_bench(GemmSpec(64, 64, 64))


class TestGemm:
    """``tests/test_ops.py::TestGemm`` on the port (no wall-clock
    asserts)."""

    def test_numerics_vs_numpy(self):
        from tosem_tpu_torch.ops.gemm import gemm
        rng = np.random.default_rng(0)
        a = rng.standard_normal((64, 32), dtype=np.float32)
        b = rng.standard_normal((32, 48), dtype=np.float32)
        out = gemm(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)

    def test_bench_emits_row(self):
        from tosem_tpu_torch.ops.gemm import GemmSpec, gemm_bench
        spec = GemmSpec(128, 128, 128)
        stats, row = gemm_bench(spec, n_iter=64, reps=1, device="cpu")
        assert row.metric == "gflops" and row.value > 0
        assert row.bench_id == spec.bench_id
        assert stats.mean_s > 0

    def test_flops(self):
        from tosem_tpu_torch.ops.gemm import GemmSpec
        assert GemmSpec(1024, 1024, 1024).flops == 2 * 1024 ** 3

    def test_int8_accumulates_int32_bit_exact(self):
        from tosem_tpu_torch.ops.gemm import GemmSpec, gemm, gemm_operands
        a, b = gemm_operands(GemmSpec(64, 64, 64, "int8", "default"),
                             device="cpu")
        out = gemm(a, b)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(
            out.numpy(), a.numpy().astype(np.int32) @ b.numpy().astype(
                np.int32))

    def test_int8_operands_span_the_range(self):
        from tosem_tpu_torch.ops.gemm import GemmSpec, gemm_operands
        a, _ = gemm_operands(GemmSpec(128, 128, 128, "int8", "default"),
                             device="cpu")
        vals = a.numpy()
        assert vals.min() < -100 and vals.max() > 100


class TestTiming:
    def test_time_fn_stats(self):
        from tosem_tpu_torch.utils.timing import BenchStats, time_fn
        x = torch.ones(64, 64)
        stats = time_fn(lambda: x @ x, iters=4, warmup=1, inner=4,
                        name="mm")
        assert isinstance(stats, BenchStats) and stats.name == "mm"
        assert stats.iters == 4
        assert 0 < stats.min_s <= stats.p50_s
        assert stats.min_s <= stats.mean_s
        assert stats.mean_ms == pytest.approx(stats.mean_s * 1e3)
        assert stats.throughput(2.0) == pytest.approx(2.0 / stats.min_s)

    def test_benchstats_matches_reference(self):
        from tosem_tpu.utils.timing import BenchStats as Ref
        from tosem_tpu_torch.utils.timing import BenchStats
        kw = dict(name="x", iters=3, mean_s=2e-3, std_s=1e-4, min_s=1e-3,
                  p50_s=2e-3)
        assert BenchStats(**kw).mean_ms == Ref(**kw).mean_ms
        assert BenchStats(**kw).throughput(10.0) == Ref(**kw).throughput(10.0)
        zero = dict(kw, min_s=0.0)
        assert BenchStats(**zero).throughput(1.0) == float("inf")

    def test_chain_overhead_is_a_small_positive_floor(self):
        from tosem_tpu_torch.utils.timing import chain_overhead
        a = torch.ones(256, 256)
        ovh = chain_overhead((a, a), 0, reps=1)
        assert 0.0 <= ovh < 0.01

    def test_flop_models_equal_the_reference(self):
        from tosem_tpu.utils import timing as ref
        from tosem_tpu_torch.utils import timing as port
        assert port.conv2d_flops(2, 7, 9, 16, 3, 3, 8) == \
            ref.conv2d_flops(2, 7, 9, 16, 3, 3, 8)
        assert port.matmul_flops(3, 5, 7) == ref.matmul_flops(3, 5, 7)
        assert port.gflops(2e9, 0.5) == ref.gflops(2e9, 0.5)
