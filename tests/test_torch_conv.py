"""The port's convolution (``tosem_tpu_torch/ops/conv.py``, cuDNN on the
card) held against the JAX package's ``lax.conv_general_dilated`` on the
CPU: NHWC x HWIO with XLA's SAME padding at strides 1 and 2, kernels 1,
3 and 7, odd and even sizes, fp32 within 1e-4 (bf16 within 2e-2 of the
largest output). Symmetric padding (``F.conv2d(padding=k // 2)``) is
the yardstick that must break the stride-2 check. The space-to-depth
stem equals the 7x7 stride-2 conv, and the sweep tables, ids and byte
and FLOP models equal the reference's. ``tests/test_ops.py::TestConv``
and ``TestSpaceToDepthStem`` are copied without wall-clock asserts."""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

FP32_TOL = 1e-4


def _ref():
    return importlib.import_module("tosem_tpu.ops.conv")


def _port():
    return importlib.import_module("tosem_tpu_torch.ops.conv")


def _operands(n, h, c_in, c_out, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, c_in), dtype=np.float32)
    w = rng.standard_normal((k, k, c_in, c_out), dtype=np.float32)
    return x, w


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("h", [7, 8])
def test_conv2d_matches_reference(h, k, stride):
    x, w = _operands(2, h, 4, 5, k)
    want = np.asarray(_ref().conv2d(x, w, stride=stride,
                                    precision="float32"))
    got = _port().conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("h,k", [(8, 3), (32, 3), (16, 7)])
def test_symmetric_padding_breaks_the_stride_2_check(h, k):
    """XLA's SAME at stride 2 on an even size pads low = total // 2 and
    high = the rest; ``padding=k // 2`` on both sides is another conv."""
    x, w = _operands(2, h, 4, 5, k, seed=1)
    want = np.asarray(_ref().conv2d(x, w, stride=2, precision="float32"))
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=k // 2).permute(0, 2, 3, 1)
    assert sym.shape == want.shape
    assert np.abs(sym.numpy() - want).max() > 100 * FP32_TOL
    assert _port().same_pads(h, k, 2) != (k // 2, k // 2)


def test_bf16_conv_within_bf16_of_reference():
    import jax.numpy as jnp
    x, w = _operands(2, 8, 8, 8, 3, seed=2)
    want = np.asarray(_ref().conv2d(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16), stride=2,
                                    precision="default").astype(jnp.float32))
    got = _port().conv2d(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w).bfloat16(), 2,
                         "default").float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_conv2d_output_is_nhwc_of_a_channels_last_conv():
    x, w = _operands(2, 8, 4, 6, 3)
    y = _port().conv2d(torch.from_numpy(x), torch.from_numpy(w), 1)
    assert y.shape == (2, 8, 8, 6)
    assert x.shape[-1] == 4 and torch.from_numpy(x).permute(
        0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)


def test_space_to_depth_transforms_equal_the_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 3), dtype=np.float32)
    w = rng.standard_normal((7, 7, 3, 5), dtype=np.float32)
    np.testing.assert_array_equal(
        _port().space_to_depth_inputs(torch.from_numpy(x)).numpy(),
        np.asarray(_ref().space_to_depth_inputs(x)))
    np.testing.assert_array_equal(
        _port().space_to_depth_conv1_weights(torch.from_numpy(w)).numpy(),
        np.asarray(_ref().space_to_depth_conv1_weights(w)))


def test_sweeps_ids_and_models_equal_the_reference():
    ref, port = _ref(), _port()
    for ps, rs in ((port.RESNET50_CONV_SWEEP, ref.RESNET50_CONV_SWEEP),
                   (port.RESNET50_CONV_SWEEP_BF16,
                    ref.RESNET50_CONV_SWEEP_BF16)):
        assert len(ps) == len(rs) == 14
        for p, r in zip(ps, rs):
            assert p.bench_id == r.bench_id
            assert p.out_hw == r.out_hw and p.flops == r.flops
            assert p.bytes_touched == r.bytes_touched
            assert p.precision == r.precision


def test_weights_over_channels_last_are_the_same_values():
    port = _port()
    w = torch.randn(3, 3, 4, 8)
    w2 = port.hwio_over_channels_last(w)
    assert torch.equal(w, w2)
    assert w2.permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)


class TestConv:
    """``tests/test_ops.py::TestConv`` on the port."""

    def test_numerics_vs_reference(self):
        port = _port()
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4),
                                                 dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((3, 3, 4, 8),
                                                 dtype=np.float32))
        assert port.conv2d(x, w, stride=1).shape == (2, 8, 8, 8)
        w1 = torch.from_numpy(rng.standard_normal((1, 1, 4, 8),
                                                  dtype=np.float32))
        expect = np.einsum("nhwc,co->nhwo", x.numpy(), w1.numpy()[0, 0])
        np.testing.assert_allclose(port.conv2d(x, w1).numpy(), expect,
                                   rtol=1e-4, atol=1e-4)

    def test_stride_output_shape(self):
        port = _port()
        spec = port.ConvSpec("t", 1, 16, 16, 4, 8, 3, 3, stride=2)
        assert spec.out_hw == (8, 8)
        assert port.conv2d(torch.ones(1, 16, 16, 4), torch.ones(3, 3, 4, 8),
                           stride=2).shape == (1, 8, 8, 8)

    def test_sweep_table(self):
        sweep = _port().RESNET50_CONV_SWEEP
        assert len(sweep) == 14
        ids = [s.bench_id for s in sweep]
        assert len(set(ids)) == len(ids)
        assert any("conv1_s2d" in i for i in ids)

    def test_bench_emits_row(self):
        port = _port()
        spec = port.ConvSpec("tiny", 1, 8, 8, 4, 8, 3, 3)
        stats, row = port.conv_bench(spec, n_iter=64, reps=1, device="cpu")
        assert row.config == "conv_sweep" and row.value > 0
        assert row.bench_id == _ref().ConvSpec(
            "tiny", 1, 8, 8, 4, 8, 3, 3).bench_id
        assert row.extra["timing"] == "host"
        assert row.extra["bytes"] == spec.bytes_touched


class TestSpaceToDepthStem:
    def test_conv1_s2d_exact_parity(self):
        port = _port()
        g = torch.Generator().manual_seed(3)
        x = torch.randn(2, 16, 16, 3, generator=g)
        w = torch.randn(7, 7, 3, 8, generator=g)
        ref = port.conv2d(x, w, stride=2, precision="float32")
        got = port.conv2d(port.space_to_depth_inputs(x),
                          port.space_to_depth_conv1_weights(w), stride=1,
                          precision="float32")
        assert got.shape == ref.shape == (2, 8, 8, 8)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)

    def test_rejects_non_stem_kernel(self):
        with pytest.raises(ValueError):
            _port().space_to_depth_conv1_weights(torch.zeros(3, 3, 3, 8))
