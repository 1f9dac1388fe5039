"""Conv2D on cuDNN: north-star config 2, the ResNet-50 layer sweep.

Counterpart of ``tosem_tpu/ops/conv.py`` (``ConvSpec``, ``conv2d``, the
space-to-depth pair, ``conv_bench``, ``RESNET50_CONV_SWEEP`` and its bf16
twin). The JAX package runs each shape as one ``lax.conv_general_dilated``
(an XLA op, not a Pallas kernel); here it is ``F.conv2d``, cuDNN on the
card.

The JAX package is NHWC x HWIO. ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is a ``channels_last`` NCHW tensor with no copy, and HWIO
weights are OIHW after ``permute(3, 2, 0, 1)``, so :func:`conv2d` keeps
the JAX package's signature and layouts. XLA's SAME padding is
asymmetric where the total is odd: low = floor(total / 2), high = the
rest, with ``total = max((ceil(in / s) - 1) * s + k - in, 0)``.
``F.conv2d(padding=k // 2)`` pads both sides alike and gives other
numbers at stride 2 on even sizes, so :func:`same_pads` takes XLA's
formula and an asymmetric pad goes through ``F.pad`` first.

fp32 shapes run under ``precision("float32")`` (cuDNN defaults to TF32).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from tosem_tpu_torch.ops.common import precision as _precision
from tosem_tpu_torch.ops.common import resolve_device
from tosem_tpu_torch.ops.gemm import timing_kind, torch_dtype
from tosem_tpu_torch.utils.results import ResultRow
from tosem_tpu_torch.utils.timing import (BenchStats, DeviceLoopBench,
                                          conv2d_flops, gflops)


@dataclass(frozen=True)
class ConvSpec:
    name: str
    batch: int
    h: int
    w: int
    c_in: int
    c_out: int
    kh: int
    kw: int
    stride: int = 1
    dtype: str = "float32"
    precision: str = "float32"

    @property
    def bench_id(self) -> str:
        return (f"conv_{self.name}_b{self.batch}_{self.h}x{self.w}x{self.c_in}"
                f"_k{self.kh}x{self.kw}s{self.stride}_{self.c_out}_{self.dtype}")

    @property
    def out_hw(self) -> Tuple[int, int]:
        # SAME padding
        return (-(-self.h // self.stride), -(-self.w // self.stride))

    @property
    def flops(self) -> float:
        ho, wo = self.out_hw
        return conv2d_flops(self.batch, ho, wo, self.c_out, self.kh, self.kw,
                            self.c_in)

    @property
    def bytes_touched(self) -> int:
        """Input, weights and output, once each."""
        ho, wo = self.out_hw
        item = torch_dtype(self.dtype).itemsize
        return item * (self.batch * self.h * self.w * self.c_in
                       + self.kh * self.kw * self.c_in * self.c_out
                       + self.batch * ho * wo * self.c_out)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) of XLA's SAME padding along one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
             value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x`` (N, C, H, W) padded for a SAME window: returns the tensor
    and the symmetric padding left for the op (an asymmetric pad is
    applied here, with ``value``, and the op gets 0)."""
    ph, pw = same_pads(x.shape[2], kh, stride), same_pads(x.shape[3], kw,
                                                          stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                padding: str = "SAME", groups: int = 1,
                precision: str = "float32") -> torch.Tensor:
    """(N, C, H, W) x OIHW with SAME (XLA's) or VALID padding."""
    if padding == "SAME":
        x, pad = pad_same(x, w.shape[2], w.shape[3], stride)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
    with _precision(precision):
        return F.conv2d(x, w, stride=stride, padding=pad, groups=groups)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           precision: str = "float32") -> torch.Tensor:
    """NHWC x HWIO -> NHWC convolution with SAME padding."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride,
                    precision=precision)
    return y.permute(0, 2, 3, 1)


def space_to_depth_inputs(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> block-2 space-to-depth: [B, H/2, W/2, 4C], channel order
    (du, dv, c). The JAX package's input trick for the 3-channel stem."""
    B, H, W, C = x.shape
    return (x.reshape(B, H // 2, 2, W // 2, 2, C)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(B, H // 2, W // 2, 4 * C))


def space_to_depth_conv1_weights(w: torch.Tensor) -> torch.Tensor:
    """[7, 7, C, O] stride-2 stem kernel -> [4, 4, 4C, O] stride-1 kernel
    over the space-to-depth input: padded to 8 x 8, each 2 x 2 tap block
    folded into channels in the inputs' (du, dv, c) order. The stride-1
    4 x 4 SAME conv on the folded input equals the 7 x 7 stride-2 SAME
    conv."""
    kh, kw, C, O = w.shape
    if kh != 7 or kw != 7:
        raise ValueError("conv1 transform expects a 7x7 stem kernel")
    w8 = torch.zeros((8, 8, C, O), dtype=w.dtype, device=w.device)
    w8[:7, :7] = w
    return (w8.reshape(4, 2, 4, 2, C, O)
            .permute(0, 2, 1, 3, 4, 5)
            .reshape(4, 4, 4 * C, O))


def hwio_over_channels_last(w: torch.Tensor) -> torch.Tensor:
    """The same HWIO values, stored so that ``permute(3, 2, 0, 1)`` is a
    ``channels_last`` OIHW tensor: the layout cuDNN takes without a copy
    (chosen once, at weight-load time)."""
    oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return oihw.permute(2, 3, 1, 0)


def conv_bench(spec: ConvSpec, *, n_iter: int = 0, reps: int = 3,
               seed: int = 0, device="cuda") -> Tuple[BenchStats, ResultRow]:
    """Time one conv shape. A spec named ``*_s2d`` runs the
    space-to-depth form of the stem (its input and weight transforms
    outside the timed call, as in the JAX package); its GFLOPS stay
    against the 7 x 7 stride-2 flop count."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = torch_dtype(spec.dtype)
    x = torch.randn(spec.batch, spec.h, spec.w, spec.c_in,
                    generator=gen).to(dt)
    w = torch.randn(spec.kh, spec.kw, spec.c_in, spec.c_out,
                    generator=gen).to(dt)
    stride, prec = spec.stride, spec.precision
    s2d = spec.name.endswith("_s2d")
    if s2d:
        x = space_to_depth_inputs(x)
        w = space_to_depth_conv1_weights(w)
        stride = 1
    x = x.contiguous().to(dev)
    w = hwio_over_channels_last(w.to(dev))
    bench = DeviceLoopBench(op=lambda xx, ww: conv2d(xx, ww, stride, prec),
                            args=(x, w), perturb=1)
    sec = bench.time(n_iter=n_iter, reps=reps)
    stats = BenchStats(name=spec.bench_id, iters=reps, mean_s=sec, std_s=0.0,
                       min_s=sec, p50_s=sec)
    row = ResultRow(
        project="ops", config="conv_sweep", bench_id=spec.bench_id,
        metric="gflops", value=gflops(spec.flops, sec), unit="GFLOPS",
        device="gpu" if dev.type == "cuda" else "cpu", n_devices=1,
        extra={"batch": spec.batch, "hw": [spec.h, spec.w],
               "c_in": spec.c_in, "c_out": spec.c_out,
               "k": [spec.kh, spec.kw], "stride": spec.stride,
               "dtype": spec.dtype, "mean_ms": stats.mean_ms,
               "bytes": spec.bytes_touched, "timing": timing_kind(dev),
               **({"s2d": True} if s2d else {})})
    return stats, row


def _resnet50_specs(batch: int, dtype: str, precision: str) -> List[ConvSpec]:
    """The distinct conv layer shapes of ResNet-50 at 224x224 input."""
    raw = [
        # name,            h,   w, cin, cout, kh, kw, stride
        ("conv1",         224, 224,   3,   64, 7, 7, 2),
        # the same stem by space-to-depth (4x4 s1 over [112, 112, 12]);
        # GFLOPS against the 7x7 flop count: the effective rate
        ("conv1_s2d",     224, 224,   3,   64, 7, 7, 2),
        ("conv2_1x1a",     56,  56,  64,   64, 1, 1, 1),
        ("conv2_3x3",      56,  56,  64,   64, 3, 3, 1),
        ("conv2_1x1b",     56,  56,  64,  256, 1, 1, 1),
        ("conv3_down",     56,  56, 256,  128, 1, 1, 2),
        ("conv3_3x3",      28,  28, 128,  128, 3, 3, 1),
        ("conv3_1x1b",     28,  28, 128,  512, 1, 1, 1),
        ("conv4_down",     28,  28, 512,  256, 1, 1, 2),
        ("conv4_3x3",      14,  14, 256,  256, 3, 3, 1),
        ("conv4_1x1b",     14,  14, 256, 1024, 1, 1, 1),
        ("conv5_down",     14,  14, 1024, 512, 1, 1, 2),
        ("conv5_3x3",       7,   7, 512,  512, 3, 3, 1),
        ("conv5_1x1b",      7,   7, 512, 2048, 1, 1, 1),
    ]
    return [ConvSpec(n, batch, h, w, ci, co, kh, kw, s, dtype, precision)
            for (n, h, w, ci, co, kh, kw, s) in raw]


RESNET50_CONV_SWEEP = _resnet50_specs(batch=32, dtype="float32",
                                      precision="float32")
RESNET50_CONV_SWEEP_BF16 = _resnet50_specs(batch=32, dtype="bfloat16",
                                           precision="default")
