"""GEMM on cuBLAS: north-star config 1.

Counterpart of ``tosem_tpu/ops/gemm.py`` (``GemmSpec``, ``gemm``,
``gemm_operands``, ``gemm_bench``, ``DEFAULT_GEMM_SWEEP``). The JAX
package computes the product with ``jnp.dot`` outside any Pallas kernel,
so its counterpart is a library product: ``torch.matmul`` (cuBLAS on
the card). ``"float32"`` runs under ``ops.common.precision("float32")``,
with TF32 off, so an fp32 row is honest fp32; int8 operands go through
``torch._int_mm`` with int32 accumulation (on the card it takes m > 16
and k, n multiples of 8).

Rows are timed by :class:`~tosem_tpu_torch.utils.timing.DeviceLoopBench`
(graph replay of many calls on the card; host calls on the CPU), and say
which in ``extra["timing"]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from tosem_tpu_torch.ops.common import precision as _precision
from tosem_tpu_torch.ops.common import resolve_device
from tosem_tpu_torch.utils.results import ResultRow
from tosem_tpu_torch.utils.timing import (BenchStats, DeviceLoopBench,
                                          chain_overhead, gflops,
                                          matmul_flops)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def timing_kind(device: torch.device) -> str:
    """What a row's time is: device time by graph replay on the card,
    host time of eager calls on the CPU."""
    return "graph_replay" if device.type == "cuda" else "host"


@dataclass(frozen=True)
class GemmSpec:
    m: int
    n: int
    k: int
    dtype: str = "float32"        # operand dtype
    precision: str = "float32"    # accumulation discipline

    @property
    def bench_id(self) -> str:
        return f"gemm_{self.m}x{self.n}x{self.k}_{self.dtype}_{self.precision}"

    @property
    def flops(self) -> float:
        return matmul_flops(self.m, self.n, self.k)

    @property
    def bytes_touched(self) -> int:
        """a and b read once, c written once (int32 for int8)."""
        item = torch_dtype(self.dtype).itemsize
        out = 4 if self.dtype == "int8" else item
        return (self.m * self.k + self.k * self.n) * item \
            + self.m * self.n * out


def gemm(a: torch.Tensor, b: torch.Tensor,
         precision: str = "float32") -> torch.Tensor:
    """``a @ b``; integer operands accumulate in int32."""
    if not a.dtype.is_floating_point:
        return torch._int_mm(a, b)
    with _precision(precision):
        return torch.matmul(a, b)


def gemm_operands(spec: GemmSpec, seed: int = 0, device="cuda"):
    """Operands for a spec, drawn on the CPU from ``seed`` (so every
    device gets the same values) and moved to ``device``: normals cast
    to the dtype, or integers in [-127, 127] for int8. Shared by every
    harness, so cross-checking timers time the same operands."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if spec.dtype == "int8":
        a = torch.randint(-127, 128, (spec.m, spec.k), generator=gen,
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-127, 128, (spec.k, spec.n), generator=gen,
                          dtype=torch.int32).to(torch.int8)
        # b stored column-major: cuBLASLt's int8 tensor-core GEMM takes
        # that layout (8192^3 on an H100 80GB HBM3 at 700 W: 899 TOP/s
        # so, 133 with b row-major; the values are the same)
        b = b.t().contiguous().t()
    else:
        dt = torch_dtype(spec.dtype)
        a = torch.randn(spec.m, spec.k, generator=gen).to(dt)
        b = torch.randn(spec.k, spec.n, generator=gen).to(dt)
    return a.to(dev), b.to(dev)


def gemm_bench(spec: GemmSpec, *, n_iter: int = 0, reps: int = 3,
               seed: int = 0, device="cuda"
               ) -> Tuple[BenchStats, ResultRow]:
    """Time one GEMM shape: stats and a row of the results CSV."""
    dev = resolve_device(device)
    a, b = gemm_operands(spec, seed, dev)
    prec = spec.precision
    bench = DeviceLoopBench(op=lambda x, y: gemm(x, y, prec), args=(a, b))
    sec = bench.time(n_iter=n_iter, reps=reps)
    stats = BenchStats(name=spec.bench_id, iters=reps, mean_s=sec, std_s=0.0,
                       min_s=sec, p50_s=sec)
    extra = {"m": spec.m, "n": spec.n, "k": spec.k, "dtype": spec.dtype,
             "precision": spec.precision, "mean_ms": stats.mean_ms,
             "bytes": spec.bytes_touched, "timing": timing_kind(dev)}
    if spec.m * spec.n * spec.k <= 2048 ** 3:
        # small shapes: the timing's per-call floor is no longer
        # negligible next to the product (utils.timing.chain_overhead)
        ovh = chain_overhead((a, b), 0, reps=reps)
        if 0.0 < ovh < sec:
            extra["chain_overhead_us"] = round(ovh * 1e6, 3)
            extra["gflops_nooverhead"] = round(
                gflops(spec.flops, sec - ovh), 1)
    row = ResultRow(project="ops", config="gemm", bench_id=spec.bench_id,
                    metric="gflops", value=gflops(spec.flops, sec),
                    unit="GFLOPS",
                    device="gpu" if dev.type == "cuda" else "cpu",
                    n_devices=1, extra=extra)
    return stats, row


# the north-star shape and the JAX package's sweep (bf16 pairs, int8)
DEFAULT_GEMM_SWEEP = [
    GemmSpec(1024, 1024, 1024, "float32", "float32"),
    GemmSpec(1024, 1024, 1024, "bfloat16", "default"),
    GemmSpec(2048, 2048, 2048, "float32", "float32"),
    GemmSpec(4096, 4096, 4096, "bfloat16", "default"),
    GemmSpec(8192, 8192, 8192, "bfloat16", "default"),
    GemmSpec(4096, 4096, 4096, "int8", "default"),
    GemmSpec(8192, 8192, 8192, "int8", "default"),
]
