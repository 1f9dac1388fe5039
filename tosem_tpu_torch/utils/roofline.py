"""Roofline annotation of result rows against the NVIDIA H100's peaks.

Counterpart of ``tosem_tpu/utils/roofline.py``'s ``annotate_roofline``,
with the card's published peaks in place of the TPU's (NVIDIA's H100 SXM
data sheet, dense, at its 700 W power limit; a card set to a lower limit
runs below them): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
outside them, 1,979 TOP/s int8, 3.35 TB/s of device memory.
"""
from __future__ import annotations

from tosem_tpu_torch.utils.results import ResultRow

PEAK_BF16_GFLOPS = 989_000.0    # H100 SXM tensor cores, bf16 dense
PEAK_FP32_GFLOPS = 67_000.0     # H100 SXM fp32, CUDA cores
PEAK_INT8_GOPS = 1_979_000.0    # H100 SXM tensor cores, int8 dense
PEAK_HBM_GBPS = 3_350.0         # H100 SXM HBM3


def peak_gflops(dtype: str) -> float:
    """The card's peak for a row of this dtype."""
    if "float32" in dtype:
        return PEAK_FP32_GFLOPS
    if "int8" in dtype:
        return PEAK_INT8_GOPS
    return PEAK_BF16_GFLOPS


def annotate_roofline(row: ResultRow) -> None:
    """Attach roofline utilization to a result row in place, as the JAX
    package does: ``bound`` in {compute, memory}, ``mfu`` against the
    dtype's peak for GFLOPS rows, ``mbu`` against device memory for GB/s
    rows and for GFLOPS rows that carry ``bytes`` and a per-call time."""
    unit = row.unit.lower()
    if unit == "gflops":
        peak = peak_gflops(str(row.extra.get("dtype", "")))
        row.extra["mfu"] = round(row.value / peak, 4)
        nbytes = row.extra.get("bytes")
        if nbytes and row.value > 0:
            sec_per_call = None
            if row.extra.get("mean_ms"):
                sec_per_call = row.extra["mean_ms"] / 1e3
            elif row.extra.get("time_us"):
                sec_per_call = row.extra["time_us"] / 1e6
            if sec_per_call:
                row.extra["mbu"] = round(
                    nbytes / sec_per_call / 1e9 / PEAK_HBM_GBPS, 4)
                total_flops = row.value * 1e9 * sec_per_call
                t_compute = total_flops / (peak * 1e9)
                t_memory = nbytes / (PEAK_HBM_GBPS * 1e9)
                row.extra["bound"] = ("memory" if t_memory > t_compute
                                      else "compute")
        else:
            row.extra["bound"] = "compute"
    elif unit == "gb/s":
        row.extra["mbu"] = round(row.value / PEAK_HBM_GBPS, 4)
        row.extra["bound"] = "memory"
