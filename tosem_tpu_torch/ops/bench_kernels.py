"""Cross-backend kernel microbench: every arm of every parity family.

Counterpart of ``tosem_tpu/ops/bench_kernels.py`` (``python -m
tosem_tpu_torch.cli microbench --kernels``, and the CLI's
``kernel_matrix``). For each family of :mod:`tosem_tpu_torch.ops.parity`
it runs the arms this platform has over one fixed scenario, interleaved
round by round, and emits one rate row per (family, backend).

Before any timing the arms are pinned through the parity harness: on
the card the ``cuda`` arm against the ``torch`` arm on CPU copies of the
same case, on the CPU the ``torch`` arm against the numpy oracle. An A/B
of arms that compute different things is not a benchmark.

The two arms are timed differently, and each row says which in
``extra["timing"]``: the ``cuda`` arm by graph replay
(:class:`~tosem_tpu_torch.utils.timing.DeviceLoopBench`: a ``ctypes``
launch costs tens of microseconds on the host, more than these kernels
take, so a host loop would time the launch rate), the ``torch`` arm by
host calls over a window of at least ``min_s`` (a host rate, as in the
JAX package). ``extra["on_chip"]`` is true for card rows only; CPU rows
are never a device's speed. ``extra["skipped_backends"]`` names the
arms this platform cannot run.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from tosem_tpu_torch.utils.results import ResultRow

# the gated subset: the arms every platform runs
GATED_KERNEL_BENCHES = (
    "kernels_flash_torch",
    "kernels_paged_torch",
    "kernels_schedule_torch",
)


def _host_rate(fn, args, budget_s: float) -> float:
    """Calls a second over a window of at least ``budget_s``: one
    untimed call, then at least two timed ones."""
    fn(*args)
    n, t0 = 0, time.perf_counter()
    while True:
        fn(*args)
        n += 1
        dt = time.perf_counter() - t0
        if dt >= budget_s and n >= 2:
            return n / dt


def _device_rate(fn, args) -> float:
    from tosem_tpu_torch.utils.timing import DeviceLoopBench
    return 1.0 / DeviceLoopBench(op=fn, args=args).time(reps=1)


def _bench_scenario(family: str):
    """The fixed scenario each family's arms race on (the JAX
    package's): small, and structured enough (mask, segments, ragged
    pages) that the arms' real dispatch paths run."""
    from tosem_tpu_torch.ops import parity
    if family == "flash":
        return parity._sc("flash", "bench_causal_segments",
                          causal=True, segments=True)
    if family == "paged":
        return parity._sc("paged", "bench_ragged", lens=(31, 7, 0, 24))
    return parity._sc("schedule", "bench_local", mask="local:48")


def run_kernel_benchmarks(trials: int = 3, min_s: float = 0.5,
                          quiet: bool = False, only: Optional[set] = None,
                          platform: Optional[str] = None
                          ) -> List[ResultRow]:
    import torch

    from tosem_tpu_torch.ops import parity, registry
    from tosem_tpu_torch.serve.bench_common import SuiteEmitter

    platform = parity._platform(platform)
    em = SuiteEmitter("kernels", only)
    for family in parity.FAMILIES:
        sc = _bench_scenario(family)
        names = parity.available_backends(family, platform)
        skipped = sorted({registry.BACKEND_CUDA, registry.BACKEND_TORCH}
                         - set(names))
        if skipped and not quiet:
            print(f"  kernels[{family}]: {skipped} not runnable on "
                  f"platform={platform}")
        pairs = parity.available_pairs(family, platform)
        for a, b in pairs:
            parity.check_pair(family, a, b, sc)
        if not pairs:
            parity.check_oracle(family, registry.BACKEND_TORCH, sc)
        arms: Dict[str, tuple] = {}
        for name in names:
            args, kwargs = parity.build_case(sc, device=parity._device_of(
                name))
            arms[name] = (lambda *xs, _n=name, _kw=kwargs:
                          parity.run_arm(family, _n, xs, _kw), args)
        per_round: Dict[str, List[float]] = {n: [] for n in names}
        with torch.no_grad():
            for _ in range(max(trials, 1)):
                # interleaved: every arm sees this round's host phase
                for name in names:
                    fn, args = arms[name]
                    per_round[name].append(
                        _device_rate(fn, args)
                        if name == registry.BACKEND_CUDA
                        else _host_rate(fn, args, min_s))
        for name in names:
            r = em.emit(f"kernels_{family}_{name}",
                        f"{family} kernel, {name} backend "
                        f"({sc.name}, {sc.dtype})",
                        per_round[name], unit="it/s")
            if r:
                card = name == registry.BACKEND_CUDA
                r.device = "gpu" if card else "cpu"
                r.extra.update(
                    platform="cuda" if card else "cpu", backend=name,
                    family=family, scenario=sc.name, dtype=sc.dtype,
                    timing="graph_replay" if card else "host",
                    skipped_backends=skipped, on_chip=card)
    return em.flush(quiet)


def main(argv=None) -> int:
    """``python -m tosem_tpu_torch.ops.bench_kernels``; the CLI route is
    ``python -m tosem_tpu_torch.cli microbench --kernels``."""
    from tosem_tpu_torch.runtime.bench_runtime import main as micro_main
    return micro_main(["--kernels"] + (argv or []))


if __name__ == "__main__":
    raise SystemExit(main())
