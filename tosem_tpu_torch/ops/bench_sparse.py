"""Block-sparse attention microbench: LocalMask against dense-causal.

Counterpart of ``tosem_tpu/ops/bench_sparse.py`` (``python -m
tosem_tpu_torch.cli microbench --sparse``). At t8192 a sliding-window
schedule (``LocalMask(1024)``) executes about a third of causal's block
pairs; each row carries both schedules' ``executed_block_fraction``, and
the arms' rates are calls a second, not a flop model.

Each round runs both arms back to back (both see the same host phase),
and the speedup is computed in-round. On the card the arms are B1 in
schedule mode (bf16, the kernels' 64 x 64 tiles), timed by graph replay
(:class:`~tosem_tpu_torch.utils.timing.DeviceLoopBench`); on the CPU
they are ``schedule_attention_torch``, the plain lowering of the same
schedules (fp32), timed by host calls. That lowering pads every row to
the schedule's longest stream, so its executed fraction is ``L /
n_minor``: 1.0 for causal, the band's share for local. Rows say which
timing they carry in ``extra["timing"]``.
"""
from __future__ import annotations

from typing import List, Optional

from tosem_tpu_torch.utils.results import ResultRow

# the gated subset: the phase-immune in-round ratio
GATED_SPARSE_BENCHES = ("sparse_local_speedup_t8192",)


def run_sparse_benchmarks(trials: int = 3, min_s: float = 0.5,
                          quiet: bool = False, only: Optional[set] = None,
                          *, seq: int = 8192, window: int = 1024,
                          batch: int = 1, heads: int = 1,
                          head_dim: int = 64,
                          device="cuda") -> List[ResultRow]:
    import torch

    from tosem_tpu_torch.ops.bench_kernels import _device_rate, _host_rate
    from tosem_tpu_torch.ops.common import resolve_device
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    from tosem_tpu_torch.ops.flash_blocks import select_block_sizes
    from tosem_tpu_torch.ops.mask_programs import (CausalMask, LocalMask,
                                                   compile_mask_programs,
                                                   program_stats,
                                                   schedule_attention_torch)
    from tosem_tpu_torch.serve.bench_common import SuiteEmitter

    dev = resolve_device(device)
    card = dev.type == "cuda"
    impl = "cuda" if card else "torch"
    dtype = "bfloat16" if card else "float32"
    B, H, T, D = batch, heads, seq, head_dim
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D, generator=gen).to(
        getattr(torch, dtype)).to(dev) for _ in range(3))

    arms, fracs = {}, {}
    for name, mask in (("causal", CausalMask()),
                       ("local", LocalMask(window))):
        blocks = select_block_sizes(T, D, dtype, mask_sig=mask.signature())
        stats = program_stats(mask, T, T, blocks, heads=H)["fwd"]
        if card:
            fracs[name] = stats.fraction
            arms[name] = lambda a, b, c, m=mask: flash_attention(a, b, c,
                                                                 mask=m)
        else:
            progs = compile_mask_programs(mask, T, T, blocks, heads=H)
            fracs[name] = stats.stream_len / float(T // blocks.bk)
            arms[name] = (lambda a, b, c, s=progs.fwd:
                          schedule_attention_torch(a, b, c, s))

    def rate(fn):
        return _device_rate(fn, (q, k, v)) if card \
            else _host_rate(fn, (q, k, v), min_s)

    em = SuiteEmitter("sparse", only)
    per_round: dict = {"causal": [], "local": [], "speedup": []}
    with torch.no_grad():
        for _ in range(max(trials, 1)):
            rc = rate(arms["causal"])
            rl = rate(arms["local"])
            per_round["causal"].append(rc)
            per_round["local"].append(rl)
            per_round["speedup"].append(rl / rc)

    extra = {"impl": impl, "dtype": dtype, "window": window,
             "shape": [B, H, T, D],
             "timing": "graph_replay" if card else "host",
             "on_chip": card,
             "executed_block_fraction_causal": fracs["causal"],
             "executed_block_fraction_local": fracs["local"]}
    rows = [
        (em.emit(f"sparse_causal_t{T}", f"dense-causal t{T} fwd ({impl})",
                 per_round["causal"], unit="it/s"),
         {"executed_block_fraction": fracs["causal"]}),
        (em.emit(f"sparse_local_t{T}",
                 f"LocalMask({window}) t{T} fwd ({impl})",
                 per_round["local"], unit="it/s"),
         {"executed_block_fraction": fracs["local"]}),
        (em.emit(f"sparse_local_speedup_t{T}",
                 f"t{T} local-vs-causal speedup (in-round)",
                 per_round["speedup"], unit="x"), {})]
    for r, more in rows:
        if r:
            r.device = "gpu" if card else "cpu"
            r.extra.update(extra, **more)
    return em.flush(quiet)


def main(argv=None) -> int:
    """``python -m tosem_tpu_torch.ops.bench_sparse``; the CLI route is
    ``python -m tosem_tpu_torch.cli microbench --sparse``."""
    from tosem_tpu_torch.runtime.bench_runtime import main as micro_main
    return micro_main(["--sparse"] + (argv or []))


if __name__ == "__main__":
    raise SystemExit(main())
