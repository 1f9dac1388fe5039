"""Experiment runner of the port: ``python -m tosem_tpu_torch.cli``.

Counterpart of ``tosem_tpu/cli.py`` (``python -m tosem_tpu.cli``): each
config writes its measurements as rows of the study's CSV schema
(:mod:`tosem_tpu_torch.utils.results`), so both packages' files join on
``bench_id``. Ported so far: ``bert_kernels``, north-star config 5::

    python -m tosem_tpu_torch.cli --config=bert_kernels \\
        --results_csv=results/torch_kernels.csv

runs ``bert_kernel_suite`` at BERT-base (8 x 512, 12 heads of 64, hidden
768, bf16) on the card; ``--device=cpu`` runs the plain versions at the
JAX package's CPU shapes (batch 1, seq 128, heads 2, head_dim 32, hidden
64). ``--device=cuda`` (the default) with no card exits 1. Every other
config of the JAX package exits 2 and names the ``ROADMAP.md`` item that
ports it.

``--config=allreduce`` runs north-star config 3, the collective sweep
(``parallel/collectives.py``), over a mesh of positions; each row says
how many positions and cards it ran on, and on one card the "bus" is the
card's memory.

``--config=serve_bench`` runs the serving data-plane microbench
(``serve/bench_serve.py``): micro-batched against unbatched replicas of a
synthetic backend and of tiny BERT encode, and a deployment's first
request warm against cold.

``--config=decode_bench`` runs the decode microbench
(``serve/bench_decode.py``): continuous batching over the paged cache
against the re-encode baseline at 1 and 16 sequences, then the window,
speculative, beam and prefix/session scenario legs;
``--config=decode_scenarios`` the scenario legs only. The model is the
JAX package's tiny decoder (``--preset=base`` for BERT-base), its
replicas on ``--device``. ``--config=autotune_decode_pages`` times B4 at
each candidate page size (``ops/flash_blocks.py``) and writes the
winners to the port's autotune cache, ``results/flash_blocks_torch.json``,
where ``BertDecodeBackend`` reads its page.

``--config=cluster_bench`` runs the cluster serving microbench
(``serve/bench_cluster.py``: router tier vs in-process, a node kill under
load, sharded parity, hedging, disaggregated vs colocated decode, drain
with migration) and ``--config=control_bench`` its control-plane
scenario (the diurnal ramp under the closed autoscaling loop);
``--config=train_bench`` the distributed-training microbench
(``train/bench_train.py``). Their ratio rows carry the JAX package's
speed floors beside them; no run raises on a speed floor.

``--config=flash_sparse`` runs ``sparse_kernel_suite``: flash forward and
forward+backward under the block-sparse mask programs causal,
``local:1024`` and ``doc:2048+causal`` at [1, 12, 8192, 64] bf16 on the
card (the JAX package's on-chip defaults), or at seq 512, 2 heads of 32,
fp32, window 128 with ``--device=cpu``. It has no block sweep: the
kernels' tiles are fixed (block selection is ``ROADMAP.md`` A4).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, List

# the JAX package's configs and subcommands that the port does not run
# yet -> the ROADMAP.md item that ports each
NOT_PORTED = {
    "gemm": "A12 (ops/gemm.py)",
    "timing_check": "A12 (utils/timing.py harness checks)",
    "conv_sweep": "A12 (ops/conv.py)",
    "resnet_train": "A12 (models/resnet.py)",
    "bert_train": "A12 (the CLI's bert_train leg)",
    "flash_autotune": "A4 (the flash half of block selection)",
    "detection_train": "A13 (models/efficientdet.py)",
    "detection_infer": "A13 (models/efficientdet.py)",
    "pointpillars_infer": "A13 (models/pointpillars.py)",
    "speech_train": "A13 (models/speech.py)",
    "kernel_matrix": "A12 (ops/bench_kernels.py)",
    "analysis": "A12 (the CLI)",
    "chaos": "A12 (the CLI's chaos subcommand)",
    "microbench": "A12 (the CLI subcommand; its suites run as python -m "
                  "tosem_tpu_torch.runtime.bench_runtime)",
}


def run_bert_kernels(args, device) -> List[Any]:
    from tosem_tpu_torch.ops.kernel_suite import bert_kernel_suite
    if device.type == "cpu":
        # plain versions at tiny shapes, one call a timing: CPU rows show
        # the path runs, never a device's speed
        rows = bert_kernel_suite(batch=args.batch or 1, seq=args.seq or 128,
                                 heads=2, head_dim=32, hidden=64,
                                 n_iter=1, reps=1, device=device)
    else:
        rows = bert_kernel_suite(batch=args.batch or 8, seq=args.seq or 512,
                                 device=device)
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.1f} {r.unit}")
    return rows


def run_flash_sparse(args, device) -> List[Any]:
    from tosem_tpu_torch.ops.kernel_suite import sparse_kernel_suite
    if device.type == "cpu":
        # plain versions at the JAX package's CPU smoke shape
        rows = sparse_kernel_suite(batch=args.batch or 1, seq=args.seq or 512,
                                   heads=2, head_dim=32, dtype="float32",
                                   window=128, n_iter=1, reps=1,
                                   device=device)
    else:
        seq = args.seq or 8192
        rows = sparse_kernel_suite(batch=args.batch or max(1, 4096 // seq),
                                   seq=seq, heads=12, head_dim=64,
                                   dtype="bfloat16", window=1024,
                                   device=device)
    print("  no block sweep: the CUDA kernels' tiles are fixed at 64 x 64 "
          "(block selection and its sparse cache: ROADMAP.md A4)")
    for r in rows:
        print(f"  {r.bench_id} {r.metric}: {r.value:.2f} {r.unit} "
              f"(executed {r.extra['executed_block_fraction']:.3f}, "
              f"blocks {r.extra['blocks_src']})")
    return rows


def run_allreduce(args, device) -> List[Any]:
    """North-star config 3: the six collectives over a 1-D mesh of
    positions (8 on the CPU, as the JAX package's tests have 8 virtual
    devices; 4 a card on cuda, spread over the cards in turn), 1 KB to
    256 MB a position (``--max_bytes`` caps it; 4 MB on the CPU). On
    cuda each timing is calibrated to 20 ms windows; the CPU takes one
    call a timing."""
    import torch
    from tosem_tpu_torch.parallel.collectives import (
        DEFAULT_COLLECTIVE_SWEEP, collective_bench)
    from tosem_tpu_torch.parallel.mesh import default_mesh
    if device.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        devices = [cards[i % len(cards)] for i in range(4 * len(cards))]
    else:
        devices = [device] * 8
    mesh = default_mesh("x", devices)
    cap = args.max_bytes or (1 << 22 if device.type == "cpu" else 0)
    print(f"  {mesh.size} positions on {mesh.cards()} device(s)"
          + (": the bus is that card's memory, not a link"
             if device.type == "cuda" and mesh.cards() == 1 else ""))
    rows = []
    for spec in DEFAULT_COLLECTIVE_SWEEP:
        if cap and spec.bytes_per_device > cap:
            continue
        row = collective_bench(
            spec, mesh, n_iter=int(device.type == "cpu"),
            reps=1 if device.type == "cpu" else 3)
        rows.append(row)
        print(f"  {row.bench_id} x{row.n_devices}: "
              f"{row.value:.2f} {row.unit}")
    return rows


def run_serve_bench(args, device) -> List[Any]:
    """The serving data-plane microbench (``serve/bench_serve.py``): the
    closed-loop batched-vs-unbatched A/B on a synthetic backend and on
    tiny BERT encode (its replicas on ``device``), and the warm-vs-cold
    first request. The rows are host measurements of the serving path,
    tagged ``serve_bench``."""
    from tosem_tpu_torch.serve.bench_serve import run_serve_benchmarks
    rows = run_serve_benchmarks(trials=2, min_s=0.4, device=device.type)
    for r in rows:
        r.config = "serve_bench"
    return rows


def run_autotune_decode_pages(args, device) -> List[Any]:
    """The decode page-size sweep (``ops/flash_blocks.py``): B4 timed at
    each candidate page by graph replay on the card (the plain version
    on the host clock with ``--device=cpu``), winners to the port's
    autotune cache. On the card: the decode shape first, then the long
    contexts the decode benches run (``--seq`` takes one T instead)."""
    from tosem_tpu_torch.ops.flash_blocks import (DEFAULT_CACHE_PATH,
                                                  autotune_decode_pages)
    from tosem_tpu_torch.utils.results import ResultRow
    if device.type == "cpu":
        shapes = [(2, 2, 128, 32, "float32")]
    elif args.seq:
        shapes = [(8, 12, args.seq, 64, "bfloat16")]
    else:
        shapes = [(8, 12, 512, 64, "bfloat16"),
                  (8, 12, 2048, 64, "bfloat16"),
                  (16, 12, 1024, 64, "bfloat16")]
    rows = []
    for r in autotune_decode_pages(shapes, reps=3, device=device):
        B, H, T, D, dtype = r["shape"]
        row = ResultRow(
            project="ops", config="autotune_decode_pages",
            bench_id=f"decode_pages_b{B}_t{T}_{dtype}_p{r['page']}",
            metric="time_us", value=r["time_us"], unit="us",
            device=device.type, n_devices=1,
            extra={"shape": [B, H, T, D], "dtype": dtype,
                   "page": r["page"], "best": r["best"],
                   "backend": r["backend"], "cache": DEFAULT_CACHE_PATH})
        rows.append(row)
        star = " *" if r["best"] else ""
        print(f"  {row.bench_id}: {row.value:.1f} {row.unit}{star}")
    print(f"  page winners -> {DEFAULT_CACHE_PATH}")
    return rows


def _tagged(rows, config):
    for r in rows:
        r.config = config
    return rows


def run_decode_bench(args, device) -> List[Any]:
    """The decode microbench, every leg (``serve/bench_decode.py``)."""
    from tosem_tpu_torch.serve.bench_decode import run_decode_benchmarks
    return _tagged(run_decode_benchmarks(trials=2, min_s=0.4,
                                         preset=args.preset,
                                         device=device.type),
                   "decode_bench")


def run_decode_scenarios(args, device) -> List[Any]:
    """The decode bench's window, spec, beam and prefix legs."""
    from tosem_tpu_torch.serve.bench_decode import (SCENARIO_BENCHES,
                                                    run_decode_benchmarks)
    only = {b for ids in SCENARIO_BENCHES.values() for b in ids}
    return _tagged(run_decode_benchmarks(trials=2, min_s=0.4, only=only,
                                         preset=args.preset,
                                         device=device.type),
                   "decode_scenarios")


def run_cluster_bench(args, device) -> List[Any]:
    """The cluster serving microbench (``serve/bench_cluster.py``)."""
    from tosem_tpu_torch.serve.bench_cluster import run_cluster_benchmarks
    return _tagged(run_cluster_benchmarks(trials=2, min_s=0.4,
                                          device=device.type),
                   "cluster_bench")


def run_control_bench(args, device) -> List[Any]:
    """The control-plane scenario (``bench_cluster.run_control_benchmarks``):
    a synthetic fixed-service-time backend, so ``--device`` changes
    nothing it measures."""
    from tosem_tpu_torch.serve.bench_cluster import run_control_benchmarks
    return _tagged(run_control_benchmarks(trials=1, min_s=0.4),
                   "control_bench")


def run_train_bench(args, device) -> List[Any]:
    """The distributed-training microbench (``train/bench_train.py``)."""
    from tosem_tpu_torch.train.bench_train import run_train_benchmarks
    return _tagged(run_train_benchmarks(trials=2, min_s=0.4,
                                        device=device.type),
                   "train_bench")


RUNNERS = {"bert_kernels": run_bert_kernels,
           "flash_sparse": run_flash_sparse,
           "allreduce": run_allreduce,
           "serve_bench": run_serve_bench,
           "autotune_decode_pages": run_autotune_decode_pages,
           "decode_bench": run_decode_bench,
           "decode_scenarios": run_decode_scenarios,
           "cluster_bench": run_cluster_bench,
           "control_bench": run_control_bench,
           "train_bench": run_train_bench}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tosem_tpu_torch.cli",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--config", default="bert_kernels",
                    help="comma-separated configs; ported: "
                         + ", ".join(RUNNERS))
    ap.add_argument("--results_csv", default="results/results.csv")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch (0 = the config's default)")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence length (0 = the config's default)")
    ap.add_argument("--max_bytes", type=int, default=0,
                    help="allreduce: largest buffer a position (0 = the "
                         "device's default)")
    ap.add_argument("--preset", choices=("tiny", "base"), default="tiny",
                    help="decode_bench/decode_scenarios: the decoder the "
                         "legs serve (the JAX package's tiny one, or "
                         "BERT-base)")
    return ap


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"{argv[0]} is not ported yet: ROADMAP.md {NOT_PORTED[argv[0]]}",
              file=sys.stderr)
        return 2
    args = make_parser().parse_args(argv)
    configs = [c for c in args.config.split(",") if c]
    for c in configs:
        if c in NOT_PORTED:
            print(f"config {c} is not ported yet: ROADMAP.md "
                  f"{NOT_PORTED[c]}", file=sys.stderr)
            return 2
        if c not in RUNNERS:
            print(f"unknown config {c!r}; ported: {sorted(RUNNERS)}",
                  file=sys.stderr)
            return 2
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.common import resolve_device
    from tosem_tpu_torch.utils.results import ResultWriter
    from tosem_tpu_torch.utils.roofline import annotate_roofline
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    if device.type == "cuda":
        import torch
        print(f"device=cuda name={torch.cuda.get_device_name(device)}")
    else:
        print("device=cpu (the kernels' plain versions)")
    with ResultWriter(args.results_csv) as w:
        for c in configs:
            print(f"[{c}]")
            t0 = time.perf_counter()
            registry.reset_launch_counts()
            rows = RUNNERS[c](args, device)
            if device.type == "cuda":
                for r in rows:
                    annotate_roofline(r)
            w.add_many(rows)
            launched = {k: n for k, n in registry.LAUNCH_COUNTS.items() if n}
            print(f"[{c}] {len(rows)} rows in "
                  f"{time.perf_counter() - t0:.1f}s; kernel launches "
                  f"{json.dumps(launched, sort_keys=True)}")
    print(f"results -> {args.results_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
